"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

Every ``*.cu`` under ``repro_torch/csrc/`` is compiled for ``sm_90a`` by
its own ``nvcc`` process (all started together), then linked into one
shared library under ``build/`` at the repository root.  The library name
carries a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads at once.  Nothing here runs at import time: the
first kernel launch calls :func:`load`.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero
code.  Launch counts are plain integers in :data:`LAUNCHES`, one per
kernel wrapper, incremented where the wrapper launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("proxy_score", "gather_norm", "sparse_attention",
           "scatter_update_multi", "gather_pages", "scatter_pages",
           "scatter_rows_paged", "proxy_score_paged", "cosine_drift",
           "cosine_drift_paged", "proxy_score_wide",
           "sparse_attention_banded", "rglru_scan", "ssd_chunk_scan")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures (csrc/*.cu ``extern "C"`` entry points)
_SIGNATURES = {
    "spa_proxy_score": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "spa_gather_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "spa_sparse_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _F, _F, _P, _I, _I, _I, _P],
    "spa_scatter_update_multi": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _I, _L, _I, _I, _P],
    "spa_proxy_score_paged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _F, _P],
    "spa_gather_pages": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    "spa_scatter_pages": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    "spa_scatter_rows_paged": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                               _P],
    "spa_proxy_project": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spa_cosine_drift": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "spa_cosine_drift_paged": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _P],
    "spa_rglru_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "spa_rglru_workspace_bytes": [_I, _I, _I],
    "spa_ssd_chunk_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P],
}

# entry points that return something other than a CUDA error code
_RESTYPES = {"spa_rglru_workspace_bytes": _L}

_state: Dict[str, object] = {"lib": None, "build_seconds": None,
                             "build_log": ""}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_seconds() -> Optional[float]:
    """Wall seconds the last :func:`load` spent compiling (0 = cached)."""
    return _state["build_seconds"]


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the build of the loaded library, kept beside it, so that a process
    that finds the library built still reads it."""
    return _state["build_log"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags and every source and header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path, sources: List[Path]) -> str:
    nvcc = _nvcc()
    obj_dir = lib_path.with_name(f"{lib_path.stem}.objs{os.getpid()}")
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_name(lib_path.name + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {lib_path.name} failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return "\n".join(log)


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    if _state["lib"] is not None:
        return _state["lib"]
    sources = _sources()
    lib_path = BUILD_DIR / f"libspa_kernels-{_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log_path.write_text(_build(lib_path, sources))
    _state["build_seconds"] = time.perf_counter() - t0
    _state["build_log"] = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _RESTYPES.get(fn, ctypes.c_int)
    _state["lib"] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    """Element type codes shared with csrc/common.cuh."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]


def require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"all kernel operands must lie on one CUDA device; got "
                f"{[None if x is None else str(x.device) for x in tensors]}")

"""Multi-pod dry run: trace every (arch x shape x mesh) step on fake tensors.

The JAX package's ``launch/dryrun.py`` lowers and compiles each step on
512 forced host devices.  torch has no compiler to ask, so this module
traces the port's own step instead, without allocating anything:

  * the production mesh (``launch/mesh.py``) is a ``DeviceMesh`` over a
    fake process group of 256 or 512 ranks; this process plays rank 0;
  * the step's arguments are DTensors with the JAX rules' shardings
    (``distributed/sharding.py``), their local shards fake tensors
    (``FakeTensorMode``): shapes, dtypes and devices, no storage;
  * the step runs eagerly under ``implicit_replication`` (a plain tensor
    that meets a DTensor is replicated, as GSPMD treats a constant), the
    model's ``shard_hint`` calls redistribute as the JAX hints constrain,
    and the outputs are redistributed to the builders' out-specs, as
    XLA's ``out_shardings`` do;
  * ``launch/hlo_cost.Analyzer`` counts per-device FLOPs, bytes,
    collectives and live memory while it runs.

The step's kernel-shaped stages run on :class:`DryRunBackend`: the
identification (``proxy_score``), attention and the recurrent scans count
as one fused op each (output shape, FLOPs and bytes by the formulas
beside their plain versions), as the card runs each as one kernel; the
row gather and the cache commits work on each device's own shard, as
GSPMD partitions a gather or a scatter; what DTensor cannot partition is
resharded (:class:`_Repartition`).  Values are never the model's (the
fake group moves no data): only shapes, placements and costs are.

A record keeps the JAX record's keys, so one reader reads either
package's records, except ``xla_cost_analysis`` (a cross-check of an XLA
loop quirk, which has no counterpart).  Some keep their names with a
torch meaning: ``lower_s`` is the time to build the abstract arguments,
``compile_s`` the time to trace and count the step; ``hlo_flops_per_device``
and ``hlo_io_bytes_per_device`` are the traced counts; ``memory`` holds
the local-shard bytes of the arguments and outputs, the peak of the live
fake bytes above the arguments (``temp_bytes``) and ``code_bytes`` None;
the roofline divides by the H100's datasheet rates (``launch/mesh.py``).

Usage (the card's device type by default; ``--device cpu`` on a host
without one):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs import (ASSIGNED, SHAPES, ModelConfig, ShapeConfig,
                                 get_arch, get_shape, supports_shape)
from repro_torch.core.cache import init_model_cache
from repro_torch.core.spa_layer import spa_proxy_specs
from repro_torch.core.strategy import NoCache, resolve_strategy
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.distributed import hints, sharding as shd
from repro_torch.dlm.decoding import (DecodeSettings, DecodeState, prefill,
                                      serve_step)
from repro_torch.kernels import sparse_attention as sa
from repro_torch.kernels.backend import TorchBackend, _positions
from repro_torch.kernels.rglru_scan import rglru_scan_cost
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_cost
from repro_torch.launch import hlo_cost, mesh as mesh_lib
from repro_torch.models.attention import attention_hints
from repro_torch.training.optimizer import AdamWConfig, OptState
from repro_torch.training.trainer import train_step

DOC = __doc__


# ---------------------------------------------------------------------------
# The dry run's kernel backend
# ---------------------------------------------------------------------------

def _local(t):
    return getattr(t, "_local_tensor", t)


def fused_op(like: torch.Tensor, flops: float, byts: float,
             *inputs: torch.Tensor) -> torch.Tensor:
    """``torch.empty_like(like)`` that charges ``flops`` / ``byts`` (per
    device) to the active analyzer and, when an input records gradients,
    passes a gradient of each input's shape back."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        hlo_cost.add_cost(flops, byts)
        return torch.empty_like(like)
    return _FusedGrad.apply(like, flops, byts, *inputs)


class _FusedGrad(torch.autograd.Function):
    """One fused kernel under autograd; its backward charges twice the
    forward's FLOPs and bytes (an estimate: a gradient for each operand)
    and returns a gradient of each input's shape."""

    @staticmethod
    def forward(ctx, like, flops, byts, *inputs):
        ctx.cost = (flops, byts)
        ctx.save_for_backward(*inputs)
        hlo_cost.add_cost(flops, byts)
        return torch.empty_like(like)

    @staticmethod
    def backward(ctx, grad):
        flops, byts = ctx.cost
        hlo_cost.add_cost(2.0 * flops, 2.0 * byts)
        return (None, None, None) + tuple(torch.empty_like(t)
                                          for t in ctx.saved_tensors)


def _batch_like(t, buf):
    """``t`` [B, ...] (a DTensor, or a plain tensor taken as replicated)
    as ``buf``'s batch sharding and replicated elsewhere; its local
    shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = buf.device_mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in buf.placements]
    return t.redistribute(mesh, want).to_local()


def _local_rows(buf, idx_l, width):
    """This device's view of row indices ``idx_l`` [b, k] into ``buf``'s
    sequence shard: (local index clamped into the shard, in-shard mask),
    both expanded to ``width`` [b, k, ...].  The sequence splits over its
    mesh dims in mesh order (every split divides, as the rules
    guarantee)."""
    from torch.distributed.tensor import Shard
    mesh = buf.device_mesh
    n_l = buf.to_local().shape[1]
    coord, span, lo = mesh.get_coordinate(), buf.shape[1], 0
    for m, p in enumerate(buf.placements):
        if p == Shard(1):
            span //= mesh.size(m)
            lo += coord[m] * span
    j = idx_l.long() - lo
    ok = (j >= 0) & (j < n_l)
    j = j.clamp(0, max(n_l - 1, 0))
    tail = (1,) * (len(width) - 2)
    return (j.reshape(j.shape + tail).expand(width),
            ok.reshape(ok.shape + tail).expand(width))


def _scatter_local(buf, idx, rows) -> None:
    """Write ``rows`` [B, k, ...] into ``buf`` [B, N, ...] at ``idx``
    [B, k], in place, each device into its own shard: the rows and indices
    are redistributed to the buffer's batch sharding, then every device
    writes the rows whose index falls in its sequence range (indices
    outside [0, N) drop, as the commit kernel drops them)."""
    rows_l = _batch_like(rows, buf)
    jx, okx = _local_rows(buf, _batch_like(idx, buf), rows_l.shape)
    buf_l = buf.to_local()
    src = torch.where(okx, rows_l.to(buf_l.dtype), buf_l.gather(1, jx))
    buf_l.scatter_(1, jx, src)


def gather_rows_sharded(x, idx):
    """Rows ``idx`` [B, k] of ``x`` [B, N, ...] (indices clamped into
    [0, N)), as GSPMD partitions the gather: each device reads the rows in
    its own sequence shard, zeros elsewhere, and one all-reduce over the
    sequence's mesh dims completes them.  Returns a DTensor sharded like
    ``x``'s batch, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    idx_l = _batch_like(idx, x).long().clamp(0, x.shape[1] - 1)
    x_l = x.to_local()
    width = tuple(idx_l.shape) + tuple(x_l.shape[2:])
    jx, okx = _local_rows(x, idx_l, width)
    rows = torch.where(okx, x_l.gather(1, jx), torch.zeros((), dtype=x.dtype,
                                                           device=x_l.device))
    part = [Shard(0) if p == Shard(0) else
            Partial() if p == Shard(1) else Replicate()
            for p in x.placements]
    glob = (x.shape[0],) + width[1:]
    out = DTensor.from_local(rows, mesh, part, run_check=False,
                             shape=torch.Size(glob),
                             stride=_contiguous_stride(glob))
    return out.redistribute(mesh, [Replicate() if p == Partial() else p
                                   for p in part])


@dataclasses.dataclass(frozen=True)
class DryRunBackend(TorchBackend):
    """The plain versions, with each fused kernel counted as one op (see
    the module docstring) and sharded in-place commits.  Attention counts
    as one op in training too (its backward by estimate, see
    :func:`fused_op`), as the JAX dry run's flash attention is one scan:
    the plain version's block loop would trace every kv block a layer."""

    name = "dryrun"

    def identifier_scores(self, strategy, bp, proxy_mat, x, p_cached,
                          page_table=None):
        mat = (strategy.projection_matrix(bp, proxy_mat)
               if self._base_score(strategy) else None)
        if mat is None or page_table is not None:
            return super().identifier_scores(strategy, bp, proxy_mat, x,
                                             p_cached, page_table)
        # proxy_score: the projection and the cosine in one kernel
        xl = _local(x)
        b, n, d = xl.shape
        p_now = torch.empty_like(p_cached, dtype=x.dtype)
        scores = torch.empty_like(p_cached[..., 0], dtype=torch.float32)
        hlo_cost.add_cost(
            2.0 * b * n * d * mat.shape[-1],
            sum(hlo_cost.tensor_bytes(t)
                for t in (x, mat, p_cached, p_now, scores)))
        return scores, p_now

    def attention(self, q, k, v, *, k_scale=None, v_scale=None,
                  q_positions=None, window=0, soft_cap=0.0, banded=False,
                  q_span=0, kv_len=None):
        q, k, v, k_scale, v_scale = attention_hints(q, k, v, k_scale,
                                                    v_scale)
        q_positions, q_span = _positions(q, q_positions, q_span)
        ql = _local(q)
        b, sq, h, hd = ql.shape
        span = sa.kv_span(k.shape[1], window, banded, q_span)
        ins = [t for t in (q, k, v, k_scale, v_scale, q_positions, kv_len)
               if t is not None]
        byts = sum(hlo_cost.tensor_bytes(t) for t in ins) \
            + hlo_cost.tensor_bytes(q)
        return fused_op(q, sa.sparse_attention_cost(b, sq, h, hd, span),
                        byts, q, k, v)

    def gather_norm(self, h, idx, weight, eps):
        rows = gather_rows_sharded(h, idx)
        rf = rows.float()
        var = torch.mean(rf * rf, dim=-1, keepdim=True)
        normed = (rf * torch.rsqrt(var + eps)) * (1.0 + weight.float())
        return rows, normed.to(h.dtype)

    def scatter_multi(self, buffers, idx, rows):
        names = sorted(rows)
        for n in names:
            _scatter_local(buffers[n], idx, rows[n])
        return {n: buffers[n] for n in names}

    def ssd_scan(self, x, dt, la, b, c, chunk):
        xl = _local(x)
        flops, byts = ssd_chunk_scan_cost(tuple(xl.shape), b.shape[-1],
                                          chunk, xl.element_size())
        return fused_op(x, flops, byts, x, dt, la, b, c)

    def rglru_scan(self, a, x):
        al = _local(a)
        flops, byts = rglru_scan_cost(tuple(al.shape), al.element_size())
        return fused_op(a, flops, byts, a, x)


DRYRUN_BACKEND = DryRunBackend()


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _to_meta(tree):
    return shd.tree_map(lambda t: _meta(t.shape, t.dtype), tree)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this shape."""
    b, n = shape.global_batch, shape.seq_len
    emb = torch_dtype(cfg.param_dtype)
    if cfg.frontend == "audio":
        specs = {"frames": _meta((b, n, cfg.d_model), emb)}
        if shape.kind == "train":
            specs["targets"] = _meta((b, n), torch.int32)
        return specs
    if cfg.frontend == "vision":
        f = min(cfg.frontend_tokens, n // 2)
        return {"tokens": _meta((b, n - f), torch.int32),
                "patches": _meta((b, f, cfg.d_model), emb)}
    return {"tokens": _meta((b, n), torch.int32)}


def abstract_params(cfg: ModelConfig):
    """The parameter tree's shapes and dtypes: ``init_params`` on the meta
    device, which allocates and draws nothing."""
    from repro_torch.models import transformer
    return transformer.init_params(cfg, 0, device="meta")


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                          strategy=None) -> DecodeState:
    """The decode state a ``DecodeSession`` holds, as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, n = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = init_model_cache(cfg, b, n, strategy, device="cpu")
    extras = {}
    n_text = n
    if cfg.frontend == "vision":
        f = min(cfg.frontend_tokens, n // 2)
        n_text = n - f
        extras["patches"] = _meta((b, f, cfg.d_model),
                                  torch_dtype(cfg.param_dtype))
    return DecodeState(
        tokens=_meta((b, n_text), torch.long),
        cache=_to_meta(cache),
        step=0,
        committed=_meta((b, DecodeSettings().commit_ring), torch.int32),
        n_masked=_meta((b,), torch.int32),
        active=_meta((b, n_text), torch.bool),
        extras=extras,
    )


# ---------------------------------------------------------------------------
# Step builders (function + abstract args + in specs + out specs)
# ---------------------------------------------------------------------------

def _rep(tree):
    return shd.tree_map(lambda t: shd.replicated(None, t.dim()), tree)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh):
    opt_cfg = AdamWConfig()
    fn = functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                           strategy=NoCache(backend=DRYRUN_BACKEND))
    abs_p = abstract_params(cfg)
    abs_opt = OptState(step=_meta((), torch.int32), mu=_f32(abs_p),
                       nu=_f32(abs_p))
    abs_batch = input_specs(cfg, shape)
    p_sh = shd.params_shardings(abs_p, cfg, mesh)
    in_sh = (p_sh, shd.opt_state_shardings(abs_opt, p_sh, mesh),
             shd.batch_shardings(abs_batch, shape, mesh, cfg), None)

    def out_sh(out):
        return (p_sh, shd.opt_state_shardings(out[1], p_sh, mesh),
                _rep(out[2]))

    return fn, (abs_p, abs_opt, abs_batch, "generator"), in_sh, (0, 1), \
        out_sh


def _f32(tree):
    return shd.tree_map(lambda t: _meta(t.shape, torch.float32), tree)


def _strategy(cfg):
    return resolve_strategy(cfg, None).with_backend(DRYRUN_BACKEND)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh):
    strat = _strategy(cfg)

    def fn(params, inputs, proxies):
        return prefill(params, cfg, inputs, proxies, strategy=strat)

    abs_p = abstract_params(cfg)
    abs_in = input_specs(cfg, shape)
    abs_prox = spa_proxy_specs(cfg, strat)
    p_sh = shd.params_shardings(abs_p, cfg, mesh)
    in_sh = (p_sh, shd.batch_shardings(abs_in, shape, mesh, cfg),
             _rep(abs_prox))

    # outputs: (h_final, cache) — the cache's N dim over "model", so the
    # stored caches use the whole pod's memory, not just the data axis
    def out_sh(out):
        return (shd.data_pspec(shape, mesh, 3),
                shd.cache_shardings(out[1], shape, mesh))

    return fn, (abs_p, abs_in, abs_prox), in_sh, (), out_sh


def _state_specs(st: DecodeState, shape, mesh) -> DecodeState:
    tok = shd.data_pspec(shape, mesh, 2)
    return DecodeState(
        tokens=tok,
        cache=shd.cache_shardings(st.cache, shape, mesh),
        step=None,
        committed=shd.replicated(mesh, 2),   # tiny ring buffer
        n_masked=shd.replicated(mesh, 1),
        active=tok,
        extras={k: shd.data_pspec(shape, mesh, v.dim())
                for k, v in (st.extras or {}).items()})


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh):
    settings = DecodeSettings(n_candidates=64, parallel_threshold=0.9,
                              max_parallel=8)
    strat = _strategy(cfg)

    def fn(params, state, proxies):
        return serve_step(params, cfg, state, settings, proxies,
                          strategy=strat)

    abs_p = abstract_params(cfg)
    abs_state = abstract_decode_state(cfg, shape, strat)
    abs_prox = spa_proxy_specs(cfg, strat)
    p_sh = shd.params_shardings(abs_p, cfg, mesh)
    in_sh = (p_sh, _state_specs(abs_state, shape, mesh), _rep(abs_prox))

    def out_sh(out):
        return (_state_specs(out[0], shape, mesh), _rep(out[1]))

    return fn, (abs_p, abs_state, abs_prox), in_sh, (1,), out_sh


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# ---------------------------------------------------------------------------
# Distributing abstract arguments, redistributing outputs
# ---------------------------------------------------------------------------

def _zip_map(fn: Callable, tree, specs):
    """fn(leaf, spec) over a tree of dicts / tuples / NamedTuples; other
    leaves (ints, None, strings) pass through."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute(abs_tree, specs, mesh, device: torch.device):
    """A DTensor per meta leaf, its local shard a tensor of the current
    mode (a fake one under ``FakeTensorMode``) on ``device``."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        spec = tuple(spec) if spec is not None else ()
        spec = spec + (None,) * (t.dim() - len(spec))
        loc = torch.empty(shd.local_shape(t.shape, spec, mesh),
                          dtype=t.dtype, device=device)
        return DTensor.from_local(loc, mesh, shd.placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_stride(t.shape))

    return _zip_map(one, abs_tree, specs)


def redistribute(tree, specs, mesh):
    """Outputs to their out-specs (a plain tensor is left as it is)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if not isinstance(t, DTensor) or spec is None:
            return t
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        want = shd.placements(spec, mesh)
        return t if list(t.placements) == want else \
            t.redistribute(mesh, want)

    return _zip_map(one, tree, specs)


def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            loc = _local(t)
            key = loc.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += loc.untyped_storage().nbytes()
    return total


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs for this step: 6*N_active*D (train) / 2*N_active*D."""
    p_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * p_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * p_active * shape.global_batch * shape.seq_len
    # decode: sparse rows per layer (mean k over layers)
    strat = resolve_strategy(cfg, None)
    if not strat.uses_cache:
        mean_k = shape.seq_len
    else:
        mean_k = float(np.mean(strat.k_schedule(cfg, shape.seq_len)))
    return 2.0 * p_active * shape.global_batch * mean_k


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          mesh) -> float:
    """HBM traffic model per device per step (the JAX package's model):
    parameter reads, activation residual traffic, cache traffic,
    optimizer state and logits."""
    n_batch = shd.axis_size(mesh, shd.batch_axes(mesh))
    n_model = shd.axis_size(mesh, "model")
    n_chips = n_batch * n_model
    p_bytes = cfg.param_count() * 2.0            # bf16
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    b, n = shape.global_batch, shape.seq_len
    act_bytes = 2.0

    if shape.kind == "train":
        nm = max(cfg.microbatch, 1)
        b_loc = max(b // n_batch, 1)
        act = b_loc * n * d * act_bytes * L * 6.0 * 3.0   # fwd+bwd+remat
        weights = 2.0 * p_bytes * nm
        opt = 24.0 * cfg.param_count()                     # f32 m/v/p rw
        logits = 2.0 * b_loc * n * V * 4.0 * 2.0           # chunked, recomp
        return act + weights + opt + logits
    if shape.kind == "prefill":
        b_loc = max(b // n_batch, 1)
        act = b_loc * n * d * act_bytes * L * 6.0
        cache_tok = (2 * cfg.kv_dim + d) * act_bytes + cfg.spa.rank * 2.0
        if cfg.cache_dtype == "int8":
            cache_tok = (2 * cfg.kv_dim + d) * 1.0 + cfg.spa.rank * 2.0
        cache = b * n * cache_tok * L / n_chips
        return act + p_bytes + cache
    # decode: sparse rows + identification + cache traffic
    strat = resolve_strategy(cfg, None)
    mean_k = (float(np.mean(strat.k_schedule(cfg, n)))
              if strat.uses_cache else n)
    tok_dev = b * n / n_chips
    ident = tok_dev * d * act_bytes * L * 2.0          # read h + proxy mm
    rows = b * mean_k * d * act_bytes * L * 6.0 / n_chips
    cache_tok = (2 * cfg.kv_dim + d) * \
        (1.0 if cfg.cache_dtype == "int8" else act_bytes)
    cache = b * n * cache_tok * L * 1.5 / n_chips      # read + sparse write
    logits = b * 64 * V * 4.0 / n_batch
    return ident + rows + cache + p_bytes + logits


def roofline_terms(parsed: Dict[str, Any], cfg: ModelConfig,
                   shape: ShapeConfig, mesh) -> Dict[str, float]:
    flops = float(parsed["flops"])
    io = float(parsed["bytes_accessed"])
    mem_bytes = analytic_memory_bytes(cfg, shape, mesh)
    cbytes = float(parsed["collective_bytes"])
    return {
        "hlo_flops_per_device": flops,
        "hlo_io_bytes_per_device": io,      # every op's operands + output
        "hbm_bytes_per_device": mem_bytes,
        "collective_bytes_per_device": cbytes,
        "t_compute_s": flops / mesh_lib.PEAK_FLOPS_BF16,
        "t_memory_s": mem_bytes / mesh_lib.HBM_BANDWIDTH,
        "t_collective_s": cbytes / mesh_lib.ICI_BANDWIDTH,
    }


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def act_batch_axes(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The activation batch axes of the hints inside model code."""
    ba = shd.batch_axes(mesh)
    full = cfg.moe is None
    if full and shape.global_batch % shd.axis_size(
            mesh, ba + ("model",)) == 0:
        return ba + ("model",)
    if shape.global_batch % shd.axis_size(mesh, ba) == 0:
        return ba
    return ()


@contextlib.contextmanager
def _real_index_math():
    """DTensor computes a strided shard's local indices (a dim flattened
    from two sharded dims) with ``torch.arange(...).tolist()``; under
    ``FakeTensorMode`` that arange is fake and ``tolist`` raises.  Run that
    index arithmetic on real tensors for the trace's duration."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    @functools.wraps(orig)
    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


class _Repartition:
    """A dispatch mode (built lazily: torch's mode class) for the ops that
    DTensor cannot partition as their inputs lie, as GSPMD reshards
    around them.  Where DTensor refuses an op (no strategy, a reshape that
    splits a sharded dim, a dim sharded over two mesh dims, an in-place
    op whose self would move), it retries: a view with the dims it
    changes gathered; else with each dim sharded over several mesh dims
    kept on the first of them; else on replicated inputs, the op run on
    each device's full copy (an in-place op writes its result back into
    its own shards).  Every redistribution is counted as a collective."""

    _VIEWS = ("view", "_unsafe_view", "reshape")

    @classmethod
    def make(cls):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                try:
                    return func(*args, **kwargs)
                except Exception:
                    if not any(hasattr(a, "placements") for a in
                               tree_flatten((args, kwargs))[0]):
                        raise
                return cls._retry(func, args, kwargs)

        return Mode()

    @classmethod
    def _retry(cls, func, args, kwargs):
        mutates = func._schema.is_mutable
        if func._opname in cls._VIEWS:
            return func(cls._gather_changed(args[0], args[1]), *args[1:],
                        **kwargs)
        if not mutates:
            flat, spec = tree_flatten((args, kwargs))
            simple = [cls._first_mesh_dim(a) for a in flat]
            if any(a is not b for a, b in zip(simple, flat)):
                try:
                    a2, k2 = tree_unflatten(simple, spec)
                    return func(*a2, **k2)
                except Exception:
                    pass
        return cls._replicated(func, args, kwargs, mutates)

    @staticmethod
    def _gather_changed(x, new_shape):
        from torch.distributed.tensor import Replicate, Shard
        keep = 0
        for a, b in zip(x.shape, new_shape):
            if a != b:
                break
            keep += 1
        want = [Replicate() if isinstance(p, Shard) and p.dim >= keep
                else p for p in x.placements]
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def _first_mesh_dim(a):
        """``a`` with each tensor dim sharded on its first mesh dim only."""
        from torch.distributed.tensor import Replicate, Shard
        if not hasattr(a, "placements"):
            return a
        seen, want = set(), []
        for p in a.placements:
            if isinstance(p, Shard) and p.dim in seen:
                want.append(Replicate())
            else:
                if isinstance(p, Shard):
                    seen.add(p.dim)
                want.append(p)
        if want == list(a.placements):
            return a
        return a.redistribute(a.device_mesh, want)

    @staticmethod
    def _replicated(func, args, kwargs, mutates):
        from torch.distributed.tensor import DTensor, Replicate
        flat, spec = tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if hasattr(a, "placements"))
        rep = [Replicate()] * mesh.ndim
        local = [a.redistribute(mesh, rep).to_local()
                 if hasattr(a, "placements") else a for a in flat]
        a2, k2 = tree_unflatten(local, spec)
        out = func(*a2, **k2)
        if mutates and hasattr(args[0], "placements"):
            # the result of an in-place op, back into self's own shards
            args[0].copy_(DTensor.from_local(a2[0], mesh, rep,
                                             run_check=False))
            return args[0]
        o_flat, o_spec = tree_flatten(out)
        return tree_unflatten(
            [DTensor.from_local(t, mesh, rep, run_check=False)
             if isinstance(t, torch.Tensor) else t for t in o_flat], o_spec)


def trace_step(fn, abs_args, in_sh, donate, out_sh, mesh, device,
               act_batch) -> Dict[str, Any]:
    """Trace ``fn`` on fake DTensors of ``abs_args`` under ``in_sh`` and
    count it.  Returns the analyzer's counts plus ``memory`` and the two
    timings (``lower_s``: building the arguments, ``compile_s``: the
    traced step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.Generator(device=device) if a == "generator"
                else distribute(a, s, mesh, device)
                for a, s in zip(abs_args, in_sh)]
        arg_bytes = _unique_bytes(args)
        t_lower = time.time() - t0
        t0 = time.time()
        an = hlo_cost.Analyzer(track_memory=True)
        an.hold(args)
        # a donated argument is held by the step alone, not by the runner
        call = [a for a in args]
        args = [None if i in donate else a for i, a in enumerate(args)]
        with implicit_replication(), _real_index_math(), \
                hints.batch_axes_ctx(act_batch), an, _Repartition.make():
            out = fn(*call)
            del call
            out = redistribute(out, out_sh(out), mesh)
        t_trace = time.time() - t0
        out_bytes = _unique_bytes(out)
        del out, args
    # the rope frequencies are cached per device: drop the fake tensors the
    # trace cached, or a later real step would compute with them
    from repro_torch.models import common
    common._device_frequencies.cache_clear()
    res = an.result()
    res["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": max(an.peak - arg_bytes, 0),
        "code_bytes": None,
    }
    res["lower_s"] = t_lower
    res["compile_s"] = t_trace
    return res


def run_one(arch: str, shape_name: str, mesh_kind: str,
            verbose: bool = True, cfg_override=None, tag: str = "",
            device: DeviceLike = None) -> Dict[str, Any]:
    cfg = cfg_override if cfg_override is not None else get_arch(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind,
    }
    if tag:
        rec["tag"] = tag
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("encoder-only: no decode step"
                         if cfg.is_encoder_only and shape.kind == "decode"
                         else "requires sub-quadratic attention")
        return rec

    dev = resolve_device(device)
    mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                         device_type=dev.type)
    n_chips = int(mesh.size())
    fn, abs_args, in_sh, donate, out_sh = \
        BUILDERS[shape.kind](cfg, shape, mesh)
    res = trace_step(fn, abs_args, in_sh, donate, out_sh, mesh, dev,
                     act_batch_axes(cfg, shape, mesh))

    rec["status"] = "ok"
    rec["n_chips"] = n_chips
    rec["lower_s"] = round(res["lower_s"], 1)
    rec["compile_s"] = round(res["compile_s"], 1)
    rec["memory"] = dict(res["memory"])
    args_b = rec["memory"]["argument_bytes"] or 0
    temp_b = rec["memory"]["temp_bytes"] or 0
    rec["memory"]["per_device_total_gb"] = round(
        (args_b + temp_b) / 2 ** 30, 3)
    rec["collectives"] = res["collectives"]
    rec.update(roofline_terms(res, cfg, shape, mesh))
    rec["model_flops_per_device"] = model_flops(cfg, shape) / n_chips
    if rec["hlo_flops_per_device"]:
        rec["useful_flop_ratio"] = round(
            rec["model_flops_per_device"] / rec["hlo_flops_per_device"], 4)
    terms = {k: rec[k] for k in ("t_compute_s", "t_memory_s",
                                 "t_collective_s")}
    rec["bottleneck"] = max(terms, key=terms.get)
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}"
              + (f" x {tag}" if tag else "") + "] "
              f"trace={res['compile_s']:.1f}s "
              f"mem/dev={rec['memory']['per_device_total_gb']}GB "
              f"compute={rec['t_compute_s']:.4f}s "
              f"memory={rec['t_memory_s']:.4f}s "
              f"coll={rec['t_collective_s']:.4f}s "
              f"-> {rec['bottleneck']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: the "
                         "card; 'cpu' on a host without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    combos = []
    if args.all:
        for a in ASSIGNED:
            for s in SHAPES:
                for m in meshes:
                    combos.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for m in meshes:
            combos.append((args.arch, args.shape, m))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    failures = 0
    with open(args.out, "a") as f:
        for arch, s, m in combos:
            if (arch, s, m) in done:
                print(f"[{arch} x {s} x {m}] cached, skipping", flush=True)
                continue
            try:
                rec = run_one(arch, s, m, device=dev)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                rec = {"arch": arch, "shape": s, "mesh": m,
                       "status": "error", "error": repr(e)[:500]}
                failures += 1
            finally:
                mesh_lib.destroy_mesh()   # the next combo's world size
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

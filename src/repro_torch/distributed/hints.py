"""Sharding hints usable from model code without carrying a mesh around
(the JAX package's ``distributed/hints.py``).

``shard_hint(x, "batch", None, ...)`` redistributes a DTensor to the
resolved spec on its own mesh; a plain tensor comes back as it is (the
card's serving and training paths, where no mesh exists).  The check is
one exact type test before anything else, so a plain tensor costs nothing
more and the port never imports DTensor unless a subclass comes by.

Dim tokens:
  None     — replicated on this dim
  "keep"   — the dim keeps whatever sharding it has (JAX: UNCONSTRAINED)
  "batch"  — the activation batch axes of the current trace; set by
             the launcher via ``batch_axes_ctx`` (e.g. ("data","model")
             for fully-sharded train batches, ("data",) for MoE / decode);
             defaults to whichever of ("pod","data") exist in the mesh.
  "model" / "data" / "pod" / tuples — those axes if present.

Each axis is used at most once, and every resolved axis set is
divisibility-checked against the dim size and dropped (-> replicated)
when it does not divide — so the same model code traces for every
(arch x shape x mesh) combination.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple

import torch

KEEP = "keep"

_STATE = threading.local()


@contextlib.contextmanager
def batch_axes_ctx(axes: Optional[Tuple[str, ...]]):
    """Set the activation batch axes for hints inside this trace."""
    prev = getattr(_STATE, "batch_axes", None)
    _STATE.batch_axes = axes
    try:
        yield
    finally:
        _STATE.batch_axes = prev


def _resolve(dim, names):
    if dim == KEEP:
        return KEEP
    if dim is None:
        return None
    if dim == "batch":
        ctx = getattr(_STATE, "batch_axes", None)
        if ctx is not None:
            present = tuple(a for a in ctx if a in names)
            return present if present else None
        ba = tuple(a for a in ("pod", "data") if a in names)
        return ba if ba else None
    if isinstance(dim, str):
        return dim if dim in names else None
    if isinstance(dim, tuple):
        present = tuple(a for a in dim if a in names)
        return present if present else None
    return None


def resolve_spec(shape, dims, sizes: Dict[str, int]) -> tuple:
    """The spec a hint asks of a tensor of ``shape`` on a mesh of axis
    ``sizes`` ({name: size}, mesh order): one entry per dim, ``None``, an
    axis name, a tuple of names or ``KEEP``."""
    names = tuple(sizes)
    ndim = len(shape)
    if len(dims) != ndim:
        dims = tuple(dims) + (None,) * (ndim - len(dims))
    spec = []
    used: set = set()
    for i, d in enumerate(dims):
        r = _resolve(d, names)
        if r is not None and r != KEEP:
            axes = tuple(a for a in ((r,) if isinstance(r, str) else r)
                         if a not in used)   # each axis at most once
            if not axes:
                r = None
            else:
                total = int(math.prod(sizes[a] for a in axes))
                if shape[i] % total != 0:
                    r = None  # indivisible -> replicate
                else:
                    used.update(axes)
                    r = axes if len(axes) > 1 else axes[0]
        spec.append(r)
    return tuple(spec)


def shard_hint(x: torch.Tensor, *dims) -> torch.Tensor:
    """Redistribute a DTensor to the resolved spec; ``x`` itself when it is
    not a DTensor."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    spec = resolve_spec(x.shape, dims, sizes)
    target = []
    for m, axis in enumerate(names):
        place = Replicate()
        for d, entry in enumerate(spec):
            if entry == KEEP:
                continue
            if axis in ((entry,) if isinstance(entry, str) else
                        (entry or ())):
                place = Shard(d)
                break
        else:
            cur = x.placements[m]
            if (isinstance(cur, Shard) and spec[cur.dim] == KEEP):
                place = cur
        target.append(place)
    if list(x.placements) == target:
        return x
    return x.redistribute(mesh, target)

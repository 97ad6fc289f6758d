"""Per-device cost of a traced step (the JAX package's ``launch/hlo_cost.py``).

torch has no HLO.  The JAX module re-derives FLOPs, bytes and collective
bytes from the partitioned HLO text, with loop-trip multipliers; this one
counts the same quantities while the step runs eagerly, on fake tensors,
under a ``TorchDispatchMode``:

  * FLOPs: ``torch.utils.flop_counter``'s formula for each aten op that has
    one (mm, bmm, addmm, baddbmm, convolutions, attention); other ops
    count none, as XLA's ``dot`` / ``convolution`` are the only ops the
    JAX module counts;
  * bytes: the operand and output bytes of every aten op that moves data
    (views and allocations move none), like HLO's top-level instructions;
  * collectives: each ``_c10d_functional`` / ``c10d`` op, by kind, with its
    result bytes, as the JAX module reads collective result shapes;
  * memory (with ``track_memory``): the live bytes of every tensor the
    step made, freed when its last reference goes, and their peak.

Loops need no trip counts: eager tracing runs them.  A stage that stands
for one fused kernel (the dry run's attention and recurrent scans) adds its
cost by formula through :func:`add_cost` and makes its output with an
allocation, so it counts as one op.

Every number is per device.  A mode that sits outside DTensor sees each op
once, at the DTensor level, with global shapes: its FLOPs are scaled by
the output's local over global element count and divided by the size of
every mesh dim on which the output is ``Partial`` (each device computes
its share of the partial sums); its bytes are those of the local shards.
The collectives DTensor issues inside an op (redistributing an input) run
on local shards and are caught by a second mode pushed for the op's
duration; those an explicit ``redistribute`` issues are seen directly.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the active analyzers, innermost last (``add_cost`` reaches the innermost)
_ACTIVE: List["Analyzer"] = []


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
        return None
    name = func._opname
    if "wait" in name:
        return None
    for key, kind in (("all_gather", "all-gather"),
                      ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all")):
        if key in name:
            return kind
    return "collective-permute"        # broadcast, send / recv, permute


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s local shard (the tensor itself when it is plain)."""
    t = _local(t)
    return t.numel() * t.element_size()


def _partial_divisor(t) -> int:
    placements = getattr(t, "placements", None)
    if placements is None:
        return 1
    div = 1
    for m, p in enumerate(placements):
        if p.is_partial():
            div *= t.device_mesh.size(m)
    return div


# ops that move no data: allocations, aliases that ``is_view`` misses and
# a collective's wait (``prim`` ops read metadata only)
_NO_BYTES = frozenset(("empty", "empty_like", "new_empty", "empty_strided",
                       "new_empty_strided", "_unsafe_view", "alias",
                       "lift_fresh", "wait_tensor"))


class _CollectiveTap(TorchDispatchMode):
    """Pushed for one DTensor op: counts the collectives that the op's
    dispatch issues on local shards, passes everything else on."""

    def __init__(self, owner: "Analyzer"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _collective_kind(func)
        if kind is not None:
            self.owner._collective(kind, out)
        return out


class Analyzer(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and (optionally) live memory of
    everything that runs inside it; see the module docstring."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives = {k: {"count": 0.0, "bytes": 0.0}
                            for k in COLLECTIVES}
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, List[int]] = {}   # id -> [refs, bytes]

    # ---- results ---------------------------------------------------------

    def result(self) -> Dict[str, Any]:
        return {"flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()},
                "collective_bytes": sum(v["bytes"] for v in
                                        self.collectives.values())}

    def add(self, flops: float = 0.0, bytes_accessed: float = 0.0) -> None:
        self.flops += float(flops)
        self.bytes_accessed += float(bytes_accessed)

    # ---- memory ----------------------------------------------------------

    def hold(self, tree) -> int:
        """Track the tensors of ``tree`` as live (arguments made before the
        trace); returns the bytes newly tracked."""
        before = self.live
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        loc = _local(t)
        try:
            st = loc.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, st.nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(loc, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    # ---- dispatch --------------------------------------------------------

    def _collective(self, kind: str, out) -> None:
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += sum(
            tensor_bytes(t) for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor_op = any(hasattr(a, "_local_tensor")
                         for a in tree_flatten((args, kwargs))[0])
        if dtensor_op:
            with _CollectiveTap(self):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            self._collective(kind, out)
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry and outs:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            o = outs[0]
            if hasattr(o, "_local_tensor") and o.numel():
                flops = (flops * _local(o).numel() / o.numel()
                         / _partial_divisor(o))
            self.flops += flops
        if not (func.is_view or func._opname in _NO_BYTES
                or func.namespace == "prim"):
            # an ``out=`` buffer is written, not read
            ins = [t for t in tree_flatten(
                       (args, {k: v for k, v in kwargs.items()
                               if k != "out"}))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(tensor_bytes(t) for t in ins + outs)
        if self.track_memory:
            for t in outs:
                self._track(t)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)


def add_cost(flops: float = 0.0, bytes_accessed: float = 0.0) -> None:
    """Charge a formula-counted stage to the innermost active analyzer
    (nothing when none is active)."""
    if _ACTIVE:
        _ACTIVE[-1].add(flops, bytes_accessed)


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under an :class:`Analyzer` and return
    the JAX ``analyze_hlo`` keys: ``flops``, ``bytes_accessed``,
    ``collectives`` ({kind: {"count", "bytes"}} for the five kinds) and
    ``collective_bytes``."""
    with Analyzer() as an:
        fn(*args, **kwargs)
    return an.result()

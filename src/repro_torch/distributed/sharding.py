"""Sharding rules: map every tensor of the system onto the production mesh
(the JAX package's ``distributed/sharding.py``, rule for rule).

Baseline scheme:
  * weights     — last dim over "model" when divisible (tensor dim), and,
                  for zero3 configs, another dim over the batch axes
                  (ZeRO-3 / FSDP); stacked-layer leading dims never shard.
  * activations — batch over ("pod","data"); for long_500k (batch=1) the
                  SEQUENCE dim shards over the batch axes instead.
  * caches      — [Lk, B, N, ...]: batch over batch axes, sequence over
                  "model".

A spec is a tuple with one entry per tensor dim, each ``None``, an axis
name or a tuple of axis names: a ``PartitionSpec``'s entries, so specs of
the two packages compare directly.  ``placements`` turns a spec into
DTensor placements on a ``DeviceMesh``.  Every function takes the port's
``DeviceMesh`` or any object with ``axis_names`` and a per-axis ``shape``
mapping (a JAX ``AbstractMesh`` among them), so the rules need no process
group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


# Tensor-parallel placement per weight name (Megatron-style):
#   "row"    — shard the contraction (input) dim over "model"; the matmul
#              produces partial sums -> one all-reduce, activations stay
#              replicated over "model" (attention runs fully local).
#   "column" — shard the output dim over "model"; downstream op consumes
#              the sharded feature dim locally (FFN up / lm head).
_ROW_PARALLEL = {"wq", "wk", "wv", "wo", "w_down", "w_out"}
_COLUMN_PARALLEL = {"w_gate", "w_up", "lm_head", "w_in", "w_gate_branch"}
_VOCAB_SHARDED = {"embed", "pos_embed"}
_REPLICATED = {"router", "conv_kernel", "log_lambda", "a_log", "dt_bias",
               "d_skip", "norm_weight"}


def param_pspec(name: str, leaf: Any, mesh, *, zero3: bool,
                stacked: bool) -> Spec:
    """Choose a spec for one parameter leaf (by its dict key name)."""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec: list = [None] * ndim
    start = 1 if (stacked and ndim >= 2) else 0
    dims = list(range(start, ndim))
    if not dims or ndim - start < 2 or name in _REPLICATED:
        return tuple(spec)

    model_dim = None
    is_moe_expert = (name in ("w_gate", "w_up", "w_down")
                     and ndim - start == 3)
    is_gate_heads = name in ("w_a", "w_x") and ndim - start == 3
    if (is_moe_expert or is_gate_heads) and _divisible(
            shape[start], mesh, "model"):
        model_dim = start             # expert / gate-head parallelism
    elif name in _ROW_PARALLEL:
        model_dim = ndim - 2                       # contraction dim
    elif name in _COLUMN_PARALLEL:
        model_dim = ndim - 1                       # output dim
    elif name in _VOCAB_SHARDED:
        model_dim = start                          # vocab / position dim
    if model_dim is not None and _divisible(shape[model_dim], mesh,
                                            "model"):
        spec[model_dim] = "model"
    elif model_dim is not None:
        # fall back to any divisible dim (e.g. hubert vocab=504)
        for d in reversed(dims):
            if _divisible(shape[d], mesh, "model") and shape[d] >= 128:
                spec[d] = "model"
                break

    if zero3:
        ba = batch_axes(mesh)
        if ba:
            for d in dims:
                if spec[d] is None and shape[d] >= 256 and \
                        _divisible(shape[d], mesh, ba):
                    spec[d] = ba if len(ba) > 1 else ba[0]
                    break
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict (None stays None)."""
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def params_shardings(abs_params: Any, cfg: ModelConfig, mesh) -> Any:
    """A spec per parameter leaf, in the params' nested-dict layout: the
    leaf's name is its innermost key, and a leaf under ``blocks`` is a
    per-kind stack whose leading [L_kind] dim never shards."""
    if not cfg.tp_weights:
        return tree_map(lambda leaf: replicated(mesh, len(leaf.shape)),
                        abs_params)

    def choose(path, leaf):
        return param_pspec(path[-1], leaf, mesh, zero3=cfg.zero3,
                           stacked="blocks" in path)

    return _map_with_path(choose, abs_params)


def opt_state_shardings(abs_opt: Any, abs_params_shardings: Any,
                        mesh) -> Any:
    """mu/nu shard like params; step replicated."""
    from repro_torch.training.optimizer import OptState
    return OptState(step=replicated(mesh, 0), mu=abs_params_shardings,
                    nu=abs_params_shardings)


def data_pspec(shape: ShapeConfig, mesh, ndim: int, seq_dim: int = 1,
               full: bool = True) -> Spec:
    """Spec for a batched input [B, N, ...].

    Preference order: batch over ALL axes (pod x data x model — the FSDP
    regime, which keeps tensor-parallel partial-sum all-reduces tiny),
    else batch over (pod, data), else sequence over all axes (batch=1
    long-context)."""
    ba = batch_axes(mesh)
    all_axes = ba + ("model",)
    spec: list = [None] * ndim
    if not ba:
        return tuple(spec)
    if full and shape.global_batch % axis_size(mesh, all_axes) == 0:
        spec[0] = all_axes
    elif shape.global_batch % axis_size(mesh, ba) == 0:
        spec[0] = ba if len(ba) > 1 else ba[0]
    elif ndim > seq_dim and shape.seq_len % axis_size(mesh, all_axes) == 0:
        spec[seq_dim] = all_axes
    return tuple(spec)


def cache_pspec(shape: ShapeConfig, mesh, ndim: int) -> Spec:
    """Cache leaf [Lk, B, N, ...]: B over batch axes, N over model."""
    ba = batch_axes(mesh)
    spec: list = [None] * ndim
    if ba and shape.global_batch % axis_size(mesh, ba) == 0:
        spec[1] = ba if len(ba) > 1 else ba[0]
        if shape.seq_len % axis_size(mesh, "model") == 0:
            spec[2] = "model"
    elif shape.seq_len % axis_size(mesh, ba + ("model",)) == 0:
        # batch=1 long-context: sequence over everything
        spec[2] = ba + ("model",)
    return tuple(spec)


def batch_shardings(abs_batch: Dict[str, Any], shape: ShapeConfig,
                    mesh, cfg: Optional[ModelConfig] = None
                    ) -> Dict[str, Spec]:
    # MoE archs keep the model axis free for expert parallelism / TP.
    full = cfg is None or cfg.moe is None
    return {k: data_pspec(shape, mesh, len(v.shape), full=full)
            for k, v in abs_batch.items()}


def cache_shardings(abs_cache: Any, shape: ShapeConfig, mesh) -> Any:
    return tree_map(lambda leaf: cache_pspec(shape, mesh, len(leaf.shape)),
                    abs_cache)


def replicated(mesh, ndim: int = 0) -> Spec:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d's entry names that axis, else
    ``Replicate()``.  A dim over several axes shards on each of them in
    mesh order (data-major for ("data", "model"))."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_axes(mesh):
        place = Replicate()
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            if axis in axes:
                place = Shard(d)
                break
        out.append(place)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides, as the rules guarantee)."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        out.append(n // axis_size(mesh, entry) if entry else n)
    return tuple(out)

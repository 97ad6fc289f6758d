"""Flat-npz pytree checkpoints (the JAX package's ``training/checkpoint.py``,
same file format).

A tree of dicts, lists and array leaves is flattened to ``a/b/c`` keys
(list items as ``#i``), bfloat16 leaves are stored as their uint16 bit
pattern, and two JSON entries ride along: ``__dtypes__`` (each key's dtype
name, ``bfloat16`` for the tagged leaves) and ``__meta__``.  A checkpoint
written by either package loads in the other.

Leaves may be torch tensors or numpy arrays (numpy's ``ml_dtypes``
bfloat16 included).  :func:`load_checkpoint` returns CPU torch tensors of
the stored dtypes, which ``weights.from_numpy_params`` takes as it takes
numpy arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaf_array(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name) for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def save_checkpoint(path: str, tree,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tagged, dtypes = {}, {}
    for k, leaf in _flatten(tree).items():
        tagged[k], dtypes[k] = _leaf_array(leaf)
    np.savez(path, __dtypes__=json.dumps(dtypes),
             __meta__=json.dumps(metadata or {}), **tagged)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(tree of CPU tensors, metadata) from a checkpoint file."""
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        meta = json.loads(str(z["__meta__"]))
        flat = {}
        for k in z.files:
            if k.startswith("__"):
                continue
            a = np.array(z[k], order="C", copy=True)
            if dtypes.get(k) == "bfloat16":
                flat[k] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(a)
    return _unflatten(flat), meta

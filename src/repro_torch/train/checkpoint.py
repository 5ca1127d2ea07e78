"""Checkpoints: an ``.npz`` of the leaves plus a ``.json`` manifest (the
port of the JAX package's ``train/checkpoint.py``, in its file format).

Leaves are written in ``jax.tree.flatten``'s order -- a dict's keys
sorted, a list or tuple in order -- as ``leaf_{i}``, so one file reads in
both packages.  The manifest holds the tree's structure (``treedef``, in
JAX's notation), ``n_leaves`` and each leaf's ``dtypes`` and ``shapes``.

A bfloat16 leaf is written as its raw 2-byte bits, which is what
``np.savez`` writes for the JAX package's ml_dtypes bfloat16 (a ``|V2``
array); ``restore_checkpoint`` reinterprets every leaf by the manifest's
dtype, so a bf16 checkpoint of either package restores here bit for bit.
"""
from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in JAX's flatten order, the structure as JAX prints it)."""
    leaves: List[Any] = []

    def go(x) -> str:
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {go(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(go(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(go(v) for v in x)
            return "(" + inner + ("," if len(x) == 1 else "") + ")"
        leaves.append(x)
        return "*"
    return leaves, f"PyTreeDef({go(tree)})"


def _unflatten(like, leaves) -> Any:
    it = iter(leaves)

    def go(x):
        if isinstance(x, dict):
            out = {k: go(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}      # the caller's key order
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return next(it)
    return go(like)


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """(the array as written, its dtype's name for the manifest)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors) to
    ``path.npz`` and ``path.json``."""
    leaves, treedef = _flatten(tree)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        arrays[f"leaf_{i}"], dtype = _to_numpy(x)
        dtypes.append(dtype)
    np.savez(path + ".npz", **arrays)
    manifest = {
        "treedef": treedef,
        "n_leaves": len(leaves),
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def _leaf(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    # ``a`` is read afresh from the file and owned here alone: no copy
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore_checkpoint(path: str, like: Any, shardings: Any = None, *,
                       mesh=None) -> Any:
    """The tree saved at ``path``, in the structure of ``like`` (its
    values are ignored), each leaf on the device of ``like``'s leaf.
    With ``shardings`` (a tree of ``models.sharding.Spec`` in ``like``'s
    structure, as ``params_shardings`` gives) and ``mesh``, every rank
    of the mesh reads the checkpoint and keeps its own shard of each
    leaf, a DTensor placed by its spec."""
    if shardings is not None and mesh is None:
        raise ValueError("restoring onto shardings needs their mesh")
    with open(path + ".json") as f:
        manifest = json.load(f)
    like_leaves, _ = _flatten(like)
    spec_leaves = None
    if shardings is not None:
        from repro_torch.models.sharding import place
        spec_leaves, _ = _flatten(shardings)   # a Spec is a leaf
    with np.load(path + ".npz") as data:
        if len(like_leaves) != len(data.files) or \
                manifest["n_leaves"] != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves (manifest "
                f"{manifest['n_leaves']}), expected {len(like_leaves)}")
        leaves = []
        for i, ref in enumerate(like_leaves):
            if spec_leaves is None:
                leaves.append(_leaf(data[f"leaf_{i}"], manifest["dtypes"][i],
                                    ref))
                continue
            full = _leaf(data[f"leaf_{i}"], manifest["dtypes"][i], None)
            leaves.append(place(full.to(mesh.device_type), mesh,
                                spec_leaves[i], shared=False))
            del full
    return _unflatten(like, leaves)

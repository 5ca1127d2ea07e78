"""Adam(W) in plain tensor ops (the port of the JAX package's
``train/optimizer.py``): fp32 moments, bias correction, global-norm
clipping, linear-warmup / constant / cosine schedules.

Not ``torch.optim.Adam``: its update order and its ``eps`` placement
differ from the reference's.  Params are nested dicts of tensors.

``adam_update`` builds new param tensors, as the reference does, and
never writes a param in place: a weight snapshot handed to the generator
stays as it was however many steps the trainer takes.  The fp32 moments
are the optimizer's own and are updated in place (the returned state
shares them with the state passed in): a second copy of m and v would be
two more fp32 copies of the model.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import numpy as np
import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples: a dict's values in
    insertion order, a list's or tuple's items in order (``jax.tree``
    walks lists and tuples so too; it sorts a dict's keys, which this
    does not, so the leaf order of a tree of dicts stays as it was)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples of one
    structure; a list stays a list and a tuple a tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """The structure of ``tree`` holding ``leaves`` (as ``tree_leaves``
    orders them)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class AdamState(NamedTuple):
    step: int          # updates taken, on the host
    m: Any
    v: Any


def adam_init(params) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(step=0, m=tree_map(zeros, params),
                     v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float32).square()
        for x in tree_leaves(tree)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, global norm); the scale is cast to each
    gradient's dtype before the product, as in the reference."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adam_update(params, grads, state: AdamState, *, lr,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                grad_norm=None):
    """Returns (new_params, new_state, metrics).  The clipped gradient is
    formed one leaf at a time, so no clipped copy of all grads exists.
    ``grad_norm``, when given, is the global norm of ``grads``: a caller
    that holds shards of them takes it over every rank."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gn, max_norm=max_grad_norm) if max_grad_norm \
        else None
    step = state.step + 1
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)

    @torch.no_grad()
    def upd(p, g, m, v):
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.float()
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        del g, gf
        update = (m / c1).div_((v / c2).sqrt_().add_(eps))
        if weight_decay:
            update.add_(p.float(), alpha=weight_decay)
        new = p.to(torch.float32, copy=True).sub_(update.mul_(lr))
        return new.to(p.dtype)

    new_params = tree_map(upd, params, grads, state.m, state.v)
    return new_params, AdamState(step, state.m, state.v), {"grad_norm": gn}


def lr_schedule(kind: str, base_lr: float, warmup: int = 0,
                total: int = 0):
    """step -> lr, in float32 arithmetic as the reference computes it:
    linear warmup over ``warmup`` steps, then constant or (``kind ==
    "cosine"`` with ``total``) cosine decay to 0 at ``total``."""
    def fn(step: int) -> float:
        lr = np.float32(base_lr)
        if warmup:
            lr = lr * min(np.float32(1.0),
                          np.float32(step + 1) / np.float32(warmup))
        if kind == "cosine" and total:
            frac = np.clip(np.float32(step - warmup)
                           / np.float32(max(total - warmup, 1)),
                           np.float32(0), np.float32(1))
            lr = lr * np.float32(0.5) * (np.float32(1)
                                         + np.cos(np.float32(np.pi) * frac))
        return float(lr)
    return fn

"""The sharded train step: the reference dry run's ``train`` branch
(``jit(make_train_step(cfg), in_shardings=(state_shardings,
batch_shardings), out_shardings=(state_shardings, None))``), run on a
``DeviceMesh`` rather than lowered.

Storage: each rank holds exactly the shard of the params, ``m`` and ``v``
that ``state_shardings`` names, as DTensors (``shard_state``);
``AdamState.step`` stays on the host.

One step (``make_sharded_train_step``):
  1. gather every param leaf (``full_tensor``), the whole tree at once;
  2. run the port's own loss and backward on this rank's rows as
     ``batch_shardings`` places them: its share along the data-parallel
     axes where they divide B, else every row (the rows are replicated);
  3. sum the gradients over the data-parallel axes (``Partial``) and
     redistribute them to the params' placements: a reduce-scatter where
     a leaf is sharded over ``data``, a slice where it is sharded over
     ``model``.  The ranks of a ``model`` row ran the same rows and hold
     the same gradients, so nothing is summed over ``model`` (under
     expert parallelism each holds its own experts' rows of an expert
     leaf, the rows its shard keeps); with replicated rows nothing is
     summed at all;
  4. Adam on the local shards, clipped by the global gradient norm: the
     local shards' squares summed over the mesh, a leaf's replicated
     copies counted once.

The AIPO and MTP normalisers, the metrics and the MoE's load-balance
means are over the global batch (``activation_sharding(split_rows=True)``,
``batch_total``), and each microbatch of ``accum_steps`` over the global
microbatch, so the step computes the one-device step's numbers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.sharding import _axis_size, _sizes, \
    activation_sharding, axis_names, batch_shardings, distribute, dp_axes, \
    groups, state_shardings
from repro_torch.train.optimizer import AdamState, adam_update, \
    tree_leaves, tree_map
from repro_torch.train.trainstep import TrainState, make_loss_fn, \
    value_and_grad


def shard_state(state: TrainState, mesh) -> TrainState:
    """``state`` (the same full state on every rank) as DTensors placed
    by ``state_shardings``; each rank keeps its own shards."""
    sh = state_shardings(state, mesh)
    return TrainState(
        distribute(state.params, mesh, sh.params),
        AdamState(state.opt.step, distribute(state.opt.m, mesh, sh.opt.m),
                  distribute(state.opt.v, mesh, sh.opt.v)))


def local_rows(batch, mesh):
    """(this rank's rows of ``batch``, whether they are a share of split
    rows).  The rows split along the data-parallel axes, major first,
    where ``batch_shardings`` keeps them, and are all of ``batch``
    where it drops them (B % dp != 0)."""
    if batch_shardings({"tokens": batch["tokens"]}, mesh)["tokens"][0] \
            is None:
        return batch, False
    sizes, i = _sizes(mesh), 0
    for a in dp_axes(mesh):
        i = i * sizes[a] + mesh.get_local_rank(a)
    n = batch["tokens"].shape[0] // _axis_size(mesh, dp_axes(mesh))
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}, True


def _reduce_grad(g, placements, mesh, split: bool):
    """This rank's gradient of a whole leaf -> its shard of the global
    gradient: summed over the data-parallel axes when the rows are
    split, then cut to ``placements``."""
    dp = dp_axes(mesh)
    src = [Partial() if split and a in dp else Replicate()
           for a in axis_names(mesh)]
    return DTensor.from_local(g, mesh, src, run_check=False).redistribute(
        mesh, placements).to_local()


def sharded_global_norm(local_grads, placements, mesh):
    """The global norm of gradients of which this rank holds shards:
    each shard's squares, a leaf's replicated copies counted once,
    summed over the mesh."""
    sizes = _sizes(mesh)
    total = 0
    for g, pl in zip(local_grads, placements):
        copies = 1
        for a, p in zip(axis_names(mesh), pl):
            if isinstance(p, Replicate):
                copies *= sizes[a]
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        total = total + (sq / copies if copies > 1 else sq)
    total = total.clone()
    for grp in groups(mesh, axis_names(mesh)):
        dist.all_reduce(total, group=grp)
    return torch.sqrt(total)


def make_sharded_train_step(cfg, mesh, *, lr=2e-7, rho=4.0,
                            clip_mode="aipo", kl_coef=0.0,
                            max_grad_norm=1.0, weight_decay=0.0,
                            mtp_weight=0.1, remat=False, lr_fn=None,
                            accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics), the step of
    ``make_train_step`` on the state ``shard_state`` gives.  ``batch`` is
    the global batch, the same on every rank; the step keeps this rank's
    rows.  Every rank of the mesh calls it; the metrics are global."""
    loss_fn = make_loss_fn(cfg, rho=rho, clip_mode=clip_mode, kl_coef=kl_coef,
                           mtp_weight=mtp_weight, remat=remat)

    def train_step(state: TrainState, batch) -> tuple:
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch of {B} does not split into "
                             f"{accum_steps} microbatches")
        mb = B // accum_steps
        placements = [t.placements for t in tree_leaves(state.params)]
        full = tree_map(lambda t: t.full_tensor(), state.params)
        grads = None
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            rows, split = local_rows(micro, mesh)
            with activation_sharding(mesh, split_rows=split):
                (_, metrics), g = value_and_grad(loss_fn, full, rows)
            if accum_steps == 1:
                grads = g
            else:
                if grads is None:
                    grads = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device), full)
                tree_map(lambda a, b: a.add_(b), grads, g)
            del g
        del full
        if accum_steps > 1:
            tree_map(lambda g: g.div_(accum_steps), grads)
        with torch.no_grad():
            local_g = [_reduce_grad(g, pl, mesh, split) for g, pl in
                       zip(tree_leaves(grads), placements)]
        del grads
        gn = sharded_global_norm(local_g, placements, mesh)
        step_lr = lr_fn(state.opt.step) if lr_fn is not None else lr

        def local(tree):
            return tree_map(lambda t: t.to_local(), tree)

        it = iter(local_g)
        params, opt, opt_metrics = adam_update(
            local(state.params), tree_map(lambda _: next(it), state.params),
            AdamState(state.opt.step, local(state.opt.m),
                      local(state.opt.v)),
            lr=step_lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, grad_norm=gn)

        def placed(tree, like):
            return tree_map(lambda t, d: DTensor.from_local(
                t, mesh, d.placements, run_check=False), tree, like)

        new = TrainState(placed(params, state.params),
                         AdamState(opt.step, placed(opt.m, state.opt.m),
                                   placed(opt.v, state.opt.v)))
        return new, {**metrics, **opt_metrics}

    return train_step

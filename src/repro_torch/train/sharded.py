"""The sharded train step: the reference dry run's ``train`` branch
(``jit(make_train_step(cfg), in_shardings=(state_shardings,
batch_shardings), out_shardings=(state_shardings, None))``), run on a
``DeviceMesh`` rather than lowered.

Storage: each rank holds exactly the shard of the params, ``m`` and ``v``
that ``state_shardings`` names, as DTensors (``shard_state``);
``AdamState.step`` stays on the host.

One step (``make_sharded_train_step``):
  1. gather the param leaves outside the layer stacks (embeddings, head,
     norms, the hybrid's shared block, the MTP head) from their shards;
  2. run the port's own loss and backward on this rank's rows as
     ``batch_shardings`` places them: its share along the data-parallel
     axes where they divide B, else every row (the rows are replicated).
     A stacked leaf reaches the model as its shard
     (``backbone.StackShard``): each layer gathers its own slice when it
     runs, inside that layer's checkpoint under ``cfg.remat_layers``, so
     the backward gathers it again, as XLA gathers a stacked leaf's
     layer inside the reference's layer scan.  With ``remat_layers`` a
     rank holds its shards, the leaves outside the stacks, one gathered
     layer (two while the backward gathers one again), the layers'
     inputs and one layer's recompute;
  3. each gather's backward sums its gradient over the data-parallel
     axes (``Partial``) and cuts it to the leaf's placements: a
     reduce-scatter where a leaf is sharded over ``data``, a slice where
     it is sharded over ``model``, one layer at a time, so no whole
     gradient of a stacked leaf is ever alive.  With replicated rows
     nothing is summed over the data axes;
  3a. for a dense or MoE model on a mesh whose ``model`` axis has more
     than one rank (``models.tp.tp_rank``), the step is the reference's
     partitioned one: the loss runs ``models.tp.forward_train`` and the
     vocabulary-parallel log-prob (the MTP loss's too).  A leaf that
     the TP body uses as its slice (``tp.train_roles`` "shard": the MLP,
     ``embed``, ``lm_head``, ``wq wk wv wo`` where the heads split, MLA's
     ``wq_b wk_b wv_b wo``, the expert leaves, the shared expert, the
     MTP ``proj``) keeps its ``model`` placement: its gather and its
     gradient's reduction run over the data axes only, and the gradient
     is this rank's slice's (an expert leaf's, its own experts').  A
     leaf used whole (the router, the norms, MLA's ``wq_a wkv_a``) is
     gathered whole as above; the ranks of a ``model`` row computed the
     same gradient of it, so nothing is summed over ``model``, except
     for a bias a rank holds whole and uses a slice of ("sum"), whose
     gradient is also summed over ``model``.  For every other family
     (whose TP is not ported) every leaf is gathered whole: the ranks
     of a ``model`` row run the same rows and hold the same gradients
     (under expert parallelism each holds its own experts' rows of an
     expert leaf, the rows its shard keeps);
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.backbone import StackShard
from repro_torch.models.sharding import _axis_size, _sizes, \
    activation_sharding, axis_names, batch_shardings, distribute, dp_axes, \
    groups, stacked_leaves, state_shardings
from repro_torch.models.tp import tp_rank, train_roles
from repro_torch.train.optimizer import AdamState, adam_update, \
    tree_leaves, tree_map, tree_unflatten
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


class _Gather(torch.autograd.Function):
    """A leaf's whole tensor from this rank's shard forward
    (``way.gather``); its gradient cut back to the shard backward
    (``way.reduce``)."""

    @staticmethod
    def forward(ctx, local, way):
        ctx.way = way
        return way.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.way.reduce(grad), None


class MeshWay:
    """How one leaf moves on ``mesh``, by its ``role``
    (``models.tp.train_roles``): its shard gathered from the ranks into
    the whole leaf, or, for a "shard" leaf, over the data axes only into
    its slice along ``model``; this rank's gradient of what it gathered
    summed over the data-parallel axes when the rows are ``split`` (and,
    for a "sum" leaf, over ``model`` too), then cut to the leaf's
    placements.  ``layer()`` is the way of one layer's slice of a
    stacked leaf, whose leading (layer) axis is never sharded."""

    def __init__(self, mesh, placements, split: bool, role: str = "whole"):
        self.mesh, self.placements, self.split = mesh, placements, split
        self.role = role
        self.gathered = [p if role == "shard" and a == "model"
                         else Replicate()
                         for a, p in zip(axis_names(mesh), placements)]

    def gather(self, local):
        out = DTensor.from_local(local.detach(), self.mesh, self.placements,
                                 run_check=False
                                 ).redistribute(self.mesh,
                                                self.gathered).to_local()
        return local.view_as(local) if out.data_ptr() == local.data_ptr() \
            else out

    def reduce(self, grad):
        dp = dp_axes(self.mesh)
        src = [Partial() if (self.split and a in dp)
               or (self.role == "sum" and a == "model") else g
               for a, g in zip(axis_names(self.mesh), self.gathered)]
        out = DTensor.from_local(grad, self.mesh, src, run_check=False
                                 ).redistribute(self.mesh,
                                                self.placements).to_local()
        if out.numel() < grad.numel() and out.untyped_storage().data_ptr() \
                == grad.untyped_storage().data_ptr():
            out = out.clone()       # a slice would keep the whole alive
        return out

    def layer(self) -> "MeshWay":
        return MeshWay(self.mesh, [Shard(p.dim - 1) if isinstance(p, Shard)
                                   else p for p in self.placements],
                       self.split, self.role)


def mesh_ways(mesh, placements, split: bool, roles=None) -> list:
    """A ``MeshWay`` a leaf, of placements ``placements``; ``roles`` the
    leaves' ``models.tp.train_roles`` on a tensor-parallel step, else
    None (every leaf gathered whole)."""
    roles = roles or ["whole"] * len(placements)
    return [MeshWay(mesh, pl, split, r) for pl, r in zip(placements, roles)]


def gathered_params(local, ways, stacked):
    """The params tree the loss runs on, from this rank's shards
    ``local`` (with grad): a leaf outside the layer stacks gathered now,
    a stacked leaf (``stacked``, per leaf) as a ``StackShard`` whose
    layers the model gathers one at a time.  Each gather's backward
    reduces its gradient to the shard.  ``ways`` holds a leaf's way
    (``gather``, ``reduce`` and ``layer()``, as ``MeshWay``)."""
    def placed(t, way, is_stacked):
        if not is_stacked:
            return _Gather.apply(t, way)
        one = way.layer()
        return StackShard(t, lambda x: _Gather.apply(x, one))
    return tree_unflatten(local, [placed(*a) for a in zip(
        tree_leaves(local), ways, stacked)])


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
    rows.  Every rank of the mesh calls it; the metrics are global.  A
    dense or MoE ``cfg`` on a ``model`` axis of more than one rank steps
    on its tensor-parallel shards (step 3a of the module's docstring)."""
    tp = tp_rank(cfg, mesh)
    loss_fn = make_loss_fn(cfg, rho=rho, clip_mode=clip_mode, kl_coef=kl_coef,
                           mtp_weight=mtp_weight, remat=remat, tp=tp)

    def train_step(state: TrainState, batch) -> tuple:
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch of {B} does not split into "
                             f"{accum_steps} microbatches")
        mb = B // accum_steps
        def to_local(tree):
            return tree_map(lambda t: t.to_local(), tree)

        placements = [t.placements for t in tree_leaves(state.params)]
        stacked = stacked_leaves(state.params)
        roles = None if tp is None else train_roles(cfg, mesh, state.params)
        local = to_local(state.params)
        local_g = None
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            rows, split = local_rows(micro, mesh)
            ways = mesh_ways(mesh, placements, split, roles)

            def sharded_loss(p, b):
                return loss_fn(gathered_params(p, ways, stacked), b)

            with activation_sharding(mesh, split_rows=split):
                (_, metrics), g = value_and_grad(sharded_loss, local, rows)
            g = tree_leaves(g)
            if accum_steps == 1:
                local_g = g
            else:
                if local_g is None:
                    local_g = [torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device) for t in g]
                for a, b in zip(local_g, g):
                    a.add_(b)
            del g
        if accum_steps > 1:
            for g in local_g:
                g.div_(accum_steps)
        gn = sharded_global_norm(local_g, placements, mesh)
        step_lr = lr_fn(state.opt.step) if lr_fn is not None else lr
        params, opt, opt_metrics = adam_update(
            local, tree_unflatten(state.params, local_g),
            AdamState(state.opt.step, to_local(state.opt.m),
                      to_local(state.opt.v)),
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

"""Dry run on the ``meta`` device: bytes a device, FLOPs a step and the
roofline terms of every (arch x input shape) combo on a production mesh,
for an NVIDIA H100 (the port of the JAX package's ``launch/dryrun.py``).

  python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh pod1 --out build/dryrun

The reference lowers and compiles each combo on 256 or 512 emulated TPU
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask, so it measures the step itself:

  * the params (or the train state) and the inputs are built on ``meta``
    (``init_params(..., device="meta")``, ``inputspecs``), placed on an
    ``AbstractMesh`` of the requested shape by ``models/sharding.py``'s
    rules (``params_shardings(mode="serve")``, ``state_shardings``,
    ``batch_shardings``, ``cache_shardings``): ``argument_bytes`` is the
    sum of one device's shards;
  * one device's step runs on ``meta`` as the port's code runs it, on its
    share of the batch: the sharded train step (``train/sharded.py``)
    through its own seam (``gathered_params``) with a ``meta`` gather:
    the leaves outside the layer stacks gathered up front, each stacked
    leaf one layer at a time inside that layer's work, ``forward_train``
    and its backward, each gather's gradient cut to the leaf's shard as
    the backward reaches it, and Adam on the shards (for a dense or MoE
    model on a ``model`` axis of more than one rank, the tensor-parallel
    step:
    ``models.tp.forward_train`` and the vocabulary-parallel log-prob, a
    split leaf gathered over the data axes only into its ``model`` slice,
    ``tp.train_roles``); for serving a dense or MoE
    model on a mesh whose ``model`` axis has more than one rank, the
    tensor-parallel step a rank runs (``models/tp.py``): its shards of
    ``sharding.tp_plan`` (the reference's serve shards, but MLA's
    attention whole where its heads do not split), its cache of its own
    GQA KV heads (all K where they do not split; MLA's whole latent),
    ``prefill`` or ``decode_step`` with ``tp``; for serving
    any other family, or on a ``model`` axis of one rank, the whole tree
    (those serve without tensor parallelism) and ``prefill`` or
    ``decode_step``.  ``meta`` tensors are not CUDA
    tensors, so every kernel takes its plain version
    (``kernels/dispatch.py``) and no kernel runs: the FLOPs include the
    plain attention's, over every key of a query block;
  * ``FlopCounterMode`` counts the FLOPs; a dispatch mode counts the bytes
    each operation reads and writes (eager and unfused: every operation
    reads its inputs and writes its outputs) and follows every storage
    from allocation to release, which gives the step's peak bytes
    (``temp_bytes`` is that peak above what the port holds as the step
    starts, ``held_bytes``: the arguments, except in the
    tensor-parallel serving step, where it is the rank's own shards,
    cache and rows, and ``argument_bytes`` stays the reference's
    shards); a
    ``saved_tensors_hooks`` sums the bytes autograd keeps for the
    backward when the forward ends (``saved_bytes``, the activation
    term): what the forward saves and, under ``remat_layers``, each
    checkpointed layer's inputs in place of what the layer saves.  A
    layer's recompute in the backward shows in the peak;
  * the collective bytes a device are the sharded step's own, each
    counted as its result's bytes and only over mesh axes of more than
    one rank: every gather of a sharded leaf (a stacked leaf's layer
    again in the backward under ``remat_layers``), each gradient's
    reduce-scatter (an all-reduce where a leaf is replicated over the
    data axes) once a microbatch, the global norm's and
    ``batch_total``'s all-reduces; in the tensor-parallel steps, every
    ``TPRank.all_reduce`` over ``model`` (serving: two of [rows, S, D] a
    layer where the attention's heads or projections split, one where
    they do not -- a MoE layer's experts and shared expert share one --,
    the embedding's one; training adds the backward's, one a
    ``TPRank.copy``, the head's included, MLA's three a layer and the
    experts' top-k weights', those of each layer's recompute under
    ``remat_layers``, and a sliced bias's gradient sum) and every
    ``TPRank.gather_partials``: where GQA's projections split and its
    heads do not, a layer's q, k and v columns, [rows, S, (H + 2 K) hd]
    whole (training adds the backward's gather of the core output's
    gradient, [rows, S, H hd]); in training the vocabulary-parallel
    log-prob's all-gather of the ranks' [rows, T, 3] partials (the MTP
    loss's too) and the MTP ``proj``'s [rows, S, D] (the serving steps
    return logits and do not sample, so no sampler partials).  The
    whole-tree serving steps count the gather of every
    sharded leaf.  The reference's ``collective_bytes``
    and ``_shape_bytes`` parse XLA's HLO text and have no counterpart
    here.

The port runs every layer eagerly, so the reference's two-compile
extrapolation from scan bodies (``_extrapolate``, ``counted_layers``) has
no twin: every layer is counted.  ``count_s`` (the meta run's seconds)
replaces ``compile_s`` and ``counted_layers``.  The reference's XLA-only
options (``--prefill-out-shardings``, ``--seq-parallel``, unrolled scans,
scan groups) have no twin either; ``--moe-mode`` takes ``gathered``: the
port's expert parallelism runs its collectives on a ``DeviceMesh``, which
a dry run does not have.  ``remat`` (the default) is the reference's
training baseline, ``remat_layers``: every layer's work under a
checkpoint, the backward recomputing one layer at a time; ``--no-remat``
turns it off.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, ShapeSpec, \
    param_count
from repro_torch.launch.inputspecs import META, input_specs
from repro_torch.models import backbone as bb
from repro_torch.models import sharding as shd
from repro_torch.models.tp import TPRank, steps_tp, train_roles
from repro_torch.models.sharding import AbstractMesh, Spec, _axis_size, \
    activation_sharding, batch_shardings, cache_shardings, dp_axes, \
    params_shardings, stacked_leaves, state_shardings
from repro_torch.train.optimizer import AdamState, adam_update, \
    tree_leaves, tree_map, tree_unflatten

# NVIDIA's data sheet for the H100 SXM part, one card
PEAK_FLOPS = 989e12        # NVIDIA H100 80GB HBM3, 700 W: dense bf16 FLOP/s
HBM_BW = 3.35e12           # NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes/s
NVLINK_BW = 450e9          # NVIDIA H100 80GB HBM3, 700 W: NVLink bytes/s a
                           # direction
HBM_BYTES_DEFAULT = 80e9   # NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes


def hbm_bytes() -> float:
    """One card's memory: the card's own where one is present, else the
    H100's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES_DEFAULT


def production_mesh(mesh_name: str = "pod1", mesh_shape=None):
    """An ``AbstractMesh``: ``mesh_shape`` as (data, model), else the
    production pod (16, 16) or two pods (2, 16, 16)."""
    if mesh_shape:
        return AbstractMesh(tuple(mesh_shape), ("data", "model"))
    if mesh_name == "pod2":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def n_ranks(mesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


# ------------------------------------------------------------ shards ---

def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype, device=META).element_size()
    for d in shape:
        n *= d
    return n


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` placed by ``spec``
    (which ``_fit`` keeps divisible)."""
    out = list(shape)
    for i, ax in enumerate(spec):
        out[i] //= _axis_size(mesh, ax)
    return tuple(out)


def tree_bytes(tree, shardings, mesh) -> int:
    """The bytes of one device's shards of ``tree``'s tensors."""
    return sum(_nbytes(shard_shape(t.shape, s, mesh), t.dtype)
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings))
               if torch.is_tensor(t))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _local_rows(B: int, mesh):
    """(rows a device runs, whether they are a share of split rows), as
    ``train/sharded.local_rows`` cuts a batch of ``B``."""
    spec = batch_shardings({"t": _meta((B, 1), torch.int32)}, mesh)["t"]
    if spec[0] is None:
        return B, False
    return B // _axis_size(mesh, tuple(dp_axes(mesh))), True


def _rows_of(batch, rows: int):
    return {k: _meta((rows,) + tuple(v.shape[1:]), v.dtype)
            for k, v in batch.items()}


def _dp_size(mesh) -> int:
    return _axis_size(mesh, tuple(dp_axes(mesh)))


# ------------------------------------------------------------ meters ---

class _Meter(TorchDispatchMode):
    """Bytes every operation reads and writes (views and metadata
    excluded), and the live bytes of every storage the step allocates,
    from allocation to release (``weakref.finalize`` on the storage,
    which outlives a Python tensor while autograd holds it).  ``live``
    starts at the arguments' bytes."""

    _NO_TRAFFIC = {torch.ops.aten.detach.default,
                   torch.ops.aten.empty.memory_format,
                   torch.ops.aten.empty_strided.default}

    def __init__(self, live: int, args=()):
        super().__init__()
        self.traffic = 0
        self.live = self.peak = live
        # the arguments' storages are in ``live`` already: an operation
        # that views or updates one in place allocates nothing
        self._seen: Dict[int, int] = {t.untyped_storage()._cdata: 0
                                      for t in args}

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int):
        if self._seen.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if not func.is_view and func not in self._NO_TRAFFIC:
            for t in pytree_leaves((args, kwargs)) + outs:
                if isinstance(t, torch.Tensor):
                    self.traffic += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def _saved_bytes(seen):
    """Sums the bytes of the storages autograd keeps for the backward,
    each once while it lives, those in ``seen`` (the params and their
    gathered copies) left out: what the forward saves and, where a layer
    runs under a checkpoint (``backbone._layer``), the layer's inputs,
    which its recompute reads.  Read it as the forward ends."""
    total = [0]
    real = bb.checkpoint

    def forget(key, n):
        seen.discard(key)
        total[0] -= n

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total[0] += st.nbytes()
            # a saved tensor that dies before the backward (its branch
            # dropped) is not kept, and a later storage may take its
            # address
            weakref.finalize(st, forget, st._cdata, st.nbytes())
        return t

    def kept(fn, *args, **kwargs):
        for t in pytree_leaves(args):
            if isinstance(t, torch.Tensor):
                pack(t)
        return real(fn, *args, **kwargs)

    bb.checkpoint = kept
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield total
    finally:
        bb.checkpoint = real


@contextlib.contextmanager
def _batch_total_meter(mesh, split: bool):
    """Stands in for ``sharding.reduce_from`` while a step runs on meta:
    every ``batch_total``/``batch_mean`` all-reduce over split rows is
    recorded (its result's bytes, where the data axes have more than one
    rank) and returns its input, as a world of one would."""
    counted = {"bytes": 0}
    over = split and _dp_size(mesh) > 1

    def split_groups():
        return list(dp_axes(mesh)) if over and shd._ACT_MESH["split_rows"] \
            else []

    def reduce_from(x, grps):
        if grps:
            counted["bytes"] += x.numel() * x.element_size()
        return x

    saved = shd._split_groups, shd.reduce_from
    shd._split_groups, shd.reduce_from = split_groups, reduce_from
    try:
        yield counted
    finally:
        shd._split_groups, shd.reduce_from = saved


# ------------------------------------------------------------- steps ---

class Lowered:
    """One device's step of a combo, built on meta and ready to run:
    ``run()`` drives it once (under the meters ``analyse`` installs) and
    returns the record's measured part."""

    def __init__(self, run, argument_bytes: int, rows: int, args,
                 held_bytes: int = None):
        self.run = run
        self.argument_bytes = argument_bytes
        self.rows = rows
        self.args = list(args)      # the tensors the step starts with
        # what the port holds as the step starts (the arguments, unless
        # the port's layout differs from the reference's shards)
        self.held_bytes = argument_bytes if held_bytes is None \
            else held_bytes


def _gathered(full_leaves, shard_leaves):
    """The whole tree a device runs on: a leaf whose shard is the whole
    leaf is used as it is, any other is gathered into a new tensor."""
    return [s if s.shape == f.shape else _meta(f.shape, f.dtype)
            for f, s in zip(full_leaves, shard_leaves)]


def _gather_bytes(full_leaves, shard_leaves) -> int:
    return sum(f.numel() * f.element_size()
               for f, s in zip(full_leaves, shard_leaves)
               if s.shape != f.shape)


class _MetaWay:
    """A leaf's gather and gradient reduction in the meta step, in place
    of ``train/sharded.MeshWay``: a leaf whose shard is what the step
    computes with is used as it is, any other is gathered into a new
    tensor (its storage in ``seen`` while it lives, as a param's is) and
    its all-gather counted: into the whole leaf, or, for a
    tensor-parallel "shard" leaf (``models.tp.train_roles``), over the
    data axes only into its ``model`` slice.  A gradient is cut to the
    shard, its reduce-scatter (sharded over the data axes) or all-reduce
    counted where the rows split over more than one rank
    (``reduce_dp``), and a "sum" leaf's all-reduce over ``model``."""

    def __init__(self, full, spec, mesh, reduce_dp, counted, seen,
                 role: str = "whole"):
        self.full, self.spec, self.mesh = tuple(full), spec, mesh
        self.reduce_dp, self.counted, self.seen = reduce_dp, counted, seen
        self.role = role
        self.shard = shard_shape(self.full, spec, mesh)
        keep = Spec(*(("model" if shd.on_axis(ax, "model") else None)
                      for ax in spec)) if role == "shard" \
            else Spec(*(None,) * len(spec))
        self.target = shard_shape(self.full, keep, mesh)

    def gather(self, local):
        if self.shard == self.target:
            return local.view_as(local)
        out = _meta(self.target, local.dtype)
        self.counted["all-gather"] += out.numel() * out.element_size()
        st = out.untyped_storage()
        self.seen.add(st._cdata)
        # a later storage may take a dead one's address
        weakref.finalize(st, self.seen.discard, st._cdata)
        return out

    def reduce(self, grad):
        if self.role == "sum":
            self.counted["all-reduce"] += grad.numel() * grad.element_size()
        if self.reduce_dp:
            dp = set(dp_axes(self.mesh))
            names = {a for ax in self.spec if ax is not None
                     for a in (ax if isinstance(ax, tuple) else (ax,))}
            self.counted["reduce-scatter" if names & dp else "all-reduce"] \
                += _nbytes(self.shard, grad.dtype)
        if self.shard == self.target:
            return grad
        return _meta(self.shard, grad.dtype)

    def layer(self) -> "_MetaWay":
        return _MetaWay(self.full[1:], Spec(*self.spec[1:]), self.mesh,
                        self.reduce_dp, self.counted, self.seen, self.role)


def _lower_train(cfg, shape, mesh, dtype, *, remat, accum_steps, kl_coef):
    from repro_torch.train.sharded import gathered_params
    from repro_torch.train.trainstep import init_train_state, make_loss_fn
    cfg = cfg.replace(remat_layers=remat)
    state = init_train_state(cfg, 0, dtype, device=META)
    batch = input_specs(cfg, shape, dtype)["batch"]
    if kl_coef:
        batch["ref_logp"] = _meta(batch["behavior_logp"].shape, torch.float32)
    st_sh = state_shardings(state, mesh)
    b_sh = batch_shardings(batch, mesh)
    arg = (tree_bytes(state.params, st_sh.params, mesh)
           + tree_bytes(state.opt.m, st_sh.opt.m, mesh)
           + tree_bytes(state.opt.v, st_sh.opt.v, mesh)
           + tree_bytes(batch, b_sh, mesh))

    def shards(tree, specs):
        return tree_map(lambda t, s: _meta(shard_shape(t.shape, s, mesh),
                                           t.dtype), tree, specs)

    params = shards(state.params, st_sh.params)
    m, v = shards(state.opt.m, st_sh.opt.m), shards(state.opt.v, st_sh.opt.v)
    B = shape.global_batch
    if B % accum_steps:
        raise ValueError(f"batch of {B} does not split into {accum_steps} "
                         "microbatches")
    rows, split = _local_rows(B // accum_steps, mesh)
    counted = {}
    tp, roles = None, None
    if steps_tp(cfg, _axis_size(mesh, "model")):
        tp = _meta_tp(cfg, mesh, counted)
        roles = train_roles(cfg, mesh, state.params)
    loss_fn = make_loss_fn(cfg, kl_coef=kl_coef, tp=tp)
    reduce_dp = split and _dp_size(mesh) > 1
    stacked = stacked_leaves(state.params)
    fulls = [t.shape for t in tree_leaves(state.params)]
    specs = tree_leaves(st_sh.params)
    roles = roles or ["whole"] * len(specs)
    shard_leaves = tree_leaves(params)
    micro = _rows_of(batch, rows)

    def run():
        counted.update({"all-gather": 0, "reduce-scatter": 0,
                        "all-reduce": 0})
        with _batch_total_meter(mesh, split) as bt:
            grads, saved = None, 0
            for _ in range(accum_steps):
                leaves = [t.detach().requires_grad_() for t in shard_leaves]
                seen = {t.untyped_storage()._cdata for t in leaves}
                ways = [_MetaWay(f, s, mesh, reduce_dp, counted, seen, r)
                        for f, s, r in zip(fulls, specs, roles)]
                with activation_sharding(mesh, split_rows=split):
                    with _saved_bytes(seen) as sv, torch.enable_grad():
                        loss, _ = loss_fn(gathered_params(
                            tree_unflatten(params, leaves), ways, stacked),
                            micro)
                    saved = max(saved, sv[0])
                    g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                del loss, leaves
                if accum_steps == 1:
                    grads = list(g)
                else:
                    if grads is None:
                        grads = [torch.zeros(t.shape, dtype=torch.float32,
                                             device=META) for t in g]
                    for a, b in zip(grads, g):
                        a.add_(b)
                del g
            if accum_steps > 1:
                for a in grads:
                    a.div_(accum_steps)
            gn = torch.sqrt(sum(torch.linalg.vector_norm(
                g, dtype=torch.float32).square() for g in grads))
            new, _, _ = adam_update(
                params, tree_unflatten(params, grads),
                AdamState(0, m, v), lr=1e-3, grad_norm=gn)
        out_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(new))
        colls = {k: n for k, n in counted.items() if n}
        if reduce_dp:
            colls["reduce-scatter"] = counted["reduce-scatter"]
            colls["all-reduce"] = counted["all-reduce"]
        norm = 4 * sum(1 for s in mesh.shape.values() if s > 1)
        if norm or bt["bytes"]:
            colls["all-reduce"] = colls.get("all-reduce", 0) + norm \
                + bt["bytes"]
        return {"output_bytes": out_bytes, "saved_bytes": saved,
                "collectives": colls}

    return Lowered(run, arg, rows, shard_leaves + tree_leaves(m)
                   + tree_leaves(v) + list(micro.values()))


def _meta_tp(cfg, mesh, counted):
    """The meta step's ``TPRank``: each all-reduce over ``model`` (a
    ``reduce`` forward, a ``copy`` backward) counted (its result's bytes)
    and run as the card runs it, into a new tensor of the input's shape;
    each all-gather over ``model`` (the log-prob's partials, the MTP
    ``proj``'s output, the attention's q, k and v columns and, backward,
    the core output's gradient) counted (its result's bytes) and stood
    in for by a new tensor."""
    from repro_torch.models.sharding import tp_splits

    class Counted(TPRank):
        def all_reduce(self, x):
            counted["all-reduce"] = counted.get("all-reduce", 0) \
                + x.numel() * x.element_size()
            return x.clone()

        def gather_partials(self, part):
            out = _meta((self.size,) + tuple(part.shape), part.dtype)
            counted["all-gather"] = counted.get("all-gather", 0) \
                + out.numel() * out.element_size()
            return out
    return Counted(size=_axis_size(mesh, "model"), rank=0,
                   **tp_splits(cfg, mesh))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def _lower_serve_tp(cfg, shape, mesh, dtype, p_full, arg, rows, local):
    """The tensor-parallel serving step of a rank of a dense or MoE
    model: its shards of ``tp_plan``, its cache (decode: ``K/m`` heads
    where the heads split, else all K, its rows, the whole ring), its
    rows of the batch, as the step starts (``held_bytes``);
    ``argument_bytes`` stays the reference's."""
    from repro_torch.models.serve import decode_step, init_cache, prefill
    from repro_torch.models.sharding import tp_plan
    plan = tp_plan(cfg, mesh, p_full)
    params = tree_map(lambda t, s: _meta(shard_shape(t.shape, s, mesh),
                                         t.dtype), p_full, plan)
    counted = {}
    tp = _meta_tp(cfg, mesh, counted)
    cache = None
    if shape.kind == "decode":
        cache = init_cache(tp.attn_cfg(cfg), rows, shape.seq_len, dtype,
                           device=META)
    held = _tensors(params) + _tensors(cache) + _tensors(local)
    held_bytes = sum(t.numel() * t.element_size() for t in held)

    def run():
        counted.clear()
        with torch.no_grad():
            if shape.kind == "prefill":
                logits, out_cache = prefill(params, cfg, local,
                                            cache_len=shape.seq_len,
                                            dtype=dtype, tp=tp)
                outs = [logits] + _tensors(out_cache)
            else:
                c = dict(cache, segments=[dict(g) for g in
                                          cache["segments"]])
                logits, _ = decode_step(params, cfg, c, local, tp=tp)
                outs = [logits]
        return {"output_bytes": sum(t.numel() * t.element_size()
                                    for t in outs),
                "saved_bytes": 0,
                "collectives": {k: n for k, n in counted.items() if n}}

    return Lowered(run, arg, rows, held, held_bytes=held_bytes)


def _lower_serve(cfg, shape, mesh, dtype):
    from repro_torch.models import init_params
    from repro_torch.models.serve import decode_step, init_cache, prefill
    p_full = init_params(cfg, 0, dtype, device=META)
    p_sh = params_shardings(p_full, mesh, mode="serve")
    specs = input_specs(cfg, shape, dtype)
    full_leaves = tree_leaves(p_full)
    p_shards = [_meta(shard_shape(t.shape, s, mesh), t.dtype)
                for t, s in zip(full_leaves, tree_leaves(p_sh))]
    arg = tree_bytes(p_full, p_sh, mesh)
    if shape.kind == "prefill":
        batch = specs["batch"]
        arg += tree_bytes(batch, batch_shardings(batch, mesh), mesh)
        rows, _ = _local_rows(shape.global_batch, mesh)
        local = _rows_of(batch, rows)
        cache_leaves = cache_shards = []
    else:
        cache, tokens = specs["cache"], specs["tokens"]
        c_sh = cache_shardings(cache, mesh)
        t_sh = batch_shardings({"t": tokens}, mesh)["t"]
        arg += tree_bytes(cache, c_sh, mesh) + _nbytes(
            shard_shape(tokens.shape, t_sh, mesh), tokens.dtype)
        rows = tokens.shape[0] // _axis_size(mesh, t_sh[0])
        # this device's rows of the cache; where the rules split them
        # finer (the sequence over 'data' at one row), the port, which
        # decodes a whole cache, gathers them
        local_cache = init_cache(cfg, rows, shape.seq_len, dtype,
                                 device=META)
        cache_leaves = [t for t in tree_leaves(local_cache)
                        if torch.is_tensor(t)]
        cache_shards = [_meta(shard_shape(t.shape, s, mesh), t.dtype)
                        for t, s in zip(tree_leaves(cache), tree_leaves(c_sh))
                        if torch.is_tensor(t)]
        local = _meta((rows, 1), tokens.dtype)
    if steps_tp(cfg, _axis_size(mesh, "model")):
        return _lower_serve_tp(cfg, shape, mesh, dtype, p_full, arg, rows,
                               local)

    def run():
        params = tree_unflatten(p_full, _gathered(full_leaves, p_shards))
        with torch.no_grad():
            if shape.kind == "prefill":
                logits, out_cache = prefill(params, cfg, local,
                                            cache_len=shape.seq_len,
                                            dtype=dtype)
                outs = [logits] + [t for t in tree_leaves(out_cache)
                                   if torch.is_tensor(t)]
            else:
                gathered = iter(_gathered(cache_leaves, cache_shards))
                cache = tree_map(lambda t: next(gathered)
                                 if torch.is_tensor(t) else t, local_cache)
                logits, _ = decode_step(params, cfg, cache, local)
                outs = [logits]
        gather = (_gather_bytes(full_leaves, p_shards)
                  + _gather_bytes(cache_leaves, cache_shards))
        return {"output_bytes": sum(t.numel() * t.element_size()
                                    for t in outs),
                "saved_bytes": 0,
                "collectives": {"all-gather": gather} if gather else {}}

    return Lowered(run, arg, rows, p_shards + cache_shards + tree_leaves(
        local))


def lower_combo(arch, shape_name, mesh, *, dtype=torch.bfloat16,
                moe_mode: str = "gathered", remat: bool = True,
                accum_steps: int = 1, kl_coef: float = 0.0):
    """The combo's config, input shape and one device's step on meta.
    ``arch`` is a registry name, ``llama31-8b`` or an ``ArchConfig``,
    ``shape_name`` a name of ``INPUT_SHAPES`` or a ``ShapeSpec``."""
    if moe_mode != "gathered":
        raise ValueError(
            f"moe_mode {moe_mode!r}: the port's expert parallelism runs its "
            "collectives on a DeviceMesh; the dry run counts 'gathered'")
    if isinstance(arch, ArchConfig):
        cfg = arch
    elif arch == "llama31-8b":      # the paper's policy, as the launcher
        from repro_torch.configs.llama_paper import LLAMA31_8B
        cfg = LLAMA31_8B
    else:
        cfg = configs.get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        lowered = _lower_train(cfg, shape, mesh, dtype, remat=remat,
                               accum_steps=accum_steps, kl_coef=kl_coef)
    elif shape.kind in ("prefill", "decode"):
        lowered = _lower_serve(cfg, shape, mesh, dtype)
    else:
        raise ValueError(shape.kind)
    return cfg, shape, lowered


def analyse(cfg, shape, lowered: Lowered, mesh) -> Dict:
    """Run ``lowered`` once under the meters; the reference's record,
    with the H100's roofline terms."""
    t0 = time.time()
    meter = _Meter(lowered.held_bytes, lowered.args)
    with FlopCounterMode(display=False) as fc, meter:
        got = lowered.run()
    count_s = time.time() - t0
    n_chips = n_ranks(mesh)
    flops = float(fc.get_total_flops())
    bytes_acc = float(meter.traffic)
    colls = got["collectives"]
    coll_total = sum(colls.values())
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll_total / NVLINK_BW,
    }
    total, active = param_count(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * active * tokens          # global useful FLOPs
    arg, held = lowered.argument_bytes, lowered.held_bytes
    peak = max(meter.peak, held)
    hbm = hbm_bytes()
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": list(mesh.shape.values()), "n_chips": n_chips,
        "count_s": round(count_s, 1),
        "rows_per_device": lowered.rows,
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_total,
        "collectives": colls,
        "argument_bytes": arg,
        "held_bytes": held,
        "output_bytes": got["output_bytes"],
        "temp_bytes": peak - held,
        "saved_bytes": got["saved_bytes"],
        "peak_bytes_per_device": peak,
        "hbm_bytes": hbm,
        "fits_hbm": peak < hbm,
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / max(flops * n_chips, 1.0),
    }


def run_combo(arch, shape_name, mesh_name, out_dir=None, variant="",
              mesh_shape=None, **kw):
    mesh = production_mesh(mesh_name, mesh_shape)
    cfg, shape, lowered = lower_combo(arch, shape_name, mesh, **kw)
    rec = analyse(cfg, shape, lowered, mesh)
    rec["mesh_name"] = mesh_name
    rec.update(remat=kw.get("remat", True),
               accum_steps=kw.get("accum_steps", 1),
               moe_mode=kw.get("moe_mode", "gathered"))
    line = (f"{cfg.name:24s} {shape.name:12s} {mesh_name}  "
            f"C={rec['roofline']['compute_s']:.4f}s "
            f"M={rec['roofline']['memory_s']:.4f}s "
            f"X={rec['roofline']['collective_s']:.4f}s "
            f"dom={rec['dominant'][:4]} "
            f"peak={rec['peak_bytes_per_device']/1e9:.1f}GB "
            f"useful={rec['useful_flops_ratio']:.2f} "
            f"count={rec['count_s']}s")
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"_{variant}" if variant else ""
        fname = f"{cfg.name}_{shape.name}_{mesh_name}{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _parse_mesh(s: str):
    """'8x32' -> (8, 32)."""
    return tuple(int(p) for p in s.lower().split("x")) if s else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--moe-mode", default="gathered",
                    choices=["gathered", "ep", "ep_shmap"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 8x32 (overrides --mesh pod1)")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        for arch, shape_name in configs.combos():
            try:
                run_combo(arch, shape_name, args.mesh, args.out,
                          remat=not args.no_remat)
            except Exception as e:  # noqa: BLE001 - report every combo
                failures.append((arch, shape_name, str(e)[:200]))
                print(f"FAIL {arch} {shape_name}: {e}", flush=True)
        if failures:
            print(f"{len(failures)} failures")
            sys.exit(1)
        print("ALL COMBOS COUNTED OK")
        return None
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    return run_combo(args.arch, args.shape, args.mesh, args.out,
                     remat=not args.no_remat, variant=args.variant,
                     moe_mode=args.moe_mode,
                     mesh_shape=_parse_mesh(args.mesh_shape),
                     accum_steps=args.accum_steps)


if __name__ == "__main__":
    main()

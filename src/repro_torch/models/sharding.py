"""Sharding rules: logical roles -> per-dimension mesh axes on the
production mesh (the port of the JAX package's ``models/sharding.py``).

Axis conventions (paper Sec. 4.3 / Table 3):
  * trainer: FSDP over the ``data`` axis + tensor parallel over ``model``
    (paper: FSDP/3D trainer); across pods plain data parallelism (batch
    sharded over ``pod``, params replicated).
  * generator/serve: tensor parallel over ``model`` only, params
    replicated over ``data``/``pod`` (paper: small-mp inference engine).

Every rule degrades gracefully: an axis is only sharded if its size
divides by the mesh axis (e.g. seamless's vocab 256206 % 16 != 0 ->
replicated).

A rule yields the reference's ``PartitionSpec`` as a ``Spec``: one entry
per tensor dim, ``None``, an axis name or a tuple of axis names (a tuple
of one name is the name, as ``PartitionSpec`` keeps it).  The rules read
only shapes and a mesh's axis sizes and names, so they run on ``meta``
tensors and on an ``AbstractMesh``, which has no ranks.  On a
``DeviceMesh``, ``to_placements`` turns a spec into DTensor placements and
``distribute`` builds the DTensors.

The reference's ``constrain_batch``, ``constrain_attn`` and
``constrain_experts`` are hints to XLA's sharding propagation and change
no number.  Nothing here is placed by propagation: the sharded train step
(``train/sharded.py``) and the expert-parallel MoE (``models/ffn.py``)
say where each tensor lives and which collective moves it, so the port
has no such hints.  ``activation_sharding`` installs the mesh that the
expert-parallel MoE reads and, with ``split_rows``, says that this rank
runs its share of the global batch's rows: the loss's normalisers, its
metrics and the MoE's load-balance means are then taken over the global
batch (``batch_total``, ``batch_mean``).
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor


class AbstractMesh:
    """A mesh's axis sizes and names with no ranks behind them, as
    ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``: all the rules
    read of a mesh."""

    def __init__(self, axis_sizes, axis_names):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, axis_sizes))


class Spec:
    """A PartitionSpec: per tensor dim, ``None``, a mesh axis name or a
    tuple of names.  Iterates, indexes and compares as that tuple; it is
    not a tuple itself, so a tree of specs has the structure of the tree
    it describes."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"Spec{self.parts!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def _sizes(mesh) -> dict:
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes[n]
        return out
    return sizes[name]


def on_axis(ax, name: str) -> bool:
    """Whether a spec entry ``ax`` (None, an axis name or a tuple of
    names) shards its dim over the mesh axis ``name``."""
    return ax == name or (isinstance(ax, tuple) and name in ax)


def _fit(mesh, shape, spec: Tuple) -> Spec:
    """Drop spec axes whose mesh size does not divide the dim."""
    fitted = []
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % _axis_size(mesh, ax) == 0:
            fitted.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                          else ax)
        else:
            fitted.append(None)
    return Spec(*fitted)


def dp_axes(mesh):
    """Data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ------------------------------------------------ the installed mesh ---

_ACT_MESH = {"mesh": None, "split_rows": False}


@contextlib.contextmanager
def activation_sharding(mesh, split_rows: bool = False):
    """Install ``mesh`` for the code run inside: the expert-parallel MoE
    reads it.  ``split_rows`` says the rows of the batch this rank runs
    are its share of the global batch, split over ``dp_axes(mesh)``.
    (The reference's ``seq_parallel`` is an XLA hint and has no twin.)"""
    prev = dict(_ACT_MESH)
    _ACT_MESH.update(mesh=mesh, split_rows=split_rows)
    try:
        yield
    finally:
        _ACT_MESH.update(prev)


def groups(mesh, axes) -> list:
    """The process groups of this rank along ``axes`` of ``mesh``."""
    return [mesh.get_group(a) for a in axes]


def all_reduce_groups(x, grps):
    """A new tensor: the sum of ``x`` over the ranks of each of ``grps``
    in turn (not differentiable; ``reduce_from`` and ``copy_to`` run it
    unless given their own)."""
    out = x.clone()
    for g in grps:
        dist.all_reduce(out, group=g)
    return out


class _ReduceFrom(torch.autograd.Function):
    """The sum ``all_reduce`` takes forward; the gradient passes through
    as it is (every rank computes the same value downstream, and this
    rank's share of the sum moves it one for one)."""

    @staticmethod
    def forward(ctx, x, all_reduce):
        return all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """The identity forward; the gradient summed by ``all_reduce``
    backward (each rank's use of the value feeds a different share of a
    sum that ``reduce_from`` takes)."""

    @staticmethod
    def forward(ctx, x, all_reduce):
        ctx.all_reduce = all_reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.all_reduce(grad), None


def _summing(grps, all_reduce):
    if all_reduce is not None:
        return all_reduce
    return (lambda x: all_reduce_groups(x, grps)) if grps else None


def reduce_from(x, grps=(), all_reduce=None):
    """The sum of ``x`` over the ranks of ``grps`` (or by ``all_reduce``,
    a callable from a tensor to a new one, its sum); its gradient as it
    is.  ``x`` itself with neither."""
    fn = _summing(grps, all_reduce)
    return x if fn is None else _ReduceFrom.apply(x, fn)


def copy_to(x, grps=(), all_reduce=None):
    """``x``; its gradient summed over the ranks of ``grps`` (or by
    ``all_reduce``, as ``reduce_from`` takes it)."""
    fn = _summing(grps, all_reduce)
    return x if fn is None else _CopyTo.apply(x, fn)


class _GatherFrom(torch.autograd.Function):
    """Every rank's ``x`` [.., n] joined along the last dim in rank order
    forward (``all_gather``: a tensor to the ranks' tensors stacked); the
    gradient this rank's columns of it backward (every rank computes the
    same value downstream, so the slice is the whole gradient of its
    ``x``)."""

    @staticmethod
    def forward(ctx, x, rank, all_gather):
        ctx.cols = slice(rank * x.shape[-1], (rank + 1) * x.shape[-1])
        return torch.movedim(all_gather(x), 0, -2).reshape(
            *x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols], None, None


def gather_from(x, rank: int, all_gather):
    """The ranks' ``x`` [.., n] joined along the last dim, [.., m n] (the
    output of a product split by columns made whole); its gradient this
    rank's ``n`` columns.  ``all_gather`` is a callable from a tensor to
    the ranks' tensors stacked in rank order."""
    return _GatherFrom.apply(x, rank, all_gather)


class _SplitTo(torch.autograd.Function):
    """``_GatherFrom``'s mirror: this rank's ``n / m`` columns of ``x``
    [.., n] forward; the ranks' gradients of their columns gathered whole
    backward (each rank's columns feed its own share of a sum that
    ``reduce_from`` takes, so its gradient holds only those columns)."""

    @staticmethod
    def forward(ctx, x, rank, size, all_gather):
        n = x.shape[-1] // size
        ctx.all_gather = all_gather
        return x[..., rank * n:(rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.movedim(ctx.all_gather(grad.contiguous()), 0, -2) \
            .reshape(*grad.shape[:-1], -1), None, None, None


def split_to(x, rank: int, size: int, all_gather):
    """This rank's ``n / size`` columns of ``x`` [.., n] (the input of a
    product split by rows); its gradient the ranks' columns' gradients
    joined in rank order, [.., n].  ``all_gather`` as ``gather_from``
    takes it."""
    return _SplitTo.apply(x, rank, size, all_gather)


def _split_groups() -> list:
    if not _ACT_MESH["split_rows"]:
        return []
    mesh = _ACT_MESH["mesh"]
    return groups(mesh, dp_axes(mesh))


def batch_total(x):
    """``x``, a sum over this rank's rows, summed over the global batch:
    over the data-parallel ranks when the rows are split, else ``x``
    itself.  Differentiable: every rank computes the same global loss from
    these totals, so the gradient reaches this rank's rows unchanged, and
    the sharded step sums the params' gradients over the data-parallel
    ranks afterwards."""
    return reduce_from(x, _split_groups())


def batch_mean(x, dims):
    """The mean of ``x`` over ``dims`` (batch rows first) of the global
    batch; ``x.mean(dims)`` when the rows are not split.  Split rows are
    an even share (the batch spec keeps the dp axes only where they
    divide B), so the global count is the local one times the dp size."""
    grps = _split_groups()
    if not grps:
        return x.mean(dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    n *= _axis_size(_ACT_MESH["mesh"], dp_axes(_ACT_MESH["mesh"]))
    return reduce_from(x.sum(dims), grps) / n


# ------------------------------------------------------------- rules ---

def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


# role rules: (regex on path, spec builder given ndim-without-stack-dim)
# fsdp = the FSDP shard axis ('data'), tp = 'model'.
_RULES = [
    (r"embed$",            lambda f, t: (t, None)),          # [V, D]
    (r"lm_head$",          lambda f, t: (None, t)),          # [D, V]
    (r"wq$|wk$|wv$|w_gate$|w_up$|w_in$|wq_b$|wk_b$|wv_b$|w_qkv$|w_if$|w_x$",
                           lambda f, t: (f, t)),             # [D, F]
    (r"wo$|w_down$|w_out$",
                           lambda f, t: (t, f)),             # [F, D]
    (r"wq_a$|wkv_a$",      lambda f, t: (f, None)),
    (r"w_router$",         lambda f, t: (None, None)),
    (r"proj$",             lambda f, t: (f, t)),             # mtp proj
    (r"conv_w$",           lambda f, t: (None, t)),
    (r"r_h$",              lambda f, t: (None, None, None)),
    (r"A_log$|D_skip$|dt_bias$",
                           lambda f, t: (t,)),
]

_MOE_RULES = [
    # stacked expert weights [E, D, F] / [E, F, D]: experts over model (EP)
    (r"moe/w_gate$|moe/w_up$", lambda f, t: (t, f, None)),
    (r"moe/w_down$",           lambda f, t: (t, None, f)),
]


def param_spec(path: str, leaf, mesh, *, mode: str, stacked: bool) -> Spec:
    """mode: 'train' (FSDP+TP) or 'serve' (TP only)."""
    fsdp = "data" if mode == "train" else None
    tp = "model"
    shape = _shape(leaf)
    core_shape = shape[1:] if stacked else shape
    spec: Optional[Tuple] = None
    for pat, builder in _MOE_RULES:
        if re.search(pat, path):
            spec = builder(fsdp, tp)
            break
    if spec is None:
        for pat, builder in _RULES:
            if re.search(pat, path):
                spec = builder(fsdp, tp)
                break
    if spec is None or len(spec) != len(core_shape):
        spec = (None,) * len(core_shape)
    if stacked:
        spec = (None,) + tuple(spec)
    return _fit(mesh, shape, spec)


def _is_stacked(path: str) -> bool:
    return bool(re.search(
        r"(^|/)(layers|moe_layers|dense_layers|mamba_layers|enc_layers|"
        r"dec_layers)/", path))


def stacked_leaves(params) -> list:
    """Per leaf of ``params`` in ``tree_leaves`` order, whether it is a
    leaf of a layer stack (its leading axis the layers')."""
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(_map_with_path(
        lambda path, _: _is_stacked(_path_str(path)), params))


def params_shardings(params, mesh, mode: str = "train"):
    """A tree of ``Spec`` in the structure of ``params``."""
    def spec_of(path, leaf):
        ps = _path_str(path)
        return param_spec(ps, leaf, mesh, mode=mode, stacked=_is_stacked(ps))
    return _map_with_path(spec_of, params)


def batch_shardings(batch, mesh):
    """Shard the leading (batch) dim over the data-parallel axes."""
    dp = dp_axes(mesh)

    def spec_of(_, leaf):
        shape = _shape(leaf)
        spec = (dp,) + (None,) * (len(shape) - 1)
        return _fit(mesh, shape, spec)
    return _map_with_path(spec_of, batch)


def cache_shardings(cache, mesh):
    """KV/state caches: batch dim over dp; if batch unshardable (B=1 long
    context), shard the cache sequence dim over 'data' instead."""
    dp = dp_axes(mesh)
    dp_size = _axis_size(mesh, tuple(dp))

    def spec_of(path, leaf):
        ps = _path_str(path)
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim == 0 or "pos" in ps:
            return Spec()
        # stacked [L, B, Sc, ...] for kv/ckv; states [L, B, ...]
        if re.search(r"/(k|v|ckv|krope)$", ps) and ndim >= 3:
            if shape[1] % dp_size == 0:
                spec = (None, dp, None) + (None,) * (ndim - 3)
            elif shape[2] % _axis_size(mesh, "data") == 0:
                spec = (None, None, "data") + (None,) * (ndim - 3)
            else:
                spec = (None,) * ndim
            return _fit(mesh, shape, spec)
        if ndim >= 2:
            # recurrent states [L, B, ...] or [B, ...]
            bdim = 1 if ndim >= 3 else 0
            spec = [None] * ndim
            if shape[bdim] % dp_size == 0:
                spec[bdim] = dp
            return _fit(mesh, shape, tuple(spec))
        return Spec()
    return _map_with_path(spec_of, cache)


def state_shardings(state, mesh):
    """TrainState: params + adam moments share the param rules; step
    scalar replicated."""
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.trainstep import TrainState
    return TrainState(
        params=params_shardings(state.params, mesh, mode="train"),
        opt=AdamState(step=Spec(),
                      m=params_shardings(state.opt.m, mesh, mode="train"),
                      v=params_shardings(state.opt.v, mesh, mode="train")))


# --------------------------------------------------------- DTensors ---

def to_placements(mesh: DeviceMesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d names, ``Replicate()`` on the others.  A
    dim sharded over several mesh dims splits over them major to minor,
    as DTensor orders mesh dims, so the spec's tuple must name them in
    the mesh's order."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} names mesh axes {axes} out of "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def place(t, mesh: DeviceMesh, spec, *, shared: bool = True):
    """This rank's shard of ``t`` placed by ``spec``, as a DTensor that
    holds on to no more than its shard.  A shard that is a view of ``t``
    is copied: a slice of it would keep all of ``t`` alive, and the whole
    of it (replicated) is copied too while ``shared``, as the caller
    keeps ``t`` (a state's moments are updated in place)."""
    pl = to_placements(mesh, spec)
    d = distribute_tensor(t, mesh, pl, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr() \
            and (shared or local.numel() < t.numel()):
        d = DTensor.from_local(local.clone(), mesh, pl, run_check=False)
    return d


def distribute(tree, mesh: DeviceMesh, shardings):
    """DTensors of ``tree``'s leaves placed by ``shardings`` (a tree of
    ``Spec`` in its structure).  Every rank passes the same full tree and
    keeps a copy of its own shard of each leaf: nothing is sent, and
    nothing holds on to ``tree``."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t, s: place(t, mesh, s), tree, shardings)


# ----------------------------------------------- tensor parallelism ---

_ATTN_LEAF = re.compile(r"(^|/)attn/(wq|wk|wv|wo|wq_b|wk_b|wv_b)$")


def tp_splits(cfg, mesh) -> dict:
    """Which products of a dense or MoE model a rank of ``mesh``'s
    ``model`` axis (of size m) computes a 1/m share of: ``heads`` when
    ``n_kv_heads % m == 0`` (the reference's ``constrain_attn``; MLA,
    whose heads share one latent, when ``n_heads % m == 0``): the rank
    runs its heads' core; ``proj`` when GQA's heads do not split but
    ``_fit`` splits ``wq wk wv`` by columns and ``wo`` by rows (``H hd``
    and ``K hd`` divide by m): the rank computes its columns of q, k and
    v, gathers them whole, runs the core whole (``constrain_attn``'s
    replicated q, k, v) and its rows of ``wo``; else attention runs whole
    on every rank (MLA's heads, and a GQA whose ``K hd`` m does not
    divide).  ``ffn`` and ``vocab`` where ``_fit`` splits the MLP's
    columns (``d_ff % m == 0``) and the vocabulary (``vocab % m == 0``);
    for the MoE family ``experts`` where ``_fit`` splits the experts
    (``n_experts % m == 0``), ``shared`` where it splits the shared
    expert's columns, and ``mtp`` where it splits the MTP head's ``proj``
    by columns (``d_model % m == 0``).  What stays whole is computed
    whole, with no collective."""
    m = _axis_size(mesh, "model")
    mla = cfg.attn_kind == "mla"
    heads = (cfg.n_heads if mla else cfg.n_kv_heads) % m == 0
    out = {"heads": heads, "ffn": cfg.d_ff % m == 0,
           "vocab": cfg.vocab % m == 0, "experts": False, "shared": False,
           "mtp": False,
           "proj": not (heads or mla) and (cfg.n_heads * cfg.hd) % m == 0
           and (cfg.n_kv_heads * cfg.hd) % m == 0}
    if cfg.family == "moe":
        mo = cfg.moe
        out.update(experts=mo.n_experts % m == 0,
                   shared=bool(mo.n_shared) and (
                       mo.n_shared * (mo.d_expert or cfg.d_ff)) % m == 0,
                   mtp=bool(cfg.mtp) and cfg.d_model % m == 0)
    return out


def tp_plan(cfg, mesh, params=None):
    """A tree of ``Spec`` in the structure of the dense or MoE ``params``
    (built on ``meta`` when None): each leaf's slice along ``model`` that
    a tensor-parallel rank holds and computes with.  It is
    ``params_shardings(mode="serve")`` -- the column products ``wq wk wv
    w_gate w_up w_in`` (MLA's ``wq_b wk_b wv_b``, the MTP head's
    ``proj``) split by columns, the row products ``wo w_down`` by rows,
    the expert leaves [L, E, ...] by experts, ``embed`` and ``lm_head``
    by the vocabulary, each only where ``_fit`` divides; MLA's ``wq_a
    wkv_a``, the router and every norm whole -- except that the
    attention products stay whole where ``tp_splits`` gives attention
    neither ``heads`` nor ``proj`` (MLA's heads that m does not divide).
    Biases stay whole, as the rules leave them; a rank slices a bias
    where its heads split."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"{cfg.name}: tensor parallelism covers the "
                         f"dense and MoE families, not {cfg.family!r}")
    if params is None:
        from repro_torch.models import init_params
        params = init_params(cfg, 0, torch.bfloat16, device="meta")
    specs = params_shardings(params, mesh, mode="serve")
    splits = tp_splits(cfg, mesh)
    if splits["heads"] or splits["proj"]:
        return specs
    return _map_with_path(
        lambda path, s: Spec(*(None,) * len(s))
        if _ATTN_LEAF.search(_path_str(path)) else s, specs)


def shard_of(t, spec, mesh: DeviceMesh):
    """The block of ``t`` that ``spec`` gives this rank of ``mesh`` (a view;
    major axis first within a tuple), as DTensor's ``Shard`` cuts it
    where the dim divides."""
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        i, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size = mesh.size(mesh.mesh_dim_names.index(a))
            i, n = i * size + mesh.get_local_rank(a), n * size
        w = t.shape[d] // n
        idx.append(slice(i * w, (i + 1) * w))
    return t[tuple(idx)]


class Shardings:
    """A tree of ``Spec`` on a ``DeviceMesh``: the port's twin of the
    reference's tree of ``NamedSharding``, a target of
    ``ddma_weight_sync``."""

    __slots__ = ("mesh", "specs")

    def __init__(self, mesh: DeviceMesh, specs):
        self.mesh, self.specs = mesh, specs


def rank_device(device_type: str) -> torch.device:
    """This rank's device of ``device_type``: its current card, or the
    CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def local_shard(t, spec, mesh: DeviceMesh):
    """This rank's block of the leaf ``t`` under ``spec`` as a plain tensor
    on its device of ``mesh`` that holds on to nothing else of ``t``: cut
    from a whole tensor (nothing is sent), or redistributed from a
    DTensor of ``mesh`` (a collective of its ranks)."""
    if isinstance(t, DTensor):
        if t.device_mesh != mesh:
            raise ValueError("a DTensor of another mesh crosses meshes only "
                             "with src=")
        return t.redistribute(mesh, to_placements(mesh, spec)).to_local()
    local = shard_of(t, spec, mesh).to(rank_device(mesh.device_type),
                                       non_blocking=True)
    if local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        local = local.clone()
    return local.contiguous()


def tp_shard(params, mesh: DeviceMesh, specs):
    """This rank's tensor-parallel shards of ``params`` (whole tensors or
    DTensors of ``mesh``): each leaf's block under ``specs`` (``tp_plan``),
    as ``local_shard`` cuts it."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t, s: local_shard(t, s, mesh), params, specs)

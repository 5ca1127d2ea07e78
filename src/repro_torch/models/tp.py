"""Tensor parallelism of the dense and MoE families over a mesh's
``model`` axis: the reference's partitioned serving and training steps
(its ``param_spec`` in ``mode="serve"`` and ``mode="train"`` and
``constrain_attn``, which XLA partitions), written out for a rank of a
``DeviceMesh``.

A rank of a ``model`` axis of m ranks holds its shard of each leaf
(``sharding.tp_plan``, ``tp_shard``) and computes:

* GQA attention on its ``H/m`` query and ``K/m`` KV heads where ``K % m
  == 0``: the column products ``wq wk wv`` give its heads, the row
  product ``wo`` a partial sum that one all-reduce over the ``model``
  group completes; its KV cache holds its own heads.  Where ``K % m !=
  0`` (``proj``) it holds the same shards of ``wq wk wv wo``, as the
  reference's ``param_spec`` stores them whatever the head count: its
  columns of the three products are joined and gathered whole over the
  ranks in one all-gather (``TPRank.gather_cols``), the core runs whole
  on every rank (the reference's ``constrain_attn`` replicates q, k and
  v there) over a cache of all K heads, and its rows of ``wo`` take its
  columns of the core's output (``TPRank.row``, whose gradient the
  ranks' columns gathered whole) into a partial sum, one all-reduce;
* MLA attention on its ``H/m`` heads where ``n_heads % m == 0``: the
  whole ``wq_a wkv_a`` and their norms give every rank the same query
  latent, latent c_kv and rotated key (the latent cache is whole on
  every rank), its columns of ``wq_b wk_b wv_b`` its heads, its rows of
  ``wo`` a partial sum, one all-reduce; whole elsewhere;
* the MLP on its ``d_ff/m`` columns: ``w_gate w_up`` (or ``w_in``) by
  columns, ``w_down`` by rows, then one all-reduce, then ``b_down``;
* a MoE layer on its ``E/m`` experts (``ffn.moe_rank``): every row
  routed over all E experts by the whole fp32 router, dispatched to its
  own at the reference's capacity, so it drops what the gathered path
  drops; the shared expert on its columns adds its partial to the
  experts', then one all-reduce for both.  The aux loss is the whole
  router's, the same on every rank;
* the MTP head's ``proj`` on its ``D/m`` columns, whose output is
  gathered whole over the ranks (``TPRank.gather``) before the MTP
  block, a decoder layer like the others;
* a vocabulary-parallel embedding (a masked lookup of its ``V/m`` rows,
  then an all-reduce: one row is the token's, the others add zeros, so
  the sum is exact) and head (its ``[rows, V/m]`` logits, never
  gathered: ``TPRank.sample`` draws through
  ``dispatch.sample_vocab_parallel``).

A product whose leaf ``_fit`` keeps whole (a dim that m does not divide)
is computed whole with no collective.  Rows split over the data axes
where ``batch_shardings`` splits them (``TPRank.for_rows``); the sampler
keys each row's noise by its global row.  The layers' bodies are the
one-card ones (``attention.gqa_forward``, ``gqa_decode``,
``mla_forward``, ``mla_decode``, ``ffn.mlp_forward``, the local-experts
MoE, and the head's product) on local shapes: a local config holds the
rank's heads, and GQA takes the rank's column and row products as
hooks (``products=``).  A layer is two all-reduces of [rows, S, D]
where the heads or the projections split (and one all-gather of [rows,
S, (H + 2 K) hd] where only the projections do), and the embedding one
more.  The paged engine on a mesh is not here (a later slice); the
other families serve on the whole tree.

``forward_train`` is the teacher-forced forward on the same shards and
layer bodies with autograd, the reference's partitioned training step:
the input of every column product (q/k/v where the heads or the
projections split, MLA's query latent, c_kv and rotated key, the MLP's
and the experts' first products with the top-k weights, the MTP
``proj``, the head) passes through ``TPRank.copy`` (the identity; its
gradient summed over the ``model`` group; serving, without grad, runs
it as the identity), the
output of every row product (``wo``, ``w_down``, the experts') and the
embedding through ``TPRank.reduce`` (the sum; its gradient as it is).
The head's logits (the MTP head's too) stay this rank's vocabulary
slice, scored by ``TPRank.token_logprob``
(``dispatch.token_logprob_vocab_parallel``): every rank of a ``model``
row then holds the same residual stream, the same loss and the same
gradients of the leaves it holds whole, and its own slice's gradients
of the split leaves.  Under ``cfg.remat_layers`` a layer's recompute
runs its forward's collectives again.  Every all-reduce of the
``model`` group goes through ``TPRank.all_reduce`` and every all-gather
(the log-prob's partials, the MTP ``proj``'s output, GQA's q, k and v
columns forward and its core output's gradient backward) through
``TPRank.gather_partials``, the seams the dry run and the checks count
at.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models import ffn as ffnmod
from repro_torch.models import serve
from repro_torch.models.common import norm
from repro_torch.models.sharding import _axis_size, _map_with_path, \
    _path_str, all_reduce_groups, copy_to, dp_axes, gather_from, on_axis, \
    reduce_from, split_to, tp_plan, tp_splits


@dataclasses.dataclass(frozen=True)
class TPRank:
    """A rank of a ``model`` axis of ``size`` ranks, its index ``rank``
    there, which products split (``sharding.tp_splits``; ``proj``: GQA's
    projections where its heads do not), its ``model`` group, and the
    global row of its first row (``row0``, set by
    ``for_rows``).  ``dp`` lists (group, size, index) of each data axis,
    major first, over which its rows split."""

    size: int
    rank: int
    heads: bool
    ffn: bool
    vocab: bool
    experts: bool = False
    shared: bool = False
    mtp: bool = False
    proj: bool = False
    group: Any = None
    dp: tuple = ()
    row0: int = 0

    def all_reduce(self, x):
        """A new tensor: the sum of ``x`` over the ranks of the ``model``
        group (not differentiable; ``reduce`` and ``copy`` call it)."""
        return all_reduce_groups(x, [self.group])

    def reduce(self, x):
        """The sum of ``x`` over the ranks of the ``model`` group; the
        gradient passes as it is."""
        return reduce_from(x, all_reduce=self.all_reduce)

    def copy(self, x):
        """``x``; its gradient summed over the ranks of the ``model``
        group."""
        return copy_to(x, all_reduce=self.all_reduce)

    def gather_partials(self, part):
        """Every rank's ``part`` of the ``model`` group, stacked in rank
        order (not differentiable; the log-prob's partials and ``gather``
        call it: every all-gather over ``model``)."""
        return dispatch.all_gather_stacked(part, self.group)

    def gather(self, x):
        """The ranks' ``x`` [.., n] joined along the last dim in rank
        order; its gradient this rank's columns."""
        return gather_from(x, self.rank, self.gather_partials)

    def gather_cols(self, x, ws):
        """``[x @ w for w in ws]`` whole from this rank's columns of each
        ``w``: its products joined, one ``gather`` of them, each cut out
        of every rank's block and joined in rank order."""
        parts = [x @ w for w in ws]
        ns = [t.shape[-1] for t in parts]
        whole = self.gather(torch.cat(parts, dim=-1)).unflatten(
            -1, (self.size, sum(ns)))
        return [t.flatten(-2) for t in whole.split(ns, dim=-1)]

    def row(self, y, w):
        """This rank's partial ``y @ w`` of a whole ``y`` [.., n]: its
        ``n/m`` columns of y times its rows of ``w``; y's gradient the
        ranks' columns' gradients gathered whole (``gather``'s mirror,
        ``split_to``)."""
        return split_to(y, self.rank, self.size, self.gather_partials) @ w

    def attn_products(self):
        """The (cols, row) products of ``attention.gqa_forward`` and
        ``gqa_decode`` where the projections split and the core runs whole
        (``proj``); the one-card products elsewhere."""
        return (self.gather_cols, self.row) if self.proj \
            else attn.ONE_CARD

    def token_logprob(self, logits, tokens, n_valid=None):
        """``dispatch.token_logprob`` of this rank's logits: of its
        vocabulary slice [B, T, V/m] merged over the ``model`` group, or of
        the whole rows where the vocabulary stays whole."""
        if self.vocab:
            return dispatch.token_logprob_vocab_parallel(
                logits, tokens, self.rank * logits.shape[-1], self.group,
                n_valid, gather=self.gather_partials)
        return dispatch.token_logprob(logits, tokens, n_valid)

    def attn_cfg(self, cfg):
        """``cfg`` with this rank's heads where they split."""
        if not self.heads:
            return cfg
        return cfg.replace(n_heads=cfg.n_heads // self.size,
                           n_kv_heads=cfg.n_kv_heads // self.size,
                           head_dim=cfg.hd)

    def sample(self, logits, key, temperature: float):
        """(tokens, log mu) of the rows whose logits this rank holds: its
        vocabulary slice merged over the ``model`` group, or the whole
        row where the vocabulary stays whole."""
        if self.vocab:
            return dispatch.sample_vocab_parallel(
                logits, key, temperature, self.rank * logits.shape[1],
                self.group, row0=self.row0)
        return dispatch.sample(logits, key, temperature, row0=self.row0)

    def for_rows(self, B: int):
        """(this rank's rows of a batch of ``B`` as a slice, this rank
        with their ``row0``): a share over the data axes where ``B``
        divides by their size, as ``batch_shardings`` splits it, else
        every row."""
        n = 1
        for _, size, _ in self.dp:
            n *= size
        if n == 1 or B % n:
            return slice(0, B), dataclasses.replace(self, row0=0)
        i = 0
        for _, size, idx in self.dp:
            i = i * size + idx
        rows = B // n
        return slice(i * rows, (i + 1) * rows), \
            dataclasses.replace(self, row0=i * rows)

    def gather_rows(self, x, B: int):
        """``x`` [rows, ...] of this rank's rows (``for_rows(B)``) whole
        over the data axes; ``x`` itself where the rows did not split."""
        if x.shape[0] == B:
            return x
        for grp, size, _ in reversed(self.dp):
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=grp)
            x = torch.cat(parts)
        return x


def steps_tp(cfg, model: int) -> bool:
    """Whether a rank of ``cfg`` on a ``model`` axis of ``model`` ranks
    computes tensor-parallel: a dense or MoE model on more than one rank
    (every other family, and a ``model`` axis of one rank, run on the
    whole tree)."""
    return cfg.family in ("dense", "moe") and model > 1


def tp_rank(cfg, mesh):
    """This rank's ``TPRank`` on ``mesh`` (a ``DeviceMesh``) where
    ``steps_tp``; None otherwise."""
    if mesh is None or not steps_tp(cfg, _axis_size(mesh, "model")):
        return None
    names = mesh.mesh_dim_names
    dp = tuple((mesh.get_group(a), mesh.size(names.index(a)),
                mesh.get_local_rank(a)) for a in dp_axes(mesh))
    return TPRank(size=_axis_size(mesh, "model"),
                  rank=mesh.get_local_rank("model"),
                  group=mesh.get_group("model"), dp=dp,
                  **tp_splits(cfg, mesh))


# ----------------------------------------------------------- layers ---

def embed(params, cfg, tokens, tp: TPRank):
    """The token embeddings [.., D]: this rank's ``V/m`` rows looked up
    where the token is theirs, zeros elsewhere, summed over the ranks."""
    if not tp.vocab:
        return bb._embed(params, cfg, tokens)
    E = params["embed"]
    n = E.shape[0]
    local = tokens.long() - tp.rank * n
    inside = ((local >= 0) & (local < n))[..., None]
    x = torch.where(inside, E[local.clamp(0, n - 1)],
                    torch.zeros((), dtype=E.dtype, device=E.device))
    return tp.reduce(x)


def _attn_params(p, cfg, tp: TPRank):
    """A layer's attention leaves as this rank uses them: its bias slices
    where the heads split (the rules keep biases whole)."""
    if not (tp.heads and cfg.bias):
        return p
    out = dict(p)
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        n = p[w].shape[-1]
        out[b] = p[b][..., tp.rank * n:(tp.rank + 1) * n]
    return out


def _attn_in(p, x, cfg, tp: TPRank):
    """norm(x), the attention's input: through ``TPRank.copy`` where the
    heads or the projections split (the identity forward, so serving,
    which runs without grad, computes as before)."""
    h = norm(x, p["ln1"], cfg.norm)
    return tp.copy(h) if tp.heads or tp.proj else h


def _attn_out(y, tp: TPRank):
    return tp.reduce(y) if tp.heads or tp.proj else y


def _moe(mp, h, cfg, tp: TPRank):
    """The MoE layer of norm(x) ``h`` on this rank's experts and shared
    expert columns, one ``TPRank.reduce`` for both (``ffn.moe_rank``):
    (y, aux).  Where the experts stay whole every rank computes them
    whole, and the shared expert alone is summed over the ranks where
    its columns split."""
    if tp.experts:
        lo = tp.rank * mp["w_gate"].shape[0]
        return ffnmod.moe_rank(mp, h, cfg, mp, lo, tp.copy, tp.reduce,
                               shared_split=tp.shared)
    y, aux = ffnmod.moe_rank({k: v for k, v in mp.items() if k != "shared"},
                             h, cfg, mp, 0, _same, _same)
    if "shared" in mp:
        y = y + (ffnmod.mlp_forward(mp["shared"], tp.copy(h), "silu_gated",
                                    reduce=tp.reduce) if tp.shared
                 else ffnmod.mlp_forward(mp["shared"], h, "silu_gated"))
    return y, aux


def _same(x):
    return x


def _ffn(p, x, cfg, tp: TPRank):
    """(x + the FFN of norm(x) on this rank's share, the MoE aux loss):
    the MLP on its columns, summed over the ranks where they split (its
    input through ``TPRank.copy`` there), or the MoE layer (``_moe``)."""
    h = norm(x, p["ln2"], cfg.norm)
    if "moe" in p:
        y, aux = _moe(p["moe"], h, cfg, tp)
        return x + y, aux
    mp = p["mlp"]
    if not tp.ffn:
        return x + ffnmod.mlp_forward(mp, h, cfg.act, bias=cfg.bias), 0.0
    if cfg.bias:
        n = mp["w_down"].shape[-2]
        mp = dict(mp, b_up=mp["b_up"][..., tp.rank * n:(tp.rank + 1) * n])
    return x + ffnmod.mlp_forward(mp, tp.copy(h), cfg.act, bias=cfg.bias,
                                  reduce=tp.reduce), 0.0


def head_logits(params, cfg, x, tp: TPRank):
    """This rank's logits of x [.., D]: its vocabulary slice [.., V/m]
    (the head's input through ``TPRank.copy``), or the whole row where
    the vocabulary stays whole."""
    x = norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (tp.copy(x) if tp.vocab else x) @ head


def _check(cfg, cache=None):
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"{cfg.name}: tensor parallelism covers the dense "
                         f"and MoE families, not {cfg.family!r}")
    if cache is not None and "page_table" in cache:
        raise NotImplementedError("the paged layout on a tensor-parallel "
                                  "mesh is not ported")


def _attn(p, x, cfg, acfg, window, tp: TPRank):
    """(x + attention on this rank's heads, what its cache holds): GQA's
    K/m heads, or MLA's H/m heads over the whole latent (c_kv, k_rope),
    which every rank computes from the whole ``wq_a wkv_a``; GQA's core
    whole between this rank's columns of ``wq wk wv`` and rows of ``wo``
    where only the projections split; whole elsewhere."""
    if cfg.attn_kind == "mla":
        y, kv = attn.mla_forward(p["attn"], norm(x, p["ln1"], cfg.norm),
                                 acfg, copy=tp.copy if tp.heads else None)
    else:
        y, kv = attn.gqa_forward(_attn_params(p["attn"], cfg, tp),
                                 _attn_in(p, x, cfg, tp), acfg,
                                 window=window,
                                 products=tp.attn_products())
    return x + _attn_out(y, tp), kv


def _layer(p, x, cfg, acfg, window, tp: TPRank):
    """One decoder layer on this rank's share: (x, the MoE aux loss, what
    the cache holds)."""
    x, kv = _attn(p, x, cfg, acfg, window, tp)
    x, aux = _ffn(p, x, cfg, tp)
    return x, aux, kv


def prefill(params, cfg, batch, cache_len: int, dtype, tp: TPRank):
    """``serve.prefill`` on this rank's shard: (its logits [B, V/m] of the
    last position, or [B, V] where the vocabulary stays whole, and its
    cache, which holds its ``K/m`` heads where GQA's heads split, MLA's
    whole latent on every rank)."""
    _check(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params, cfg, tokens, tp)
    acfg = tp.attn_cfg(cfg)
    cache = serve.init_cache(acfg, B, cache_len, dtype, device=x.device)
    kv_segs = []
    for key, n, off in bb.layer_stacks(cfg):
        layers = bb.unstack(params[key], n)
        for i, j, w in bb._segment_windows(cfg, n, off):
            kvs = []
            for p in layers[i:j]:
                x, _, kv = _layer(p, x, cfg, acfg, w, tp)
                kvs.append(kv)
            kv_segs.append(tuple(torch.stack(t) for t in zip(*kvs)))
    for seg, kvs in zip(cache["segments"], kv_segs):
        serve._write_seg(seg, kvs, start=0)
    cache["pos"] = S
    return head_logits(params, cfg, x[:, -1], tp), cache


def decode_step(params, cfg, cache, tokens, tp: TPRank):
    """``serve.decode_step`` on this rank's shard and cache: (its logits,
    as ``prefill`` returns them, and the cache advanced in place)."""
    _check(cfg, cache)
    pos = cache["pos"]
    x = embed(params, cfg, tokens, tp)
    acfg = tp.attn_cfg(cfg)
    for (layers, w), seg in zip(serve.stack_segments(params, cfg),
                                cache["segments"]):
        for li, p in enumerate(layers):
            if "ckv" in seg:
                y = attn.mla_decode(p["attn"], norm(x, p["ln1"], cfg.norm),
                                    seg["ckv"][li], seg["krope"][li],
                                    seg["slot_pos"], pos, acfg)
            else:
                y = attn.gqa_decode(_attn_params(p["attn"], cfg, tp),
                                    _attn_in(p, x, cfg, tp), seg["k"][li],
                                    seg["v"][li], seg["slot_pos"], pos, acfg,
                                    window=w, products=tp.attn_products())
            x, _ = _ffn(p, x + _attn_out(y, tp), cfg, tp)
    cache["pos"] = pos + 1
    return head_logits(params, cfg, x[:, -1], tp), cache


# --------------------------------------------------------- training ---

def _train_layer(p, x, cfg, acfg, window, tp: TPRank):
    """One decoder layer for training: (x, the MoE aux loss)."""
    x, aux, _ = _layer(p, x, cfg, acfg, window, tp)
    return x, aux


def _mtp_proj(w, x, tp: TPRank):
    """x @ the MTP head's ``proj``: this rank's columns of it (its input
    through ``TPRank.copy``) gathered whole over the ranks
    (``TPRank.gather``), or the whole product where they do not split."""
    if not tp.mtp:
        return x @ w
    return tp.gather(tp.copy(x) @ w)


def forward_train(params, cfg, batch, tp: TPRank):
    """``backbone.forward_train`` of a dense or MoE model on this rank's
    shard (``sharding.tp_plan``; a stacked leaf may be a
    ``backbone.StackShard`` whose layers ``backbone._layer`` gathers,
    under ``cfg.remat_layers`` inside the layer's checkpoint): (its
    logits [B, S, V/m], or [B, S, V] where the vocabulary stays whole,
    and ``{"moe_aux"}`` with, for an MTP head, its logits in
    ``"mtp_logits"``, this rank's vocabulary slice too).
    Differentiable; score the logits with ``tp.token_logprob``."""
    _check(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed(params, cfg, tokens, tp)
    acfg = tp.attn_cfg(cfg)
    aux = 0.0
    for key, n, off in bb.layer_stacks(cfg):
        layers = bb.unstack(params[key], n)
        for i, j, w in bb._segment_windows(cfg, n, off, seq_len=S):
            for p in layers[i:j]:
                x, a = bb._layer(cfg, _train_layer, p, x, cfg, acfg, w, tp)
                aux = aux + a
    out = {"moe_aux": aux}
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        h = _mtp_proj(mtp["proj"], torch.cat(
            [norm(x, mtp["norm"], cfg.norm), embed(params, cfg, nxt, tp)],
            dim=-1), tp)
        h, _, _ = _layer(mtp["block"], h, cfg, acfg, 0, tp)
        out["mtp_logits"] = head_logits(params, cfg, h, tp)
    return head_logits(params, cfg, x, tp), out


# the biases a rank slices where the heads (``_attn_params``) or the MLP's
# columns (``_ffn``) split: leaves it holds whole and uses a slice of
_SLICED_BIASES = {"heads": re.compile(r"(^|/)attn/(bq|bk|bv)$"),
                  "ffn": re.compile(r"(^|/)mlp/b_up$")}


def train_roles(cfg, mesh, params) -> list:
    """Per leaf of a dense or MoE ``params`` (whole tensors, DTensors or
    meta, in ``tree_leaves`` order), how a tensor-parallel training rank
    on ``mesh`` uses it: "shard" where ``tp_plan`` splits it over
    ``model`` (the rank computes with its slice, its experts or its MLA
    heads; its gradient is that slice's),
    "sum" where it holds the leaf whole but uses a slice (a bias of
    split heads or MLP columns: the ranks' gradients are disjoint slices
    of the whole, summed over ``model``), "whole" elsewhere (the router,
    the norms, MLA's ``wq_a wkv_a``, GQA's biases where only its
    projections split, added whole to the gathered q, k and v: every
    rank of a ``model`` row computes the same gradient)."""
    from repro_torch.train.optimizer import tree_leaves
    splits = tp_splits(cfg, mesh)

    def role(path, spec):
        if any(on_axis(ax, "model") for ax in spec):
            return "shard"
        ps = _path_str(path)
        if cfg.bias and any(splits[k] and rx.search(ps)
                            for k, rx in _SLICED_BIASES.items()):
            return "sum"
        return "whole"
    return tree_leaves(_map_with_path(role, tp_plan(cfg, mesh, params)))

"""GQA attention with RoPE (the port of the JAX package's
``models/attention.py``, dense family).

Full-sequence attention (train/prefill) goes through
``kernels.dispatch.attention``: the flash kernel on the card,
``chunked_attention`` on the CPU and for prefill continuations.  Dense
one-token decode, with one cursor or one per row, is plain torch, as the
reference leaves it to XLA; paged decode goes through
``kernels.dispatch.paged_attention``.  Every variant takes a sliding
``window`` (0 = full attention); a windowed ring cache holds its
positions out of order, so ``slot_pos`` is the only record of which
position a slot holds.  M-RoPE and MLA come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import chunked_attention  # noqa: F401
from repro_torch.kernels.online import NEG_INF
from repro_torch.models.common import apply_rope, dense_init


def gqa_params(gen, cfg, n_layers: int, dtype, device):
    """Stacked [n_layers, ...] attention params in the reference's layout."""
    D, H, K, hd, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, n_layers
    p = {"wq": dense_init(gen, (L, D, H * hd), dtype, device),
         "wk": dense_init(gen, (L, D, K * hd), dtype, device),
         "wv": dense_init(gen, (L, D, K * hd), dtype, device),
         "wo": dense_init(gen, (L, H * hd, D), dtype, device)}
    if cfg.bias:
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((L, n), dtype=dtype, device=device)
    return p


def _qkv(p, x, cfg):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def _rope(cfg):
    if cfg.rope_kind not in ("rope", "none"):
        raise NotImplementedError(
            f"rope_kind={cfg.rope_kind!r}: ported with the remaining "
            "families (ROADMAP A11)")
    return cfg.rope_kind == "rope"


def gqa_forward(p, x, cfg, *, window: int = 0):
    """Full-sequence causal GQA, over a sliding ``window`` when it is not
    0.  Returns (y, (k, v)) so prefill can build the KV cache; keys are
    returned already rotated."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if _rope(cfg):
        positions = torch.arange(S, device=x.device).expand(B, S)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    y = dispatch.attention(q, k, v, window=window)
    return y.reshape(B, S, -1) @ p["wo"], (k, v)


def gqa_decode(p, x, cache_k, cache_v, cache_pos, pos, cfg, *,
               window: int = 0):
    """One-token decode.  x: [B, 1, D]; cache_[kv]: [B, Sc, K, hd];
    cache_pos: [Sc] absolute position per slot (-1 = empty); pos: an int
    (one cursor for every row) or a [B] int tensor (one decode cursor per
    row, the continuous-batching engine's slot pool).

    The new rotated KV goes to slot ``pos % Sc`` (a ring); with a
    ``window`` a slot more than ``window - 1`` positions behind the
    cursor is masked.  With per-row
    ``pos`` each row writes its own slot and masks against its own
    cursor; the rows share one ``cache_pos``, which is consistent only
    while the ring never wraps (Sc > max pos): slot ``s`` then holds
    position ``s`` for every row that wrote it, so a freshly admitted row
    at a low cursor masks out the high slots it has not written yet.

    Unlike the reference, which returns new arrays, the caches are updated
    in place: the rollout owns them, and a copy per layer and step would
    cost a cache's worth of traffic.  The cache may hold another dtype than
    the params (the rollout keeps it in fp32): KV is cast on the way in,
    and the attention output is cast back to x's dtype before the output
    projection, so the residual stream keeps the params' dtype.  (The
    reference's ``dynamic_update_slice`` refuses a bf16 update into an
    fp32 cache, so it runs only with params and cache of one dtype.)
    Returns y [B, 1, D].
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _qkv(p, x, cfg)
    per_row = torch.is_tensor(pos)
    posb = pos[:, None] if per_row else torch.full((B, 1), pos,
                                                   device=x.device)
    if _rope(cfg):
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    Sc = cache_k.shape[1]
    if per_row:
        slot = (pos % Sc).long()
        rows = torch.arange(B, device=x.device)
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
        # rows may scatter to the same slot, but under no-wraparound they
        # all write value s at index s, so the order is irrelevant
        cache_pos[slot] = pos.to(cache_pos.dtype)
        mask = (cache_pos[None, :] <= posb) & (cache_pos >= 0)[None, :]
        if window:
            mask &= cache_pos[None, :] > posb - window
        mask = mask[:, None, None, None, :]
    else:
        slot = pos % Sc
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
        cache_pos[slot] = pos
        mask = (cache_pos <= pos) & (cache_pos >= 0)
        if window:
            mask &= cache_pos > pos - window

    qh = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh.float(),
                          cache_k.float()) * hd ** -0.5
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    y = torch.einsum("bkgqs,bskh->bqkgh", probs.to(cache_v.dtype), cache_v)
    return y.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]


def gqa_decode_paged(p, x, arena_k, arena_v, page_table, pos, cfg, *,
                     window: int = 0):
    """One-token decode against a paged KV arena (``models/paging.py``).

    x: [B, 1, D]; arena_[kv]: [n_pages + 1, P, K, hd] (the last page is
    the trash page); page_table: [B, max_blocks + 1] int32 whose last
    entry is always trash; pos: [B] int32 decode cursor per row.

    The new rotated KV goes, in place, to page ``table[row, pos // P]`` at
    offset ``pos % P``, with the block index clamped to the table's last
    entry: a cursor clamped to ``max_blocks * P`` lands on the trash page,
    so a finished row's zombie writes never touch a page that may have
    been handed to another row.  Live rows write distinct private pages
    (radix-shared pages hold only the block-aligned prompt prefix, below
    every decode cursor); zombie rows may collide on the trash page, which
    no live row reads.  Attention goes through
    ``dispatch.paged_attention`` with ``window``, whose CPU route is the
    dense ``gqa_decode`` arithmetic.  Returns y [B, 1, D].
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _qkv(p, x, cfg)
    if _rope(cfg):
        posb = pos[:, None]
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    P = arena_k.shape[1]
    rows = torch.arange(B, device=x.device)
    blk = torch.clamp(pos // P, max=page_table.shape[1] - 1).long()
    pg = page_table[rows, blk].long()
    off = (pos % P).long()
    arena_k[pg, off] = k[:, 0].to(arena_k.dtype)
    arena_v[pg, off] = v[:, 0].to(arena_v.dtype)
    y = dispatch.paged_attention(q[:, 0], arena_k, arena_v, page_table, pos,
                                 window=window)
    return y.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]


def gqa_extend(p, x, prefix_k, prefix_v, cfg, *, q_offset: int,
               window: int = 0):
    """Prefill continuation over a cached prefix (radix-hit admission).

    x: [B, S, D] embeds of the suffix tokens (absolute positions
    ``q_offset .. q_offset + S``); prefix_[kv]: [B, q_offset, K, hd]
    already-rotated KVs gathered from cached pages.  Each query row's
    attention is independent of the others and the cached prefix KVs are
    what a full prefill produced, so the suffix KVs and logits equal a
    prefill from token 0.  With ``q_offset == 0`` it is the full prefill
    (the flash kernel on the card when ``window`` is 0).  Returns (y, (k, v)) with k/v the
    suffix KVs only.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if _rope(cfg):
        positions = (torch.arange(S, device=x.device) + q_offset).expand(B, S)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cat_k = torch.cat([prefix_k.to(k.dtype), k], dim=1)
    cat_v = torch.cat([prefix_v.to(v.dtype), v], dim=1)
    y = dispatch.attention(q, cat_k, cat_v, window=window, q_offset=q_offset)
    return y.reshape(B, S, -1) @ p["wo"], (k, v)

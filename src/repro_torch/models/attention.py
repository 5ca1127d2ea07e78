"""GQA attention with RoPE, cross attention, and MLA (the port of the JAX
package's ``models/attention.py``).

Full-sequence attention (train/prefill) goes through
``kernels.dispatch.attention``: the flash kernel on the card for causal
self-attention, ``chunked_attention`` on the CPU, for prefill
continuations, and for an encoder's unmasked self-attention and the
decoder's cross attention over its frames (``gqa_cross_forward``, in
prefill and in decode alike), as the reference routes them.  Dense
one-token decode, with one cursor or one per row, is plain torch, as the
reference leaves it to XLA; paged decode goes through
``kernels.dispatch.paged_attention``.  Every variant takes a sliding
``window`` (0 = full attention); a windowed ring cache holds its
positions out of order, so ``slot_pos`` is the only record of which
position a slot holds.  MLA (DeepSeek-V3) trains and prefills in the
expanded form, whose asymmetric head dims ``dispatch.attention`` sends to
``chunked_attention`` as the reference does, and decodes in the absorbed
form over its latent cache, plain torch.  Qwen2-VL's M-RoPE turns q and
k by (temporal, height, width) position ids; the paged decode and the
prefill continuation refuse it, as the reference's do (no engine takes
the VLM family).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import chunked_attention  # noqa: F401
from repro_torch.kernels.online import NEG_INF
from repro_torch.models.common import apply_mrope, apply_rope, dense_init, \
    rmsnorm


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


def _matmuls(x, ws):
    return [x @ w for w in ws]


# the one-card (cols, row) products of ``gqa_forward`` and ``gqa_decode``
ONE_CARD = (_matmuls, torch.matmul)


def _qkv(p, x, cfg, cols=_matmuls):
    """q, k and v [B, S, heads, hd] of x; ``cols`` (by default one product
    a weight) maps x and ``(wq, wk, wv)`` to their three products."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = cols(x, (p["wq"], p["wk"], p["wv"]))
    if cfg.bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def _rotate(q, k, cfg, positions, mrope_pos=None):
    """q and k turned at ``positions`` [B, S] (RoPE) or at ``mrope_pos``
    [3, B, S] (M-RoPE; None takes t = h = w = ``positions``, the text
    rule); unchanged for ``rope_kind="none"``."""
    if cfg.rope_kind == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.rope_kind == "mrope":
        mp = torch.stack([positions] * 3) if mrope_pos is None \
            else mrope_pos
        return (apply_mrope(q, mp, cfg.rope_theta),
                apply_mrope(k, mp, cfg.rope_theta))
    return q, k


def gqa_forward(p, x, cfg, *, window: int = 0, mrope_pos=None,
                causal: bool = True, products=ONE_CARD):
    """Full-sequence GQA, causal unless ``causal=False`` (an encoder),
    over a sliding ``window`` when it is not 0; M-RoPE turns at
    ``mrope_pos`` [3, B, S].  Returns (y, (k, v)) so prefill can build
    the KV cache; keys are returned already rotated.  ``products``: a
    tensor-parallel rank's (cols, row), cols as ``_qkv`` takes it (the
    whole q, k, v from its columns of ``wq wk wv``) and row mapping the
    core's whole output and ``wo`` to its product (the rank's rows of it:
    y is then its partial sum); by default the one-card products."""
    cols, row = products
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, cols)
    q, k = _rotate(q, k, cfg, torch.arange(S, device=x.device).expand(B, S),
                   mrope_pos)
    y = dispatch.attention(q, k, v, causal=causal, window=window)
    return row(y.reshape(B, S, -1), p["wo"]), (k, v)


def gqa_cross_forward(p, x, k, v, cfg):
    """Cross attention: the decoder's x [B, S, D] (S may be 1, a decode
    step) over the encoder's k/v [B, F, K, hd] in x's dtype, no mask and
    no rotation."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    y = dispatch.attention(q, k, v, causal=False)
    return y.reshape(B, S, -1) @ p["wo"]


def gqa_decode(p, x, cache_k, cache_v, cache_pos, pos, cfg, *,
               window: int = 0, mrope_pos=None, products=ONE_CARD):
    """One-token decode.  x: [B, 1, D]; cache_[kv]: [B, Sc, K, hd];
    cache_pos: [Sc] absolute position per slot (-1 = empty); pos: an int
    (one cursor for every row) or a [B] int tensor (one decode cursor per
    row, the continuous-batching engine's slot pool).

    The new rotated KV goes to slot ``pos % Sc`` (a ring); with a
    ``window`` a slot more than ``window - 1`` positions behind the
    cursor is masked.  M-RoPE turns at ``mrope_pos`` [3, B, 1], by
    default the row's position three times.  With per-row
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
    ``products`` as ``gqa_forward`` takes it.  Returns y [B, 1, D].
    """
    cols, row = products
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _qkv(p, x, cfg, cols)
    per_row = torch.is_tensor(pos)
    posb = pos[:, None] if per_row else torch.full((B, 1), pos,
                                                   device=x.device)
    q, k = _rotate(q, k, cfg, posb, mrope_pos)
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
    return row(y.reshape(B, 1, H * hd).to(x.dtype), p["wo"])


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
    dense ``gqa_decode`` arithmetic.  M-RoPE is refused, as in the
    reference.  Returns y [B, 1, D].
    """
    assert cfg.rope_kind != "mrope", "paged decode is rope/none only"
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, cfg, pos[:, None])
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
    (the flash kernel on the card when ``window`` is 0).  M-RoPE is
    refused, as in the reference.  Returns (y, (k, v)) with k/v the
    suffix KVs only.
    """
    assert cfg.rope_kind != "mrope", "paged extend is rope/none only"
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, cfg,
                   (torch.arange(S, device=x.device) + q_offset).expand(B, S))
    cat_k = torch.cat([prefix_k.to(k.dtype), k], dim=1)
    cat_v = torch.cat([prefix_v.to(v.dtype), v], dim=1)
    y = dispatch.attention(q, cat_k, cat_v, window=window, q_offset=q_offset)
    return y.reshape(B, S, -1) @ p["wo"], (k, v)


# ------------------------------------------------------------------- MLA ---

def mla_params(gen, cfg, n_layers: int, dtype, device):
    """Stacked [n_layers, ...] MLA params in the reference's eight keys.
    ``wk_b`` and ``wv_b`` stay factored, so decode can run in the
    absorbed (latent) form."""
    m, D, H, L = cfg.mla, cfg.d_model, cfg.n_heads, n_layers
    qk = m.qk_nope_dim + m.qk_rope_dim

    def ones(n):
        return torch.ones((L, n), dtype=dtype, device=device)
    return {
        "wq_a": dense_init(gen, (L, D, m.q_lora_rank), dtype, device),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": dense_init(gen, (L, m.q_lora_rank, H * qk), dtype, device),
        "wkv_a": dense_init(gen, (L, D, m.kv_lora_rank + m.qk_rope_dim),
                            dtype, device),
        "kv_norm": ones(m.kv_lora_rank),
        "wk_b": dense_init(gen, (L, m.kv_lora_rank, H * m.qk_nope_dim),
                           dtype, device),
        "wv_b": dense_init(gen, (L, m.kv_lora_rank, H * m.v_head_dim),
                           dtype, device),
        "wo": dense_init(gen, (L, H * m.v_head_dim, D), dtype, device)}


def _mla_qkv_latent(p, x, cfg, positions, copy=None):
    """The shared front half: the queries' no-rope and rotated parts
    [B, S, H, *], the normed latent c_kv [B, S, kv_lora_rank] and the
    rotated key shared by every head [B, S, qk_rope_dim].  A
    tensor-parallel rank (``models/tp.py``) passes its heads' columns of
    ``wq_b wk_b wv_b`` and ``copy``, through which the three tensors its
    heads read of the whole products (the normed query latent, c_kv and
    the rotated key) pass: the identity, their gradient summed over its
    ranks."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    copy = copy or (lambda t: t)
    q = copy(rmsnorm(x @ p["wq_a"], p["q_norm"])) @ p["wq_b"]
    q_nope, q_rope = q.reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim) \
        .split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim],
                                          dim=-1)
    c_kv = copy(rmsnorm(c_kv, p["kv_norm"]))
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, copy(k_rope[:, :, 0, :])


def mla_forward(p, x, cfg, copy=None):
    """Full-sequence causal MLA in the expanded form (train and prefill):
    per-head keys [no-rope from the latent, the shared rotated key] of
    qk_nope + qk_rope dims against values of v_head_dim, scaled by
    (qk_nope + qk_rope)^-0.5.  Returns (y, (c_kv, k_rope)), what the
    latent cache holds.  ``copy``: a tensor-parallel rank's, as
    ``_mla_qkv_latent`` takes it (y is then its heads' partial sum)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, positions,
                                                   copy)
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    # v_head_dim != the qk dim, so dispatch takes chunked_attention (the
    # flash kernel assumes symmetric head dims), as in the reference
    y = dispatch.attention(q, k, v)
    return y.reshape(B, S, -1) @ p["wo"], (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, cache_pos, pos, cfg):
    """One-token MLA decode in the absorbed form: attention runs in the
    latent space.  x: [B, 1, D]; cache_ckv: [B, Sc, kv_lora_rank];
    cache_krope: [B, Sc, qk_rope_dim]; cache_pos: [Sc] (-1 = empty); pos:
    an int, one cursor for every row, as in the reference (the engine's
    per-row cursors take no latent cache in either package).

    W_UK is absorbed into the query (``q_lat``, rounded to x's dtype as
    the reference's product is), the scores of the latent and of the
    rotated key accumulate and stay in fp32, and W_UV is applied after
    the probabilities' product with the latent.  The caches are updated
    in place, as ``gqa_decode`` does, and may hold another dtype than
    the params: the latent output is cast back to x's dtype before W_UV.
    Returns y [B, 1, D]."""
    if torch.is_tensor(pos):
        raise NotImplementedError(
            "mla_decode takes one int cursor for every row: per-row "
            "cursors (the engine) take no MLA latent cache, as in the "
            "reference")
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    posb = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, posb)
    slot = pos % cache_ckv.shape[1]
    cache_ckv[:, slot] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, slot] = k_rope[:, 0].to(cache_krope.dtype)
    cache_pos[slot] = pos

    wk_b = p["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    # q_lat[b, h, r] = sum_n q_nope[b, h, n] wk_b[r, h, n]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk_b)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(),
                           cache_ckv.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             cache_krope.float())) * scale
    mask = (cache_pos <= pos) & (cache_pos >= 0)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs.to(cache_ckv.dtype),
                           cache_ckv)
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    y = torch.einsum("bqhr,rhv->bqhv", out_lat.to(x.dtype), wv_b)
    return y.reshape(B, 1, H * m.v_head_dim) @ p["wo"]

"""Serving path: KV cache, prefill, single-token decode (the port of the
JAX package's ``models/serve.py``, every family), and the engine's
slot-pool helpers.

Two cache layouts, as in the reference:
- dense: ``{"pos", "segments": [{"k", "v", "slot_pos"}]}`` with k/v
  [L_seg, B, Sc, K, hd] and slot_pos [Sc] (-1 = empty), one segment per
  run of layers of one window within one layer stack (``segment_layout``:
  the stacks of ``backbone.layer_stacks`` in order), each a ring of
  ``min(cache_len, window)`` slots; a ring that wraps holds its
  positions out of order, and ``slot_pos`` records them.  MLA's latent
  segment holds ``{"ckv", "krope", "slot_pos"}`` instead, ckv [L_seg, B,
  Sc, kv_lora_rank] and krope [L_seg, B, Sc, qk_rope_dim]: 576 values a
  position a layer at DeepSeek-V3's widths, where expanded K and V would
  hold 128 heads x (192 + 128) = 40960;
- paged: ``{"pos", "page_table", "segments": [{"k", "v"}]}`` with k/v
  arenas [L_seg, n_pages + 1, P, K, hd] shared by all rows (the last
  page is the trash page) and one page_table [B, max_blocks + 1] int32
  for every segment, every entry starting on the trash page.

A VLM's dense cache is the dense family's; its prefill writes the patch
prefix and the prompt, so ``pos`` counts both.  A hybrid's cache is
``{"pos", "mamba": {"conv", "ssm"}, "attn": {"k", "v", "slot_pos"}}``:
the Mamba2 states stacked over the layers (conv [L, B, K-1, C] and ssm
[L, B, H, P, N], fp32) and one ring of ``min(cache_len, 4096)`` slots
for the shared attention block's ceil(L / shared_attn_every)
applications, k/v [G, B, Sc, K, hd], the reference's own ring: past 4096
positions it wraps and the block attends over the last 4096.

An xLSTM's cache is ``{"pos", "xlstm": [state a layer]}``: an mLSTM
layer's (C [B, H, P, P], n [B, H, P]) tuple, an sLSTM layer's {"h", "c",
"n", "m"} dict of [B, H, P], all fp32, whatever the length.  An audio
model's is ``{"pos", "self": {"k", "v", "slot_pos"}, "cross_k",
"cross_v"}``: the decoder's self-attention ring of ``cache_len`` slots,
k/v [L, B, Sc, K, hd], and the encoder's cross-attention K and V of
every decoder layer, [L, B, F, K, hd], which prefill computes once and
leaves in the params' dtype, as the reference does; ``pos`` counts the
tokens only.

``pos`` is a Python int, one cursor for every row, or a [B] int32
tensor, one decode cursor per row (the engine's slot pool; the paged
layout always has it, and neither takes MLA, as in the reference).
Decode updates the cache in place and returns it.

``prefill`` and ``decode_step`` with ``tp`` (a ``models.tp.TPRank``) run
a dense model's step on a rank's tensor-parallel shard (``models/tp.py``):
its logits are its vocabulary slice, its dense cache holds its ``K/m``
heads where the heads split.  Without ``tp`` every path is the one-card
one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models import ssm as ssmmod
from repro_torch.models.common import norm, sinusoidal_positions
from repro_torch.models.paging import paged_blocks

Cache = Dict[str, Any]

# the hybrid's shared attention ring, as the reference sizes it
HYBRID_RING = 4096


def _seg_cache_len(cache_len: int, window: int) -> int:
    return min(cache_len, window) if window else cache_len


def attn_segments(cfg: ArchConfig, n_layers: int, offset: int = 0):
    return bb._segment_windows(cfg, n_layers, offset)


def stack_segments(params, cfg: ArchConfig):
    """Every cache segment's layers in the order prefill and decode walk
    them, as ``(per-layer params, window)``, one pair a segment: the
    stacks of ``backbone.layer_stacks``, each cut into runs of one
    window."""
    out = []
    for key, n, off in bb.layer_stacks(cfg):
        layers = bb.unstack(params[key], n)
        out += [(layers[i:j], w) for (i, j, w) in attn_segments(cfg, n, off)]
    return out


def segment_layout(cfg: ArchConfig):
    """Cache segment layout [(n_layers, window), ...] in the order prefill
    and decode walk the layer stacks."""
    return [(j - i, w) for _, n, off in bb.layer_stacks(cfg)
            for (i, j, w) in attn_segments(cfg, n, off)]


def init_cache(cfg: ArchConfig, B: int, cache_len: int,
               dtype=torch.bfloat16, *, device, layout: str = "dense",
               page_size: int = 0, n_pages: int = 0) -> Cache:
    """A zeroed cache for ``B`` rows of ``cache_len`` positions: one dense
    ring of ``min(cache_len, window)`` slots a segment.  The paged layout
    holds, for each segment, ``n_pages`` allocatable pages of
    ``page_size`` slots plus the trash page, and one table of
    ``paged_blocks(cache_len, page_size) + 1`` entries a row.  A
    hybrid's cache is its Mamba2 states and its shared block's ring, an
    xLSTM's its cells' states, an audio model's its decoder's ring and
    zeroed cross-attention K and V of ``frontend_tokens`` frames."""
    bb.check_family(cfg)
    K, hd = cfg.n_kv_heads, cfg.hd
    if layout == "paged":
        assert cfg.family in ("dense", "moe"), \
            f"paged layout covers dense/moe GQA only, got {cfg.family!r}"
        assert cfg.attn_kind != "mla", \
            "paged layout covers dense/moe GQA only (MLA latent caches " \
            "need latent-shaped pages)"
        assert page_size > 0 and n_pages > 0, (page_size, n_pages)
        mb = paged_blocks(cache_len, page_size)

        def seg(n):
            shape = (n, n_pages + 1, page_size, K, hd)
            return {"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
        # one table shared by every segment: block b of row r lives in
        # physical page table[r, b] of each segment's arena; the last entry
        # is pinned to the trash page (= n_pages)
        return {"pos": 0,
                "segments": [seg(n) for n, _ in segment_layout(cfg)],
                "page_table": torch.full((B, mb + 1), n_pages,
                                         dtype=torch.int32, device=device)}
    if layout != "dense":
        raise ValueError(f"kv layout {layout!r}: expected dense|paged")

    if cfg.attn_kind == "mla":
        shapes = {"ckv": (cfg.mla.kv_lora_rank,),
                  "krope": (cfg.mla.qk_rope_dim,)}
    else:
        shapes = {"k": (K, hd), "v": (K, hd)}

    def ring(n, Sc):
        seg = {name: torch.zeros((n, B, Sc) + shape, dtype=dtype,
                                 device=device)
               for name, shape in shapes.items()}
        seg["slot_pos"] = torch.full((Sc,), -1, dtype=torch.int32,
                                     device=device)
        return seg
    if cfg.family == "ssm":
        return {"pos": 0, "xlstm": [
            ssmmod.slstm_init_state(cfg, B, device=device)
            if i in cfg.xlstm.slstm_layers
            else ssmmod.mlstm_init_state(cfg, B, device=device)
            for i in range(cfg.n_layers)]}
    if cfg.family == "audio":
        cross = (cfg.n_layers, B, cfg.frontend_tokens, K, hd)
        return {"pos": 0, "self": ring(cfg.n_layers, cache_len),
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        state = ssmmod.mamba2_init_state(cfg, B, device=device)
        return {"pos": 0,
                "mamba": {k: v.expand((cfg.n_layers,) + v.shape).clone()
                          for k, v in state.items()},
                "attn": ring(len(bb.hybrid_groups(cfg)),
                             min(cache_len, HYBRID_RING))}
    return {"pos": 0,
            "segments": [ring(n, _seg_cache_len(cache_len, w))
                         for n, w in segment_layout(cfg)]}


def _write_seg(seg, kvs, start: int):
    """Write prefill KVs (stacked [L, B, S, ...]; MLA's (c_kv, k_rope))
    into a ring segment, in place: the last ``min(S, Sc)`` positions land
    at ``pos % Sc``."""
    S = kvs[0].shape[2]
    Sc = seg["slot_pos"].shape[0]
    take = min(S, Sc)
    pos = torch.arange(S - take, S, device=seg["slot_pos"].device) + start
    slots = pos % Sc
    names = ("ckv", "krope") if "ckv" in seg else ("k", "v")
    for name, kv in zip(names, kvs):
        seg[name][:, :, slots] = kv[:, :, -take:].to(seg[name].dtype)
    seg["slot_pos"][slots] = pos.to(torch.int32)
    return seg


def prefill(params, cfg: ArchConfig, batch, cache_len: int,
            dtype=torch.bfloat16, *, tp=None):
    """batch: {'tokens': [B, S]}, with ``patch_embeds`` [B, P, D] for a
    VLM (then ``cache_len`` must hold P + S + the decoded tokens) and
    ``frame_embeds`` [B, F, D] for an audio model.  Returns (last_logits
    [B, V], cache); with ``tp`` a tensor-parallel rank's
    (``models/tp.py``)."""
    if tp is not None:
        from repro_torch.models import tp as tpmod
        return tpmod.prefill(params, cfg, batch, cache_len, dtype, tp)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = bb._embed(params, cfg, tokens)
    cache = init_cache(cfg, B, cache_len, dtype, device=x.device)
    if cfg.family == "hybrid":
        return _prefill_hybrid(params, cfg, x, cache)
    if cfg.family == "ssm":
        for i, p in enumerate(params["xlstm_layers"]):
            y, cache["xlstm"][i] = bb.xlstm_layer(p, x, cfg, i)
            x = x + y
        cache["pos"] = S
        return bb._logits(params, cfg, x[:, -1]), cache
    if cfg.family == "audio":
        return _prefill_audio(params, cfg, batch, x, cache)
    mrope_pos, prefix = None, 0
    if cfg.family == "vlm":
        x, mrope_pos, prefix = bb.vlm_prefix(cfg, x, batch)
    kv_segs = []
    for key, n, off in bb.layer_stacks(cfg):
        x, _, kvs = bb._run_decoder_stack(params[key], x, cfg, n, off,
                                          collect_kv=True,
                                          mrope_pos=mrope_pos)
        kv_segs += kvs
    for seg, kvs in zip(cache["segments"], kv_segs):
        _write_seg(seg, kvs, start=0)
    cache["pos"] = S + prefix
    return bb._logits(params, cfg, x[:, -1]), cache


def _prefill_hybrid(params, cfg, x, cache):
    """The hybrid's prefill: the shared block before each Mamba group,
    its rotated KV of each application into the ring, each Mamba layer's
    state after the last step into ``cache["mamba"]``."""
    layers = bb.unstack(params["mamba_layers"], cfg.n_layers)
    shared = params["shared_attn"]
    ks, vs = [], []
    for i, j in bb.hybrid_groups(cfg):
        x, (k, v) = bb._attn_block(shared, x, cfg)
        x, _ = bb._ffn_block(shared, x, cfg)
        ks.append(k)
        vs.append(v)
        for li in range(i, j):
            x, st = bb.mamba_layer(layers[li], x, cfg, return_state=True)
            for name, t in st.items():
                cache["mamba"][name][li] = t
    _write_seg(cache["attn"], (torch.stack(ks), torch.stack(vs)), start=0)
    cache["pos"] = x.shape[1]
    return bb._logits(params, cfg, x[:, -1]), cache


def _prefill_audio(params, cfg, batch, x, cache):
    """The audio model's prefill: the encoder once, then the decoder over
    the prompt with its positions; the self-attention's KV into the ring,
    the cross attention's K and V of every layer into the cache."""
    S = x.shape[1]
    enc = bb._encode(params, cfg, batch["frame_embeds"])
    x = x + sinusoidal_positions(S, cfg.d_model,
                                 device=x.device)[None].to(x.dtype)
    x, (ks, vs, eks, evs) = bb.run_encdec_decoder(params, cfg, x, enc,
                                                  collect=True)
    _write_seg(cache["self"], (ks, vs), start=0)
    cache["cross_k"], cache["cross_v"] = eks, evs
    cache["pos"] = S
    return bb._logits(params, cfg, x[:, -1]), cache


def _extend_collect(params, cfg, x, prefix_kvs, q_offset: int):
    """Prefill continuation: run the suffix embeds ``x`` (absolute
    positions ``q_offset ..``) through the layers, attending over the
    cached prefix KVs gathered from the radix-shared pages, and collect
    the suffix KVs.  ``prefix_kvs``: one (k, v) pair a cache segment, each
    [L_seg, B, q_offset, K, hd].  Returns (x, kv_segs) with one (k, v)
    pair a segment, stacked [L_seg, B, S, K, hd]."""
    kv_segs = []
    for (layers, w), (pk, pv) in zip(stack_segments(params, cfg),
                                     prefix_kvs):
        ks, vs = [], []
        for li, p in enumerate(layers):
            y, (k, v) = attn.gqa_extend(
                p["attn"], norm(x, p["ln1"], cfg.norm), pk[li], pv[li], cfg,
                q_offset=q_offset, window=w)
            x, _ = bb._ffn_block(p, x + y, cfg)
            ks.append(k)
            vs.append(v)
        kv_segs.append((torch.stack(ks), torch.stack(vs)))
    return x, kv_segs


def decode_step(params, cfg: ArchConfig, cache: Cache, tokens, *, tp=None):
    """tokens: [B, 1].  Returns (logits [B, V], cache) with the cache
    advanced in place by one position (each row's own cursor when ``pos``
    is a tensor), segment by segment.  A VLM's token at cache position
    ``pos`` turns at side + pos - P in all three M-RoPE sections (P
    patches, side = floor(sqrt(P))).  With ``tp`` a tensor-parallel
    rank's step (``models/tp.py``)."""
    if tp is not None:
        from repro_torch.models import tp as tpmod
        return tpmod.decode_step(params, cfg, cache, tokens, tp)
    pos = cache["pos"]
    table = cache.get("page_table")
    x = bb._embed(params, cfg, tokens)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cfg, cache, x)
    if cfg.family == "ssm":
        for i, p in enumerate(params["xlstm_layers"]):
            step = ssmmod.slstm_decode if i in cfg.xlstm.slstm_layers \
                else ssmmod.mlstm_decode
            y, cache["xlstm"][i] = step(p["cell"], norm(x, p["ln"], cfg.norm),
                                        cache["xlstm"][i], cfg)
            x = x + y
        cache["pos"] = pos + 1
        return bb._logits(params, cfg, x[:, -1]), cache
    if cfg.family == "audio":
        return _decode_audio(params, cfg, cache, x)
    mrope_pos = None
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        side = max(int(P ** 0.5), 1)
        t = (torch.full((x.shape[0], 1), pos, device=x.device)
             if not torch.is_tensor(pos) else pos[:, None]) + side - P
        mrope_pos = torch.stack([t, t, t])
    for (layers, w), seg in zip(stack_segments(params, cfg),
                                cache["segments"]):
        for li, p in enumerate(layers):
            h = norm(x, p["ln1"], cfg.norm)
            if "ckv" in seg:
                y = attn.mla_decode(p["attn"], h, seg["ckv"][li],
                                    seg["krope"][li], seg["slot_pos"], pos,
                                    cfg)
            elif table is not None:
                y = attn.gqa_decode_paged(p["attn"], h, seg["k"][li],
                                          seg["v"][li], table, pos, cfg,
                                          window=w)
            else:
                y = attn.gqa_decode(p["attn"], h, seg["k"][li],
                                    seg["v"][li], seg["slot_pos"], pos, cfg,
                                    window=w, mrope_pos=mrope_pos)
            x, _ = bb._ffn_block(p, x + y, cfg)
    cache["pos"] = pos + 1
    return bb._logits(params, cfg, x[:, -1]), cache


def _decode_hybrid(params, cfg, cache, x):
    """The hybrid's decode step: the shared block against its ring (no
    window; the ring's slots are its span) before each Mamba group, then
    ``mamba2_decode`` a layer at a time, each state updated in place."""
    pos = cache["pos"]
    layers = bb.unstack(params["mamba_layers"], cfg.n_layers)
    shared, ring, states = params["shared_attn"], cache["attn"], \
        cache["mamba"]
    for g, (i, j) in enumerate(bb.hybrid_groups(cfg)):
        y = attn.gqa_decode(shared["attn"], norm(x, shared["ln1"], cfg.norm),
                            ring["k"][g], ring["v"][g], ring["slot_pos"],
                            pos, cfg)
        x, _ = bb._ffn_block(shared, x + y, cfg)
        for li in range(i, j):
            p = layers[li]
            y, st = ssmmod.mamba2_decode(
                p["mamba"], norm(x, p["ln1"], cfg.norm),
                {k: v[li] for k, v in states.items()}, cfg)
            x = x + y
            for name, t in st.items():
                states[name][li] = t
    cache["pos"] = pos + 1
    return bb._logits(params, cfg, x[:, -1]), cache


def _decode_audio(params, cfg, cache, x):
    """The audio model's decode step: the token's sinusoidal position
    (``_sin_pos_at``), then each decoder layer's self-attention against
    its ring (updated in place), its cross attention over the cached
    frames' K and V, and its MLP."""
    pos = cache["pos"]
    ring = cache["self"]
    x = x + _sin_pos_at(pos, cfg.d_model, x.device).to(x.dtype)
    for li, p in enumerate(bb.unstack(params["dec_layers"], cfg.n_layers)):
        y = attn.gqa_decode(p["attn"], norm(x, p["ln1"], cfg.norm),
                            ring["k"][li], ring["v"][li], ring["slot_pos"],
                            pos, cfg)
        x = x + y
        x = x + attn.gqa_cross_forward(
            p["cross"], norm(x, p["ln_cross"], cfg.norm),
            cache["cross_k"][li], cache["cross_v"][li], cfg)
        x, _ = bb._ffn_block(p, x, cfg)
    cache["pos"] = pos + 1
    return bb._logits(params, cfg, x[:, -1]), cache


def _sin_pos_at(pos: int, d_model: int, device=None):
    """The sinusoidal position embedding of one position, [1, 1, D]: the
    angles in fp32, as the reference's decode computes them (its prefill
    takes float64 angles, so the two agree to about 1e-5, not bit for
    bit)."""
    i = torch.arange(d_model // 2, dtype=torch.int32, device=device)
    ang = torch.tensor(pos, dtype=torch.float32, device=device) \
        / torch.pow(10000.0, 2 * i / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


# ------------------------------------------------ engine slot-pool helpers -

class SlotPool:
    """Host-side occupancy tracking for the batch axis of a running
    decode cache: which rows are live and which are free for admission.
    Pure bookkeeping -- the device tensors never shrink; a freed slot is
    simply overwritten by the next admission."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))    # pop() -> slot 0
        self._used: set = set()

    def acquire(self):
        """Claim a free slot index, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def release(self, slot: int) -> None:
        assert slot in self._used, f"slot {slot} not in use"
        self._used.discard(slot)
        self._free.append(slot)

    @property
    def used(self):
        return frozenset(self._used)

    @property
    def free_count(self) -> int:
        return len(self._free)


def assert_engine_cache(cfg: ArchConfig, layout: str = "dense") -> None:
    """Which caches the engine's per-row decode cursors support (the
    reference's contract).  Both layouts need a dense-family GQA cache;
    the dense layout also needs unwindowed rings (a windowed ring wraps,
    so slots alias across rows' cursors), where the paged layout's
    per-row tables admit windows: masking enforces them."""
    assert cfg.family in ("dense", "moe"), \
        f"engine needs a dense-family KV cache, got family={cfg.family!r} " \
        "(ssm/hybrid state caches are not paged KV; vlm needs mrope decode)"
    assert cfg.attn_kind != "mla", \
        "engine does not support MLA latent caches yet " \
        "(paged follow-up: latent-shaped pages for ckv/krope)"
    if layout == "paged":
        return
    for (_, w) in segment_layout(cfg):
        assert not w, \
            "engine needs unwindowed rings: a windowed segment wraps, " \
            "which breaks the shared slot_pos across per-row cursors " \
            "(use the paged layout -- per-row page tables admit windows)"


def stitch_cache_row(cache: Cache, row_cache: Cache, slot: int) -> Cache:
    """Graft a freshly prefilled B=1 dense cache into batch row ``slot`` of
    a running per-row-cursor cache (prefill-into-slot admission), in
    place.  ``cache["pos"]`` must be a [B] tensor of per-row cursors; the
    donor's int ``pos`` becomes the admitted row's cursor.  ``slot_pos``
    merges with ``maximum``: under the engine's no-wraparound invariant
    both sides hold -1 or the slot's own index, so the union is exact."""
    for seg, rseg in zip(cache["segments"], row_cache["segments"]):
        for name in ("k", "v"):
            seg[name][:, slot] = rseg[name][:, 0].to(seg[name].dtype)
        torch.maximum(seg["slot_pos"], rseg["slot_pos"],
                      out=seg["slot_pos"])
    cache["pos"][slot] = row_cache["pos"]
    return cache

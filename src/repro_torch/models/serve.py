"""Serving path: KV cache, prefill, single-token decode (the port of the
JAX package's ``models/serve.py``, dense family and dense ring layout).

The cache is ``{"pos": int, "segments": [{"k", "v", "slot_pos"}]}`` with
k/v [L, B, Sc, K, hd] and slot_pos [Sc] (-1 = empty), as in the
reference; the dense family without windows has one segment.  ``pos`` is
a Python int, the scalar decode cursor.  Decode updates the cache in place
and returns it.  The paged layout and per-row cursors come with the
engine slice (ROADMAP A10).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models.common import norm

Cache = Dict[str, Any]


def init_cache(cfg: ArchConfig, B: int, cache_len: int,
               dtype=torch.bfloat16, *, device, layout: str = "dense"
               ) -> Cache:
    bb.check_dense(cfg)
    if layout != "dense":
        raise NotImplementedError(
            f"kv_layout={layout!r}: the paged layout comes with the engine "
            "slice (ROADMAP A10)")
    K, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    seg = {"k": torch.zeros((L, B, cache_len, K, hd), dtype=dtype,
                            device=device),
           "v": torch.zeros((L, B, cache_len, K, hd), dtype=dtype,
                            device=device),
           "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                  device=device)}
    return {"pos": 0, "segments": [seg]}


def _write_seg(seg, kvs, start: int):
    """Write prefill KVs (stacked [L, B, S, ...]) into a ring segment, in
    place: the last ``min(S, Sc)`` positions land at ``pos % Sc``."""
    S = kvs[0].shape[2]
    Sc = seg["slot_pos"].shape[0]
    take = min(S, Sc)
    pos = torch.arange(S - take, S, device=seg["slot_pos"].device) + start
    slots = pos % Sc
    for name, kv in zip(("k", "v"), kvs):
        seg[name][:, :, slots] = kv[:, :, -take:].to(seg[name].dtype)
    seg["slot_pos"][slots] = pos.to(torch.int32)
    return seg


def prefill(params, cfg: ArchConfig, batch, cache_len: int,
            dtype=torch.bfloat16):
    """batch: {'tokens': [B, S]}.  Returns (last_logits [B, V], cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = bb._embed(params, cfg, tokens)
    cache = init_cache(cfg, B, cache_len, dtype, device=x.device)
    x, kvs = bb._run_decoder_stack(params["layers"], x, cfg, collect_kv=True)
    stacked = (torch.stack([k for k, _ in kvs]),
               torch.stack([v for _, v in kvs]))
    _write_seg(cache["segments"][0], stacked, start=0)
    cache["pos"] = S
    return bb._logits(params, cfg, x[:, -1]), cache


def decode_step(params, cfg: ArchConfig, cache: Cache, tokens):
    """tokens: [B, 1].  Returns (logits [B, V], cache) with the cache
    advanced in place by one position."""
    pos = cache["pos"]
    seg = cache["segments"][0]
    x = bb._embed(params, cfg, tokens)
    for i, p in enumerate(bb.unstack(params["layers"], cfg.n_layers)):
        y = attn.gqa_decode(p["attn"], norm(x, p["ln1"], cfg.norm),
                            seg["k"][i], seg["v"][i], seg["slot_pos"], pos,
                            cfg)
        x = bb._ffn_block(p, x + y, cfg)
    cache["pos"] = pos + 1
    return bb._logits(params, cfg, x[:, -1]), cache

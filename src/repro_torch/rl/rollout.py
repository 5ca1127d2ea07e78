"""Rollout: prefill + chunked decode with partial-rollout resume, and the
continuous-batching engine's slot pool (the port of the JAX package's
``rl/rollout.py``).

Behaviour log-probs mu(y_t | x, y_<t) -- under the sampling distribution,
temperature included -- travel with the sample.  Decoding never waits on
the card: the cursor is a Python int (a [B] tensor on the card in the
slot pool) and the keys live on the host.

``start_rollout``, ``rollout_chunk`` and ``generate`` take ``tp``, a
``models.tp.TPRank``, on a rank's tensor-parallel shard of a dense
model: its prompts are its rows (``TPRank.for_rows``), its logits its
vocabulary slice, and it samples through ``TPRank.sample`` (B3 on the
slice, the ranks' partials merged), so every rank of a ``model`` group
draws the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.paging import paged_blocks
from repro_torch.models.serve import _extend_collect, assert_engine_cache, \
    stitch_cache_row
from repro_torch.rl import prng
from repro_torch.rl.data import EOS, PAD


@dataclass
class RolloutState:
    tokens: torch.Tensor          # [B, total_len] prompt + generated (PAD after)
    behavior_logp: torch.Tensor   # [B, total_len] mu logprob per generated token
    cache: Any
    last_logits: torch.Tensor     # [B, V] logits predicting the next token
    done: torch.Tensor            # [B] bool
    prompt_len: int

    def _replace(self, **kw) -> "RolloutState":
        return replace(self, **kw)


def _prefix(cfg) -> int:
    """The cache positions ahead of the tokens: a VLM's patches."""
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


@torch.no_grad()
def start_rollout(params, cfg, prompts, total_len: int,
                  dtype=torch.float32, cache_len: int = 0,
                  extra=None, *, tp=None) -> RolloutState:
    """prompts: [B, S_p] int (rectangular), on the params' device.  The
    KV cache defaults to fp32 whatever the params' dtype, as in the
    reference.  ``extra`` joins the prefill's batch: a VLM's
    ``patch_embeds``, after which the cache defaults to ``total_len``
    plus the patch prefix, or an audio model's ``frame_embeds``, which
    the encoder reads once (the cache stays ``total_len``: the reference
    adds the prefix for the VLM only)."""
    B, Sp = prompts.shape
    batch = {"tokens": prompts, **(extra or {})}
    last_logits, cache = prefill(params, cfg, batch,
                                 cache_len=cache_len
                                 or total_len + _prefix(cfg), dtype=dtype,
                                 tp=tp)
    tokens = torch.zeros((B, total_len), dtype=torch.int32,
                         device=prompts.device)
    tokens[:, :Sp] = prompts
    return RolloutState(
        tokens=tokens,
        behavior_logp=torch.zeros((B, total_len), dtype=torch.float32,
                                  device=prompts.device),
        cache=cache, last_logits=last_logits,
        done=torch.zeros(B, dtype=torch.bool, device=prompts.device),
        prompt_len=Sp)


def _sample(logits, key, temperature: float, tp=None):
    """Fused Gumbel-max draw + behaviour log-prob through the dispatch
    layer: one streamed pass over the vocabulary per decode step (over a
    rank's slice, merged over its ranks, with ``tp``)."""
    if tp is not None:
        return tp.sample(logits, key, temperature)
    return dispatch.sample(logits, key, temperature)


@torch.no_grad()
def rollout_chunk(params, cfg, state: RolloutState, key, *, n_steps: int,
                  temperature: float = 1.0, tp=None) -> RolloutState:
    """Generate up to ``n_steps`` tokens; resumable (partial rollout).  The
    cache advances in place."""
    cursor = state.cache["pos"] - _prefix(cfg)
    cache, logits, done = state.cache, state.last_logits, state.done
    toks, lps = [], []
    for k in prng.split(key, n_steps):
        tok, lp = _sample(logits, k, temperature, tp)
        tok = torch.where(done, PAD, tok)
        # PAD emissions (done rows, or a live row drawing id 0) are never
        # action positions: keep mu consistent with the action mask
        lp = torch.where(tok == PAD, 0.0, lp)
        done = done | (tok == EOS)
        logits, cache = decode_step(params, cfg, cache, tok[:, None], tp=tp)
        toks.append(tok)
        lps.append(lp)
    tokens = state.tokens.clone()
    blp = state.behavior_logp.clone()
    # the reference's dynamic_update_slice clamps a write past the end
    start = min(cursor, tokens.shape[1] - n_steps)
    tokens[:, start:start + n_steps] = torch.stack(toks, dim=1)
    blp[:, start:start + n_steps] = torch.stack(lps, dim=1)
    return RolloutState(tokens=tokens, behavior_logp=blp, cache=cache,
                        last_logits=logits, done=done,
                        prompt_len=state.prompt_len)


def finalize_rollout(state: RolloutState, max_new: int) -> RolloutState:
    """Slice a bucket-padded rollout back to ``prompt + max_new`` tokens;
    ``done`` is recomputed from the kept region, so a row that only EOS'd
    in the overshoot still reads as unfinished."""
    Sp = state.prompt_len
    if state.tokens.shape[1] == Sp + max_new:
        return state
    tokens = state.tokens[:, :Sp + max_new]
    return state._replace(
        tokens=tokens,
        behavior_logp=state.behavior_logp[:, :Sp + max_new],
        done=(tokens[:, Sp:] == EOS).any(dim=-1))


def generate(params, cfg, prompts, *, max_new: int, key,
             temperature: float = 1.0, chunk: int = 0,
             dtype=torch.float32, extra=None, tp=None) -> RolloutState:
    """Full rollout = start + ceil(max_new/chunk) resumable chunks, every
    chunk of the same ``chunk`` steps, sliced back to ``prompt + max_new``
    (the reference's bucketing).  ``extra`` goes to ``start_rollout``,
    ``tp`` to each step."""
    B, Sp = prompts.shape
    if max_new <= 0:
        return start_rollout(params, cfg, prompts, Sp, dtype=dtype,
                             extra=extra, tp=tp)
    chunk = chunk or max_new
    n_chunks = -(-max_new // chunk)
    state = start_rollout(params, cfg, prompts, Sp + n_chunks * chunk,
                          dtype=dtype, extra=extra, tp=tp)
    for _ in range(n_chunks):
        key, sub = prng.split(key)
        state = rollout_chunk(params, cfg, state, sub, n_steps=chunk,
                              temperature=temperature, tp=tp)
    return finalize_rollout(state, max_new)


def action_mask(state: RolloutState) -> torch.Tensor:
    """1.0 on generated (non-PAD) positions after the prompt."""
    T = state.tokens.shape[1]
    gen = torch.arange(T, device=state.tokens.device)[None, :] \
        >= state.prompt_len
    return (gen & (state.tokens != PAD)).float()


# ------------------------------------------- continuous-batching slot pool -
#
# The engine (``repro_torch.rl.engine``) decodes a pool of rows at
# divergent positions: ``cache["pos"]`` becomes a [R] int32 tensor of
# per-row cursors, rows are admitted into freed slots by a B = 1 prefill
# (``admit_row`` for the dense ring, ``admit_row_paged`` for the paged
# arena), and finished rows keep ticking harmlessly until their slot is
# reused: their cursor clamps onto the ring's spare slot, or onto the page
# table's trailing trash entry.  Unlike the reference's pure functions,
# these update the pool state in place and return it.

@torch.no_grad()
def start_row_pool(cfg, n_rows: int, total_len: int, prompt_len: int, *,
                   device, kv_layout: str = "dense", kv_page_size: int = 0,
                   kv_pages: int = 0) -> RolloutState:
    """Empty slot-pool state: every row starts done (a free slot) with its
    cursor at 0; rows get content only through an admission.  The KV
    cache is fp32, as the reference's default.

    ``kv_layout="paged"`` swaps the dense per-row ring (``total_len + 1``
    slots, the last a spare for finished rows) for the paged arena:
    ``kv_pages`` shared pages of ``kv_page_size`` slots (defaults: 16, and
    enough pages for every row) and a page table a row, every table
    starting on the trash page."""
    assert_engine_cache(cfg, kv_layout)
    if kv_layout == "paged":
        page_size = int(kv_page_size) or 16
        n_pages = int(kv_pages) or n_rows * paged_blocks(total_len, page_size)
        cache = init_cache(cfg, n_rows, total_len, torch.float32,
                           device=device, layout="paged",
                           page_size=page_size, n_pages=n_pages)
    else:
        cache = init_cache(cfg, n_rows, total_len + 1, torch.float32,
                           device=device)
    cache["pos"] = torch.zeros(n_rows, dtype=torch.int32, device=device)
    return RolloutState(
        tokens=torch.zeros((n_rows, total_len), dtype=torch.int32,
                           device=device),
        behavior_logp=torch.zeros((n_rows, total_len), dtype=torch.float32,
                                  device=device),
        cache=cache,
        last_logits=torch.zeros((n_rows, cfg.vocab), dtype=torch.float32,
                                device=device),
        done=torch.ones(n_rows, dtype=torch.bool, device=device),
        prompt_len=prompt_len)


@torch.no_grad()
def admit_row(state: RolloutState, row: RolloutState, slot: int
              ) -> RolloutState:
    """Graft a freshly prefilled single-row state (``start_rollout`` on a
    [1, Sp] prompt with ``cache_len = total_len + 1``) into pool row
    ``slot`` of a dense pool, in place."""
    state.tokens[slot] = row.tokens[0]
    state.behavior_logp[slot] = row.behavior_logp[0]
    state.last_logits[slot] = row.last_logits[0].to(state.last_logits.dtype)
    stitch_cache_row(state.cache, row.cache, slot)
    state.done[slot] = False
    return state


@torch.no_grad()
def admit_row_paged(params, cfg, state: RolloutState, prompt, pages_row,
                    slot: int, *, n_cached: int) -> RolloutState:
    """Admit one prompt row into a paged pool, in place: prefill only the
    suffix past the ``n_cached`` radix-cached prompt tokens, reading the
    cached prefix KVs out of the shared pages.

    prompt: [1, Sp] int; pages_row: [max_blocks + 1] int32 physical pages
    of the row (the last entry the trash page), on the pool's device;
    ``n_cached`` is block-aligned and < Sp.  The suffix KVs go only to the
    row's fresh pages (blocks >= n_cached / P), never to a shared one.
    With ``n_cached == 0`` this is a full prefill, whose logits and KVs
    equal the dense ``start_rollout`` graft's bit for bit."""
    Sp = prompt.shape[1]
    cache = state.cache
    P = cache["segments"][0]["k"].shape[2]
    ncb = n_cached // P
    assert n_cached == ncb * P and n_cached < Sp, (n_cached, P, Sp)
    pre = pages_row[:ncb].long()
    prefix_kvs = []
    for seg in cache["segments"]:
        L, tail = seg["k"].shape[0], seg["k"].shape[3:]
        prefix_kvs.append(
            (seg["k"][:, pre].reshape(L, 1, n_cached, *tail),
             seg["v"][:, pre].reshape(L, 1, n_cached, *tail)))
    x = bb._embed(params, cfg, prompt[:, n_cached:])
    x, kv_segs = _extend_collect(params, cfg, x, prefix_kvs, n_cached)
    last_logits = bb._logits(params, cfg, x[:, -1])

    pos_sfx = n_cached + torch.arange(Sp - n_cached, device=prompt.device)
    pg = pages_row[pos_sfx // P].long()
    off = pos_sfx % P
    for seg, (ks, vs) in zip(cache["segments"], kv_segs):
        seg["k"][:, pg, off] = ks[:, 0].to(seg["k"].dtype)
        seg["v"][:, pg, off] = vs[:, 0].to(seg["v"].dtype)
    state.tokens[slot] = 0
    state.tokens[slot, :Sp] = prompt[0]
    state.behavior_logp[slot] = 0.0
    cache["pos"][slot] = Sp
    cache["page_table"][slot] = pages_row
    state.last_logits[slot] = last_logits[0].to(state.last_logits.dtype)
    state.done[slot] = False
    return state


@torch.no_grad()
def release_row(state: RolloutState, slot: int) -> RolloutState:
    """Remap a harvested row's page table to the trash page, in place, so
    its zombie decode writes (the slot keeps ticking until readmitted)
    never land in pages the allocator may hand to another row.  Every
    segment's arena has the same pages, so one table serves them all."""
    trash = state.cache["segments"][0]["k"].shape[1] - 1
    state.cache["page_table"][slot] = trash
    return state


@torch.no_grad()
def rollout_rows_chunk(params, cfg, state: RolloutState, key, *,
                       n_steps: int, temperature: float = 1.0
                       ) -> RolloutState:
    """``rollout_chunk`` with per-row cursors: each row samples and writes
    at its own ``cache["pos"][r]``.  Done (or free) rows emit PAD and clamp
    their cursor at ``total_len`` -- the ring's spare slot -- or, in a
    paged pool, at ``max_blocks * page_size``, whose block index selects
    the table's trailing trash entry.  The reference drops a token write
    at a column >= ``total_len``; torch's ``index_put`` has no drop mode
    (out of range it raises, or asserts on the device), so such a row
    rewrites its last column with the value already there.  Updates the
    state in place; nothing here waits on the card."""
    B, T = state.tokens.shape
    cache = state.cache
    table = cache.get("page_table")
    clamp = T if table is None else \
        (table.shape[1] - 1) * cache["segments"][0]["k"].shape[2]
    rows = torch.arange(B, device=state.tokens.device)
    tokens, blp = state.tokens, state.behavior_logp
    logits, done = state.last_logits, state.done
    for k in prng.split(key, n_steps):
        tok, lp = _sample(logits, k, temperature)
        tok = torch.where(done, PAD, tok)
        lp = torch.where(tok == PAD, 0.0, lp)
        done = done | (tok == EOS)
        col = cache["pos"]
        keep = col < T
        colc = torch.clamp(col, max=T - 1).long()
        tokens[rows, colc] = torch.where(keep, tok, tokens[rows, colc])
        blp[rows, colc] = torch.where(keep, lp, blp[rows, colc])
        logits, cache = decode_step(params, cfg, cache, tok[:, None])
        cache["pos"] = torch.clamp(cache["pos"], max=clamp)
    return RolloutState(tokens=tokens, behavior_logp=blp, cache=cache,
                        last_logits=logits, done=done,
                        prompt_len=state.prompt_len)

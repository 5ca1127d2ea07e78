"""Paged-attention decode: one query token per row over that row's page
table into a shared KV arena.

Replaces the TPU kernel
``repro/kernels/paged_attention.py::paged_attention_kernel`` (body
``_kernel``).  The arena is ``[n_pages + 1, P, K, hd]`` (the last page is
the trash page); row ``b`` owns ``table[b]`` of ``max_blocks + 1`` page
ids, logical block ``j`` living in page ``table[b, j]``; ``pos[b]`` is the
row's decode cursor, and the row attends to columns ``col <= pos`` (and
``col > pos - window`` with a window) of its ``max_blocks * P`` logical
columns.

``paged_attention_plain`` gathers the row's pages into a [B, S, K, hd]
tensor and runs the dense per-row ``gqa_decode`` arithmetic op for op
(the same einsum strings, ``.float()`` casts, ``NEG_INF``, softmax and
``probs.to(v.dtype)``), so paged decode equals dense decode bit for bit
on the CPU, as the reference's ``paged_attention_ref`` does for JAX.

CUDA kernel (``csrc/paged_attention.cu``): the grid is (row x kv head,
split), where split ``s`` owns the logical columns ``[s span, (s + 1)
span)``; ``split_plan`` sets ``span``, a multiple of P, from the table's
width, the batch and the card's SM count, never from ``pos``.  A split
with no valid column exits; within a split, 32-column K and V tiles come
by 16-byte ``cp.async`` in the arena's dtype into a two-buffer ring,
each column's page id loaded from the table as it goes, so a page past
the cursor, or wholly below the window, is never read, and each page
that is read is read once for all ``g = H / K`` query heads of the
block.  A row whose columns lie in one split is written by that block;
otherwise the splits' (m, l, acc) go to an fp32 workspace and the last
split to finish merges them by log-sum-exp, the rule
``paged_attention_split_plain`` spells out.  Masked columns score -1e30
and their p is re-zeroed under the mask, the denominator is floored at
1e-30, as in the reference.  It reads each needed K and V element once
and does 4 g hd operations a column and kv head, so it is bound by bytes
and, at small batch, by latency.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.online import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192)    # 192: nemotron-4-340b
MAX_GROUP = 16          # query heads per kv head the kernel holds


def paged_attention_plain(q, arena_k, arena_v, page_table, pos, *,
                          window: int = 0):
    """q: [B, H, hd]; arena_[kv]: [n_pages + 1, P, K, hd]; page_table:
    [B, max_blocks + 1] int (last entry trash, unread); pos: [B] int ->
    [B, H, hd] in the arena's dtype.  Gather-then-attend, the arithmetic
    of the dense per-row ``gqa_decode``."""
    B, H, hd = q.shape
    P, K = arena_k.shape[1], arena_k.shape[2]
    mb = page_table.shape[1] - 1
    S = mb * P
    idx = page_table[:, :mb].long()
    ks = arena_k[idx].reshape(B, S, K, hd)
    vs = arena_v[idx].reshape(B, S, K, hd)
    qh = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh.float(),
                          ks.float()) * hd ** -0.5
    cols = torch.arange(S, device=q.device)
    posb = pos[:, None]
    mask = cols[None, :] <= posb
    if window:
        mask &= cols[None, :] > posb - window
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    y = torch.einsum("bkgqs,bskh->bqkgh", probs.to(vs.dtype), vs)
    return y.reshape(B, H, hd)


def paged_attention_split_plain(q, arena_k, arena_v, page_table, pos, *,
                                window: int = 0, span: int):
    """``paged_attention_plain`` computed as the kernel splits it: each
    split of ``span`` logical columns attends its valid columns alone,
    in fp32, to (m, l, acc); the splits that hold a valid column merge by
    log-sum-exp.  Masked columns score NEG_INF with p re-zeroed under the
    mask, and the denominator is floored at 1e-30.  For tests: it states
    the merge rule the kernel follows, at any span."""
    B, H, hd = q.shape
    P, K = arena_k.shape[1], arena_k.shape[2]
    mb = page_table.shape[1] - 1
    S = mb * P
    idx = page_table[:, :mb].long()
    ks = arena_k[idx].reshape(B, S, K, hd).float()
    vs = arena_v[idx].reshape(B, S, K, hd).float()
    qh = q.reshape(B, K, H // K, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qh, ks) * hd ** -0.5
    cols = torch.arange(S, device=q.device)
    posb = pos.long()[:, None]
    mask = cols[None, :] <= posb
    if window:
        mask &= cols[None, :] > posb - window
    mask = mask[:, None, None, :]
    parts = []
    for c0 in range(0, S, span):
        sl = slice(c0, min(S, c0 + span))
        valid = mask[..., sl]
        sc = torch.where(valid, scores[..., sl], NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        acc = torch.einsum("bkgs,bskh->bkgh", p, vs[:, sl])
        parts.append((m, p.sum(dim=-1), acc, valid.any(dim=-1)))
    m_all = torch.stack([m for m, _, _, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc, live in parts:
        # a split with no valid column contributes nothing, though
        # exp(-1e30 - (-1e30)) = 1 where every split is empty
        a = torch.where(live, torch.exp(m - m_all), 0.0)
        num = num + a[..., None] * acc
        den = den + a * l
    y = num / den.clamp(min=1e-30)[..., None]
    return y.reshape(B, H, hd).to(arena_k.dtype)


# the blocks a card should hold at once, per SM: enough splits that the
# engine's 32 rows fill it
BLOCKS_PER_SM = 8
_PLANS: dict = {}


def split_plan(B: int, K: int, mb: int, P: int, n_sm: int):
    """(span, n_splits): the columns a split owns, a multiple of P, and
    the splits that cover the table's ``mb * P`` columns, aiming at
    ``BLOCKS_PER_SM * n_sm`` blocks over the ``B * K`` (row, kv head)
    pairs.  Shapes only: it never reads ``pos``."""
    S = mb * P
    want = -(-BLOCKS_PER_SM * n_sm // (B * K))
    span = P * -(-(-(-S // want)) // P)
    return span, -(-S // span)


_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8
         + (ctypes.c_longlong,) * 3
         + (ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p))


def paged_attention_cuda(q, arena_k, arena_v, page_table, pos, *,
                         window: int = 0):
    """The CUDA kernel on CUDA tensors: q [B, H, hd] (fp32 or bf16, unit
    head-dim stride), contiguous arenas of one dtype (fp32 or bf16),
    page_table [B, max_blocks + 1] and pos [B] int32.  Returns [B, H, hd]
    in the arena's dtype, as the plain version does.  Shapes the kernel
    does not take raise ``NotImplementedError``."""
    ts = (q, arena_k, arena_v, page_table, pos)
    if not all(t.is_cuda for t in ts):
        raise ValueError("paged_attention_cuda takes CUDA tensors")
    if q.dim() != 3 or arena_k.dim() != 4 or arena_k.shape != arena_v.shape:
        raise ValueError("paged_attention_cuda: q [B, H, hd], arenas "
                         "[n_pages + 1, P, K, hd]")
    B, H, hd = q.shape
    _, P, K, hd_kv = arena_k.shape
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.shape[1] < 2 or pos.shape != (B,):
        raise ValueError(f"paged_attention_cuda: table "
                         f"{tuple(page_table.shape)}, pos {tuple(pos.shape)}"
                         f" for {B} rows")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention_cuda: table and pos must be int32")
    if q.dtype not in _DTYPES or arena_k.dtype not in _DTYPES \
            or arena_v.dtype != arena_k.dtype:
        raise ValueError(f"paged_attention_cuda: q {q.dtype}, arenas "
                         f"{arena_k.dtype}/{arena_v.dtype}")
    if hd_kv != hd or H % K or hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise NotImplementedError(
            f"paged_attention_cuda: H {H}, K {K}, hd {hd} (kv hd {hd_kv}); "
            f"the kernel takes hd in {HEAD_DIMS} and at most {MAX_GROUP} "
            "query heads per kv head")
    if not (arena_k.is_contiguous() and arena_v.is_contiguous()) \
            or arena_k.data_ptr() % 16 or arena_v.data_ptr() % 16 \
            or q.stride(2) != 1 or page_table.stride(1) != 1 \
            or pos.stride(0) != 1:
        raise ValueError("paged_attention_cuda needs contiguous, 16-byte "
                         "aligned arenas and unit inner strides on q, table "
                         "and pos")
    out = torch.empty((B, H, hd), dtype=arena_k.dtype, device=q.device)
    if B == 0:
        return out
    mb = page_table.shape[1] - 1
    key = (q.device, B, K, mb, P)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = split_plan(B, K, mb, P,
                                        build.sm_count(q.device))
    span, n_splits = plan
    ws = count = None
    if n_splits > 1:
        # each split's (m [g], l [g], acc [g, hd]); merged by the last
        ws = build.scratch("paged_attention partials", q.device,
                           B * K * n_splits * (H // K) * (hd + 2),
                           torch.float32).data_ptr()
        count = build.scratch("paged_attention counters", q.device, B * K,
                              torch.int32).data_ptr()
    fn = build.c_function("paged_attention", "paged_attention_launch", _ARGS)
    err = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             ws, count,
             _DTYPES[q.dtype], _DTYPES[arena_k.dtype], B, H, K, hd, P, mb,
             q.stride(0), q.stride(1), page_table.stride(0), int(window),
             hd ** -0.5, span, n_splits,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err)
    return out

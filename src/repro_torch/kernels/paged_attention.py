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

CUDA kernel (``csrc/paged_attention.cu``): one block per (row, kv head),
128 threads.  The block walks the row's valid columns ``[lo, min(pos,
S - 1)]`` in tiles of 32, loading each column's page id from the table as
it goes (the Pallas kernel's scalar prefetch), so a page past the cursor,
or wholly below the window, is never read, and each page that is read is
read once for all ``g = H / K`` query heads of the block.  K and V tiles
are staged in fp32 in shared memory; warp ``h`` scores head ``h`` against
the tile's 32 columns, one lane a column, and updates that head's online
softmax (m, l) with warp shuffles; the P V product keeps acc in fp32
registers.  Masked columns score -1e30 and their p is re-zeroed under the
mask, the denominator is floored at 1e-30, as in the reference.  It reads
each needed K and V element once and does 4 g hd operations a column and
kv head, far below the card's rate, so it is bound by bytes.  One block
per (row, kv head) leaves the card under-filled at small batch; splitting
a row's columns across blocks is the next step.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.online import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
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


_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8
         + (ctypes.c_longlong,) * 3
         + (ctypes.c_int, ctypes.c_float, ctypes.c_void_p))


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
    fn = build.c_function("paged_attention", "paged_attention_launch", _ARGS)
    err = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], _DTYPES[arena_k.dtype], B, H, K, hd, P,
             page_table.shape[1] - 1, q.stride(0), q.stride(1),
             page_table.stride(0), int(window), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err)
    return out

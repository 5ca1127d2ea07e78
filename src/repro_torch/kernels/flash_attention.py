"""Causal GQA flash attention, forward, and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(body ``_kernel``).  The plain version is ``chunked_attention``, the
reference model's query-block attention (``repro/models/attention.py``),
which the CPU path and the kernel's checks on the card use.

CUDA kernels (``csrc/flash_attention.cu``): grid (B*H, query blocks),
heaviest query blocks first; each reads [B, S, H, hd] through strides
(no head-major copy), reads kv head ``h // (H/K)``, walks the keys only
up to the diagonal, masks a ragged S itself, and keeps the online
softmax (m, l, acc) in fp32 with masked scores at -1e30 and the
denominator floored at 1e-30, as the reference does.  At
[4, 2048, 32, 8, 128] the work is about 137 GFLOP, so it is bound by
operations: about 139 us at the H100's 989 TFLOP/s bf16 tensor rate.

- bf16: FlashAttention-2's walk on Hopper's warpgroup products
  (``wgmma``).  A block is three warpgroups of 64 query rows sharing
  each 64-key tile of K and V, which ``cp.async`` double-buffers in
  shared memory; q k^T and P V are ``wgmma`` with q, and P rounded to
  bf16, as register operands (``chunked_attention`` rounds its
  probabilities to bf16 before the PV product too) and K and V read by
  descriptor.  Only a warpgroup's diagonal tile is masked.  Head dims
  16, 32, 64, 112 (Zamba2's shared block, P V as m64n112k16), 128 and
  192; at hd 192 a block is two warpgroups, so a thread may hold its 176
  registers of q fragments, accumulator and scores without spilling.
- fp32: the first, SIMT kernel on the fp32 cores (four threads to a
  query row, 32-key tiles), kept because tensor cores in fp32 mean TF32
  and the fp32 checks hold 1e-5 and 1e-4.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.online import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 192)


def _block_attend(q, k, v, row_pos, col_pos, window: int = 0,
                  causal: bool = True):
    """q: [B, bq, K, g, hd]; k/v: [B, Sk, K, hd]; with ``causal`` a key
    past its query's absolute position is masked, and with ``window`` a
    key more than ``window - 1`` positions behind it too.  Scores and
    softmax in fp32, probs cast to v's dtype before the PV product, as
    the reference does."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = col_pos[None, :] <= row_pos[:, None]
    if window:
        near = col_pos[None, :] > row_pos[:, None] - window
        mask = near if mask is None else mask & near
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      block_q: int = 512, q_offset: int = 0):
    """Attention over query blocks: q: [B, Sq, H, hd], k/v: [B, Sk, K,
    hd] -> [B, Sq, H, hd]; live scores are [B, K, g, block_q, Sk] rather
    than [B, H, S, S].  ``q_offset`` is the absolute position of q[0]
    over keys at positions 0 .. Sk - 1 (a prefill continuation over a
    cached prefix).  ``causal=False`` masks nothing: an encoder's
    self-attention, or cross attention of Sq decoder queries over Sk
    encoder frames (Sq may be 1, a decode step).

    With a sliding ``window`` and ``Sk > window + block_q``, each query
    block reads only a ``window + block_q`` span of keys, the reference's
    slice (its start clipped to [0, Sk - span]), so the work is
    O(Sq * window)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    q5 = q.reshape(B, Sq, K, H // K, hd)
    col_pos = torch.arange(Sk, device=q.device)
    block_q = min(block_q, Sq)
    span = window + block_q if window and Sk > window + block_q else Sk
    outs = []
    for qs in range(0, Sq, block_q):
        qi = q5[:, qs:qs + block_q]
        row_pos = q_offset + qs + torch.arange(qi.shape[1], device=q.device)
        start = min(max(q_offset + qs + block_q - span, 0), Sk - span)
        outs.append(_block_attend(qi, k[:, start:start + span],
                                  v[:, start:start + span], row_pos,
                                  col_pos[start:start + span], window,
                                  causal))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, v.shape[-1])


_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
         + (ctypes.c_longlong,) * 12 + (ctypes.c_float, ctypes.c_void_p))


def flash_attention_cuda(q, k, v):
    """The CUDA kernel: q [B, S, H, hd], k/v [B, S, K, hd] CUDA tensors of
    one dtype (fp32 or bf16) with unit stride on the head dim.  Causal.
    Returns [B, S, H, hd] in q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda: q, k, v must share fp32 or "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: q [B,S,H,hd], k/v [B,S,K,hd]")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % K:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs unit head-dim stride")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = build.c_function("flash_attention", "flash_attention_launch", _ARGS)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], B, S, H, K, hd, *strides, hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    return o

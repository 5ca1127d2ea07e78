"""Fused Gumbel-max sampling: categorical draw + the chosen token's
log-prob in one pass over the vocabulary.

Replaces the TPU kernel ``repro/kernels/fused_sample.py::fused_sample``
(body ``_kernel``).  The noise is a counter-based hash of the key words at
the absolute (row, col) position, so the CUDA kernel, the plain streamed
version and the dense oracle draw identical tokens under one key.

CUDA kernel (``csrc/fused_sample.cu``): bound by instruction issue, not
bytes.  [16, 128256] bf16 is 4.1 MB, about 1.2 us at 3.35 TB/s, but each
logit costs about 78 instructions (the hash, two accurate logs for the
noise, the softmax update, the running argmax), so one block per row
kept 16 of an H100's 132 SMs issuing for 53 us.  The grid is therefore
(row, split): ``split_plan`` cuts each row into spans, multiples of 8
columns, so that the blocks fill the card; each split keeps the online
softmax (m, s), the best Gumbel score with its column and its scaled
logit, and the last split of a row to arrive (an atomic counter in
``build.scratch``, which it resets) merges the row's partials in split
order, in the same launch.  ``fused_sample_split_plain`` states that
merge in plain PyTorch.

On a shard of the vocabulary (tensor-parallel serving) a rank holds the
columns ``[col0, col0 + V)`` of rows ``[row0, row0 + B)`` of the whole
draw: the kernel keys the noise by the absolute position and, in its
partial mode (``fused_sample_partial_cuda``), writes each row's merged
partial ``(M, s, z, col, x)`` in place of (token, log-prob).
``merge_partials`` merges the ranks' partials in rank order by the rule
the kernel merges its splits with, so the tokens are the whole row's bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.online import NEG_INF, online_softmax_step, \
    stream_tile

_M = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def key_data_u32(key):
    """The two uint32 words of a key (an ``rl.prng`` key: int64 [2] holding
    32-bit values) as Python ints, which the hash and the kernel take."""
    # one tolist of the whole key: a reshape and a slice first would add
    # two tensor operations of host time to every sampling call
    words = key.tolist() if key.dim() == 1 else key.reshape(-1).tolist()
    return int(words[0]) & _M, int(words[1]) & _M


def _mul32(x, c: int):
    """x * c mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def _mix(x):
    """splitmix32-style finalizer on 32-bit words held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(rows, cols, k0: int, k1: int):
    """Position-keyed uniform in (0, 1), bit for bit the reference's
    ``hash_uniform``: rows and cols are mixed in two stages, and the top
    24 bits become the mantissa exactly."""
    x = _mix((_mul32(rows.long(), 0x9E3779B9) + k0) & _M)
    x = _mix((x + _mul32(cols.long(), 0x85EBCA6B) + k1) & _M)
    mant = (x >> 8).float()
    return (mant + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(rows, cols, k0: int, k1: int):
    """Standard Gumbel at absolute positions (rows, cols) of a [B, V] draw."""
    return -torch.log(-torch.log(hash_uniform(rows, cols, k0, k1)))


def fused_sample_plain(logits, key, temperature: float, block_v: int = 2048,
                       *, row0: int = 0):
    """Streamed Gumbel-max over vocab tiles: the same online (m, s) and
    running-argmax recurrence as the kernel (the reference's
    ``dispatch._sample_stream_jnp``).  ``row0`` is the absolute row of
    the first row, which keys its noise.  Returns (tokens [B] int32,
    logprob [B] fp32)."""
    B, V = logits.shape
    dev = logits.device
    bv = min(block_v, V)
    k0, k1 = key_data_u32(key)
    inv = 1.0 / temperature if temperature > 0.0 else 1.0
    rows = (torch.arange(B, device=dev) + row0)[:, None].expand(B, bv)
    m = torch.full((B,), NEG_INF, device=dev)
    s = torch.zeros(B, device=dev)
    best = torch.full((B,), float("-inf"), device=dev)
    btok = torch.zeros(B, dtype=torch.int64, device=dev)
    blog = torch.full((B,), NEG_INF, device=dev)
    for j in range(-(-V // bv)):
        tile, start, cols, valid = stream_tile(logits, j, bv)
        tile = tile * inv
        m, s, z = online_softmax_step(m, s, tile, valid)
        if temperature > 0.0:
            z = z + gumbel_noise(rows, cols[None].expand(B, bv), k0, k1)
        z = torch.where(valid, z, float("-inf"))
        arg = torch.argmax(z, dim=-1)
        tile_best = z.gather(1, arg[:, None])[:, 0]
        # strict > keeps the earliest tile on ties -> global first argmax
        better = tile_best > best
        chosen = tile.gather(1, arg[:, None])[:, 0]
        btok = torch.where(better, start + arg, btok)
        blog = torch.where(better, chosen, blog)
        best = torch.maximum(best, tile_best)
    return btok.int(), (blog - m) - torch.log(s)


def fused_sample_split_plain(logits, key, temperature: float, span: int, *,
                             col0: int = 0, row0: int = 0,
                             partial: bool = False):
    """``fused_sample_plain`` computed as the kernel splits it: split ``i``
    owns the columns ``[i span, (i + 1) span)`` and keeps its (m_i, s_i),
    m_i floored at -1e30 as the online max is, and its first best z_i
    with that column and scaled logit x_i; then ``merge_partials``: M =
    max m_i, s = the sum of s_i exp(m_i - M) in split order, the token
    that of the first split with the largest z (ties to the lower split),
    and the log-prob (x - M) - log s.  ``logits`` may be the columns
    ``[col0, col0 + V)`` of rows ``[row0, row0 + B)`` of a whole draw: the
    noise and the columns are then the absolute ones.  For tests: it
    states the merge rule the kernel follows, at any span.  Returns
    (tokens [B] int32, logprob [B] fp32), or with ``partial`` the rows'
    merged partials [B, 5] (``merge_partials``), as the kernel's partial
    mode writes them."""
    B, V = logits.shape
    dev = logits.device
    k0, k1 = key_data_u32(key)
    inv = 1.0 / temperature if temperature > 0.0 else 1.0
    scaled = logits.float() * inv
    rows = torch.arange(B, device=dev)[:, None] + row0
    parts = []
    for c0 in range(0, V, span):
        x = scaled[:, c0:c0 + span]
        cols = torch.arange(col0 + c0, col0 + c0 + x.shape[1],
                            device=dev)[None]
        m = torch.clamp(x.amax(dim=-1), min=NEG_INF)
        s = torch.exp(x - m[:, None]).sum(dim=-1)
        z = x
        if temperature > 0.0:
            z = x + gumbel_noise(rows.expand_as(x), cols.expand_as(x), k0,
                                 k1)
        arg = torch.argmax(z, dim=-1, keepdim=True)
        parts.append(torch.stack([m, s, z.gather(1, arg)[:, 0],
                                  (col0 + c0 + arg[:, 0]).float(),
                                  x.gather(1, arg)[:, 0]], dim=-1))
    merged = _merge(torch.stack(parts))
    if partial:
        return merged
    return _result(merged)


def _merge(parts):
    """Partials [n, B, 5] of (m, s, z, col, x), in column order, merged
    into one [B, 5]: M = max m, s = the sum of s_i exp(m_i - M) in order,
    and the (z, col, x) of the first partial with the largest z (strict
    >: an earlier partial, which holds lower columns, keeps a tie); col
    -1 and x -1e30 where no z beat -inf."""
    B = parts.shape[1]
    dev = parts.device
    M = parts[:, :, 0].amax(dim=0)
    s = torch.zeros(B, device=dev)
    best = torch.full((B,), float("-inf"), device=dev)
    bcol = torch.full((B,), -1.0, device=dev)
    blog = torch.full((B,), NEG_INF, device=dev)
    for m, si, z, col, x in (p.unbind(-1) for p in parts):
        s = s + si * torch.exp(m - M)
        better = z > best
        bcol = torch.where(better, col, bcol)
        blog = torch.where(better, x, blog)
        best = torch.where(better, z, best)
    return torch.stack([M, s, best, bcol, blog], dim=-1)


def _result(merged):
    """(tokens [B] int32, logprob [B] fp32) of merged partials [B, 5]: the
    kept column (0 where none), and (x - M) - log s, M subtracted
    first."""
    M, s, _, col, x = merged.unbind(-1)
    return torch.clamp(col, min=0).int(), (x - M) - torch.log(s)


def merge_partials(parts):
    """The draw of rows whose columns are split in order over ranks:
    ``parts`` [R, B, 5] holds each rank's merged partial (the kernel's
    partial mode, or ``fused_sample_split_plain(partial=True)``), rank
    r's columns all below rank r + 1's.  The ranks merge as the kernel
    merges its splits, so the tokens equal the whole row's draw bit for
    bit and the log-probs agree to fp32 rounding of the sum of s.
    Returns (tokens [B] int32, logprob [B] fp32)."""
    return _result(_merge(parts))


# csrc/fused_sample.cu: a block's threads, and the most splits a row may
# have (its merge gives each split one thread)
THREADS = 256
MAX_SPLITS = 256
# spans are multiples of 8 columns, so 16-byte loads of bf16 stay aligned
SPAN_ALIGN = 8
# no split smaller than one pass of a block's 16-byte bf16 loads
MIN_SPAN = 8 * THREADS
# the blocks a call aims at, per SM
BLOCKS_PER_SM = 2
_PLANS: dict = {}


def split_plan(B: int, V: int, n_sm: int):
    """(span, n_splits): the columns a split owns, a multiple of
    ``SPAN_ALIGN``, and the splits that cover a row of ``V`` columns, so
    that the ``B * n_splits`` blocks come to at most ``BLOCKS_PER_SM *
    n_sm`` (at least one split a row), no split is empty, and none is
    below ``MIN_SPAN`` unless the row is.  The launcher refuses any other
    plan."""
    want = max(1, min(MAX_SPLITS, BLOCKS_PER_SM * n_sm // B,
                      V // MIN_SPAN))
    span = SPAN_ALIGN * -(-(-(-V // want)) // SPAN_ALIGN)
    return span, -(-V // span)


_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
# fused_sample_launch_at: _ARGS with row0 and col0 after the splits, and
# the partials' pointer before the stream
_AT_ARGS = _ARGS[:11] + (ctypes.c_longlong, ctypes.c_longlong) \
    + _ARGS[11:15] + (ctypes.c_void_p, ctypes.c_void_p)
PART = 5


def _launch(logits, key, temperature: float, *, row0: int, col0: int,
            partial: bool):
    """One launch of the kernel on a [B, V] CUDA tensor (fp32 or bf16,
    unit column stride, any row stride), cut by ``split_plan``, cached
    per (device, B, V).  Returns (tokens, logprob), or the rows' merged
    partials [B, 5] with ``partial``."""
    if not logits.is_cuda or logits.dim() != 2:
        raise ValueError("fused_sample_cuda takes a 2-D CUDA tensor, got "
                         f"{tuple(logits.shape)} on {logits.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"fused_sample_cuda: unsupported {logits.dtype}")
    if logits.stride(1) != 1:
        raise ValueError("fused_sample_cuda needs unit column stride")
    B, V = logits.shape
    k0, k1 = key_data_u32(key)
    dev = logits.device
    if partial:
        part = torch.empty((B, PART), dtype=torch.float32, device=dev)
        tok = lp = None
    else:
        part = None
        tok = torch.empty(B, dtype=torch.int32, device=dev)
        lp = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return part if partial else (tok, lp)
    if V == 0:
        raise ValueError("fused_sample_cuda: a row of no columns")
    plan = _PLANS.get((dev, B, V))
    if plan is None:
        plan = _PLANS[dev, B, V] = split_plan(B, V, build.sm_count(dev))
    span, n_splits = plan
    ws = count = None
    if n_splits > 1:
        # each split's (m, s, z, col, x); the last of a row merges them
        ws = build.scratch("fused_sample partials", dev, B * n_splits * 5,
                           torch.float32).data_ptr()
        count = build.scratch("fused_sample counters", dev, B,
                              torch.int32).data_ptr()
    fn = build.c_function("fused_sample", "fused_sample_launch_at",
                          _AT_ARGS)
    noisy = temperature > 0.0
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], B, V, logits.stride(0),
             k0, k1, 1.0 / temperature if noisy else 1.0, int(noisy), span,
             n_splits, row0, col0, ws, count,
             None if partial else tok.data_ptr(),
             None if partial else lp.data_ptr(),
             part.data_ptr() if partial else None,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("fused_sample", err)
    return part if partial else (tok, lp)


def fused_sample_cuda(logits, key, temperature: float, *, row0: int = 0):
    """The CUDA kernel on a [B, V] CUDA tensor (fp32 or bf16, unit column
    stride, any row stride), the rows ``[row0, row0 + B)`` of a draw.
    Returns (tokens [B] int32, logprob [B] fp32)."""
    return _launch(logits, key, temperature, row0=row0, col0=0,
                   partial=False)


def fused_sample_partial_cuda(logits, key, temperature: float, *,
                              col0: int, row0: int = 0):
    """The kernel in its partial mode on a shard of a draw: ``logits``
    [B, V] on the card holds the columns ``[col0, col0 + V)`` of rows
    ``[row0, row0 + B)``.  Returns each row's merged partial [B, 5] fp32
    (M, s, z, col, x), ``fused_sample_split_plain(partial=True)``'s, for
    ``merge_partials``."""
    return _launch(logits, key, temperature, row0=row0, col0=col0,
                   partial=True)

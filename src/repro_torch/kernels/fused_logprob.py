"""Fused per-token log-prob: ``log_softmax(logits)[token]`` without a
[T, V] intermediate, and its backward.

The forward replaces the TPU kernel
``repro/kernels/fused_logprob.py::fused_logprob`` (body ``_kernel``).
Both versions return ``(logp, m, s)`` with ``logZ = m + log s``: the
online stats are the residuals the backward rebuilds the softmax from.

CUDA kernel (``csrc/fused_logprob.cu``): one block per row; threads stride
over the vocabulary with 16-byte loads keeping the online (m, s), a block
reduction merges them, and the target logit is read once.  It reads each
logit once, so it is bound by bytes: 1264 x 128256 bf16 logits (the
reference scorer's batch) are 324 MB, about 97 us at 3.35 TB/s.  Rows are
addressed through two strides, so the scorer's ``logits[:, :-1]`` view is
read in place and never copied.

The backward replaces ``fused_logprob_bwd`` (body ``_bwd_kernel``):
``dlogits = g * (onehot(token) - softmax)``, the softmax rebuilt from
``(m, log s)``.  CUDA kernel (``csrc/fused_logprob_bwd.cu``): one block
per row, no reduction, 16-byte loads and stores.  It reads each logit once
and writes each gradient once, so it is bound by bytes: for the trainer's
``logits[:, :-1]`` of [16, 80, 128256] bf16 it reads the 324 MB view and
writes the 328 MB gradient of the whole [16, 80, V] tensor (zeros in the
last position), about 0.20 ms at 3.35 TB/s.  Writing the full tensor lets
autograd pass it to the logits as it is: returning a [16, 79, V] result
instead would make the slice's backward zero-fill a [16, 80, V] buffer and
copy the result into it, another 328 MB written and 324 MB read and
written.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.online import NEG_INF, online_softmax_step, \
    stream_tile

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_logprob_plain(logits, tokens, block_v: int = 2048):
    """Streamed log pi(token) over [T, bv] vocab tiles with online (m, s)
    (the reference's ``dispatch._logprob_stream_jnp``).  logits: [T, V];
    tokens: [T].  Returns (logp [T] fp32, m [T], s [T])."""
    T, V = logits.shape
    dev = logits.device
    bv = min(block_v, V)
    tokens = tokens.long()
    m = torch.full((T,), NEG_INF, device=dev)
    s = torch.zeros(T, device=dev)
    tval = torch.full((T,), NEG_INF, device=dev)
    for j in range(-(-V // bv)):
        tile, start, _, valid = stream_tile(logits, j, bv)
        m, s, _ = online_softmax_step(m, s, tile, valid)
        local = (tokens - start).clamp(0, bv - 1)
        vals = tile.gather(1, local[:, None])[:, 0]
        in_blk = (tokens >= start) & (tokens < start + bv)
        tval = torch.where(in_blk, vals, tval)
    # subtract m before log s: with extreme logits (|m| ~ 1e30) the sum
    # m + log s absorbs log s entirely in fp32
    return (tval - m) - torch.log(s), m, s


_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p)


def fused_logprob_cuda(logits, tokens):
    """The CUDA kernel.  logits: [T, V] or [B, T, V] CUDA tensor (fp32 or
    bf16) with unit column stride and any row strides; tokens: the leading
    shape.  Returns (logp, m, s), each fp32 in the leading shape."""
    if not logits.is_cuda or logits.dim() not in (2, 3):
        raise ValueError("fused_logprob_cuda takes a 2-D or 3-D CUDA tensor,"
                         f" got {tuple(logits.shape)} on {logits.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"fused_logprob_cuda: unsupported {logits.dtype}")
    if logits.stride(-1) != 1:
        raise ValueError("fused_logprob_cuda needs unit column stride")
    lead = logits.shape[:-1]
    if tuple(tokens.shape) != tuple(lead):
        raise ValueError(f"tokens {tuple(tokens.shape)} vs logits {tuple(lead)}")
    V = logits.shape[-1]
    if logits.dim() == 2:
        inner, outer_stride, inner_stride = lead[0], 0, logits.stride(0)
    else:
        inner, outer_stride, inner_stride = (lead[1], logits.stride(0),
                                             logits.stride(1))
    n_rows = tokens.numel()
    tok = tokens.to(device=logits.device, dtype=torch.int32).contiguous()
    outs = [torch.empty(lead, dtype=torch.float32, device=logits.device)
            for _ in range(3)]
    if n_rows == 0:
        return tuple(outs)
    fn = build.c_function("fused_logprob", "fused_logprob_launch", _ARGS)
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], n_rows, inner,
             outer_stride, inner_stride, V, tok.data_ptr(),
             *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check("fused_logprob", err)
    return tuple(outs)


def fused_logprob_bwd_plain(logits, tokens, m, log_s, g, block_v: int = 2048):
    """Streamed VJP (the reference's ``dispatch._logprob_bwd_stream_jnp``):
    ``g * (onehot - softmax)`` written tile by tile, the softmax rebuilt
    from the saved stats.  logits: [T, V]; tokens, m, log_s, g: [T].
    Returns dlogits [T, V] in the logits' dtype."""
    T, V = logits.shape
    bv = min(block_v, V)
    cols = torch.arange(bv, device=logits.device)
    tokens = tokens.long()
    dl = torch.zeros((T, V), dtype=logits.dtype, device=logits.device)
    for j in range(-(-V // bv)):
        tile, start, _, _ = stream_tile(logits, j, bv)
        p = torch.exp((tile - m[:, None]) - log_s[:, None])
        onehot = cols[None, :] == (tokens - start)[:, None]
        d = (onehot.float() - p) * g[:, None]
        # the clamp overlap recomputes identical values, so the re-write
        # is safe
        dl[:, start:start + bv] = d.to(dl.dtype)
    return dl


_BWD_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)


def fused_logprob_bwd_cuda(logits, tokens, m, log_s, g, n_valid=None):
    """The CUDA backward kernel.

    logits: [T, V] or [B, T, V] CUDA tensor (fp32 or bf16) with unit
    column stride and any row strides.  For 3-D logits the loss saw only
    ``logits[:, :n_valid]`` (``n_valid`` defaults to T); tokens, m, log_s
    and g have that leading shape ([T] for 2-D logits), m, log_s and g in
    fp32.  Returns dlogits: a new contiguous tensor of the logits' full
    shape and dtype, zero in the rows t >= n_valid."""
    if not logits.is_cuda or logits.dim() not in (2, 3):
        raise ValueError("fused_logprob_bwd_cuda takes a 2-D or 3-D CUDA "
                         f"tensor, got {tuple(logits.shape)} on "
                         f"{logits.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"fused_logprob_bwd_cuda: unsupported {logits.dtype}")
    if logits.stride(-1) != 1:
        raise ValueError("fused_logprob_bwd_cuda needs unit column stride")
    V = logits.shape[-1]
    if logits.dim() == 2:
        inner, outer_stride, inner_stride = logits.shape[0], 0, logits.stride(0)
    else:
        inner, outer_stride, inner_stride = (logits.shape[1], logits.stride(0),
                                             logits.stride(1))
    n_valid = inner if n_valid is None else n_valid
    if not 0 <= n_valid <= inner or (logits.dim() == 2 and n_valid != inner):
        raise ValueError(f"fused_logprob_bwd_cuda: n_valid {n_valid} for "
                         f"logits {tuple(logits.shape)}")
    lead = tuple(logits.shape[:-2]) + (n_valid,)
    for name, t in (("tokens", tokens), ("m", m), ("log_s", log_s), ("g", g)):
        if tuple(t.shape) != lead or t.device != logits.device:
            raise ValueError(f"fused_logprob_bwd_cuda: {name} "
                             f"{tuple(t.shape)} on {t.device}, want {lead}")
    stats = [t.to(torch.float32).contiguous() for t in (m, log_s, g)]
    tok = tokens.to(dtype=torch.int32).contiguous()
    dl = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
    if dl.numel() == 0:
        return dl
    fn = build.c_function("fused_logprob_bwd", "fused_logprob_bwd_launch",
                          _BWD_ARGS)
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], dl.numel() // V,
             inner, n_valid, outer_stride, inner_stride, V, tok.data_ptr(),
             *(t.data_ptr() for t in stats), dl.data_ptr(),
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check("fused_logprob_bwd", err)
    return dl

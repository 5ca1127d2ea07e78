"""Fused per-token log-prob: ``log_softmax(logits)[token]`` without a
[T, V] intermediate, and its backward.

The forward replaces the TPU kernel
``repro/kernels/fused_logprob.py::fused_logprob`` (body ``_kernel``).
Both versions return ``(logp, m, s)`` with ``logZ = m + log s``: the
online stats are the residuals the backward rebuilds the softmax from.

CUDA kernel (``csrc/fused_logprob.cu``): bound by bytes, since it reads
each logit once: 1264 x 128256 bf16 logits (the reference scorer's batch)
are 324 MB, about 97 us at 3.35 TB/s, which leaves about 20 instructions
a logit.  Rows are addressed through two strides, so the scorer's
``logits[:, :-1]`` view is read in place and never copied; its rows start
at any phase, so each row is read as a head of fewer than 8 columns up to
its first 16-byte boundary, an aligned body of 16-byte loads and a tail.
The grid is (row, split): ``split_plan`` cuts each row into spans from
its aligned body so that the blocks fill the card in whole waves, or
nearly; each split folds two 16-byte vectors at a time into its online
(m, s) with one rescale and no branch, and the last split of a row to
arrive (an atomic counter in ``build.scratch``, which it resets) merges
the row's partials in split order, in the same launch.
``fused_logprob_split_plain`` states that merge in plain PyTorch.

The backward replaces ``fused_logprob_bwd`` (body ``_bwd_kernel``):
``dlogits = g * (onehot(token) - softmax)``, the softmax rebuilt from
``(m, log s)``.  CUDA kernel (``csrc/fused_logprob_bwd.cu``): no
reduction; the output's rows are cut the same way, in spans of
``BWD_SPAN`` columns (``bwd_plan``), with 16-byte loads and stores in each
row's aligned body.  It reads each logit once and writes
each gradient once, so it is bound by bytes: for the trainer's
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


def row_heads(logits):
    """Each row's head as the CUDA kernels read it: the columns before the
    row's first 16-byte boundary (fewer than ``16 // itemsize``, at most
    V), from the tensor's addresses.  logits: [T, V] or [B, T, V] with
    unit column stride.  Returns int64 in the leading shape."""
    es = logits.element_size()
    vec = 16 // es
    offs = torch.zeros((), dtype=torch.int64)
    for d in range(logits.dim() - 1):
        shape = [1] * (logits.dim() - 1)
        shape[d] = logits.shape[d]
        offs = offs + (torch.arange(logits.shape[d]) * logits.stride(d)) \
            .reshape(shape)
    start = logits.data_ptr() // es + offs
    return ((-start) % vec).clamp(max=logits.shape[-1])


def n_splits_of(V: int, span: int) -> int:
    """The splits a row of ``V`` columns takes at ``span``: boundaries at
    head + i span for i >= 1, as long as the last split keeps a column
    whatever the head (below ``SPAN_ALIGN``)."""
    return 1 + max(0, V - SPAN_ALIGN) // span


def fused_logprob_split_plain(logits, tokens, span: int):
    """``fused_logprob_plain`` computed as the CUDA kernel splits it.  Row
    r's split 0 owns the columns [0, h_r + span), split i > 0 [h_r + i
    span, h_r + (i + 1) span), the last up to V, where h_r is the row's
    head (``row_heads``).  Each split keeps its (m_i, s_i), m_i floored at
    -1e30 as the online max is; then M = max m_i (exact, so equal to the
    plain version's m) and s = the sum of s_i exp(m_i - M) in split order,
    and the log-prob (t - M) - log s, t the target logit (-1e30 outside
    [0, V)).  For tests: it states the merge rule the kernel follows, at
    any span.  logits: [T, V] or [B, T, V]; tokens: the leading shape.
    Returns (logp, m, s), fp32 in the leading shape."""
    lead, V = logits.shape[:-1], logits.shape[-1]
    heads = row_heads(logits).reshape(-1, 1).to(logits.device)
    x = logits.reshape(-1, V).float()
    n = n_splits_of(V, span)
    cols = torch.arange(V, device=x.device)[None]
    M = torch.full((x.shape[0],), NEG_INF, device=x.device)
    parts = []
    for i in range(n):
        # one split's columns at a time: each sum is a reduction of its own
        # (a scatter into the splits would add in atomic order on the card)
        own = ((cols >= heads + i * span) | (i == 0)) \
            & ((cols < heads + (i + 1) * span) | (i == n - 1))
        m_i = torch.where(own, x, NEG_INF).amax(dim=1)
        s_i = torch.where(own, torch.exp(x - m_i[:, None]), 0.0).sum(dim=1)
        parts.append((m_i, s_i))
        M = torch.maximum(M, m_i)
    s = torch.zeros_like(M)
    for m_i, s_i in parts:       # split order
        s = s + s_i * torch.exp(m_i - M)
    toks = tokens.reshape(-1).long().to(x.device)
    valid = (toks >= 0) & (toks < V)
    t = torch.where(valid, x.gather(1, toks.clamp(0, V - 1)[:, None])[:, 0],
                    NEG_INF)
    return tuple(v.reshape(lead) for v in ((t - M) - torch.log(s), M, s))


# csrc/fused_logprob.cu and csrc/fused_logprob_bwd.cu: a block's threads,
# and the blocks an SM holds (__launch_bounds__ holds a thread to 32
# registers, so 8 blocks of 256 fill an SM's 2048 threads)
THREADS = 256
BLOCKS_PER_SM = 8
# the most splits a row may have: the forward's merge gives each one thread
MAX_SPLITS = THREADS
# spans are multiples of 8 columns, so every split but the first starts on
# a 16-byte boundary in bf16 and fp32 alike
SPAN_ALIGN = 8
# no split smaller than one pass of a block's body loop in bf16: two
# 16-byte loads a thread
MIN_SPAN = 2 * 8 * THREADS
# what split_plan charges a block beyond its span, in columns: its start,
# its block merge and, when the row splits, the row's merge
BLOCK_COST = 2048
# the backward's span: its blocks write what they read, and at the
# trainers' shapes spans of 4096 to 8192 columns ran within about 1% of
# each other and 5-20% ahead of whole rows (python -m
# repro_torch.kernels.logprob_sweep, H100 80GB HBM3)
BWD_SPAN = MIN_SPAN
_PLANS: dict = {}


def split_plan(rows: int, V: int, n_sm: int):
    """(span, n_splits) for a forward launch over ``rows`` rows of ``V``
    columns: the spans, multiples of ``SPAN_ALIGN`` and none below
    ``MIN_SPAN`` unless a row is one split, that cut a row into at most
    ``MAX_SPLITS`` splits (``n_splits_of``) so that the ``rows *
    n_splits`` blocks take the least time in waves of ``BLOCKS_PER_SM *
    n_sm`` blocks, a block costing its span plus ``BLOCK_COST``; ties go
    to fewer splits.  The launcher refuses any other plan."""
    slots = BLOCKS_PER_SM * n_sm
    best = None
    for want in range(1, max(1, min(MAX_SPLITS, V // MIN_SPAN)) + 1):
        span = SPAN_ALIGN * -(-V // (want * SPAN_ALIGN))
        n = n_splits_of(V, span)
        cost = -(-rows * n // slots) * (span + BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, span, n)
    return best[1], best[2]


def bwd_plan(V: int):
    """(span, n_splits) of the backward: spans of ``BWD_SPAN`` columns,
    one split for a row of fewer than ``BWD_SPAN + SPAN_ALIGN``."""
    return BWD_SPAN, n_splits_of(V, BWD_SPAN)


def _plan(dev, rows: int, V: int):
    plan = _PLANS.get((dev, rows, V))
    if plan is None:
        plan = _PLANS[dev, rows, V] = split_plan(rows, V, build.sm_count(dev))
    return plan


_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p)


def fused_logprob_cuda(logits, tokens):
    """The CUDA kernel.  logits: [T, V] or [B, T, V] CUDA tensor (fp32 or
    bf16) with unit column stride and any row strides; tokens: the leading
    shape.  Cut by ``split_plan``, cached per (device, rows, V).  Returns
    (logp, m, s), each fp32 in the leading shape."""
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
    if V == 0:
        raise ValueError("fused_logprob_cuda: a row of no columns")
    dev = logits.device
    span, n_splits = _plan(dev, n_rows, V)
    ws = count = None
    if n_splits > 1:
        # each split's (m, s); the last of a row merges them
        ws = build.scratch("fused_logprob partials", dev,
                           n_rows * n_splits * 2, torch.float32).data_ptr()
        count = build.scratch("fused_logprob counters", dev, n_rows,
                              torch.int32).data_ptr()
    fn = build.c_function("fused_logprob", "fused_logprob_launch", _ARGS)
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], n_rows, inner,
             outer_stride, inner_stride, V, span, n_splits, tok.data_ptr(),
             ws, count, *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(dev).cuda_stream)
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
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def fused_logprob_bwd_cuda(logits, tokens, m, log_s, g, n_valid=None):
    """The CUDA backward kernel.

    logits: [T, V] or [B, T, V] CUDA tensor (fp32 or bf16) with unit
    column stride and any row strides.  For 3-D logits the loss saw only
    ``logits[:, :n_valid]`` (``n_valid`` defaults to T); tokens, m, log_s
    and g have that leading shape ([T] for 2-D logits), m, log_s and g in
    fp32.  The output's rows are cut by ``bwd_plan``.  Returns dlogits: a
    new contiguous tensor of the logits' full shape and dtype, zero in the
    rows t >= n_valid."""
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
    n_rows = dl.numel() // V
    span, n_splits = bwd_plan(V)
    fn = build.c_function("fused_logprob_bwd", "fused_logprob_bwd_launch",
                          _BWD_ARGS)
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], n_rows, inner,
             n_valid, outer_stride, inner_stride, V, span, n_splits,
             tok.data_ptr(), *(t.data_ptr() for t in stats), dl.data_ptr(),
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check("fused_logprob_bwd", err)
    return dl

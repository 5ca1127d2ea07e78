"""Kernel dispatch for the port: one routing rule, by device.

A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
takes the kernel's plain PyTorch version.  There is no mode knob and no
size threshold: on the card the path always goes through the kernels.
``attention`` sends what the reference's flash kernel does not take
(windows, continuations, asymmetric heads, encoder and cross attention)
to ``chunked_attention`` on either device, as the reference does.

``token_logprob`` and ``attention`` are differentiable, as the
reference's custom VJPs are (``repro/kernels/dispatch.py``): the
log-prob's backward is its own kernel on the card, the attention's
backward recomputes through ``chunked_attention`` under autograd.
``paged_attention`` is the engine's decode attention, forward only.
A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the card's
attention route with the plain version in the kernel's place, so it
saves and recomputes what the card does; it launches nothing.
``int8_matmul`` is the quantized product's dispatch surface, forward
only; no model path calls it.  ``sample_vocab_parallel`` is the sampler
of a tensor-parallel rank, which holds a slice of each row's vocabulary:
B3 on the slice in its partial mode, the ranks' partials gathered and
merged; the logits are never gathered.  ``token_logprob_vocab_parallel``
is such a rank's differentiable log-prob: B1 on the slice, the ranks'
(m, s, target logit) gathered and merged, and B2 on the slice with the
merged stats in the backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import chunked_attention, \
    flash_attention_cuda
from repro_torch.kernels.fused_logprob import fused_logprob_bwd_cuda, \
    fused_logprob_bwd_plain, fused_logprob_cuda, fused_logprob_plain
from repro_torch.kernels.fused_sample import fused_sample_cuda, \
    fused_sample_partial_cuda, fused_sample_plain, \
    fused_sample_split_plain, merge_partials
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, \
    int8_matmul_plain
from repro_torch.kernels.online import NEG_INF
from repro_torch.kernels.paged_attention import paged_attention_cuda, \
    paged_attention_plain


class _TokenLogprob(torch.autograd.Function):
    """log softmax(base[:, :n])[token] for a 3-D ``base``.  The forward
    saves the online stats (m, log s); the backward rebuilds the softmax
    from them and returns the gradient of the whole ``base`` (zero past
    row n), so scoring a prefix needs no scatter."""

    @staticmethod
    def forward(ctx, base, tokens, n):
        view = base[:, :n]
        if base.is_cuda:
            logp, m, s = fused_logprob_cuda(view, tokens)
        else:
            V = base.shape[-1]
            logp, m, s = (t.reshape(tokens.shape) for t in fused_logprob_plain(
                view.reshape(-1, V), tokens.reshape(-1)))
        ctx.n = n
        ctx.save_for_backward(base, tokens, m, torch.log(s))
        return logp

    @staticmethod
    def backward(ctx, g):
        base, tokens, m, log_s = ctx.saved_tensors
        n = ctx.n
        if base.is_cuda:
            return fused_logprob_bwd_cuda(base, tokens, m, log_s, g,
                                          n_valid=n), None, None
        V = base.shape[-1]
        d = fused_logprob_bwd_plain(base[:, :n].reshape(-1, V),
                                    tokens.reshape(-1), m.reshape(-1),
                                    log_s.reshape(-1), g.reshape(-1))
        full = torch.zeros_like(base)
        full[:, :n] = d.reshape(base.shape[0], n, V)
        return full, None, None


def token_logprob(logits, tokens, n_valid=None):
    """log softmax(logits)[token] per position, streamed, differentiable.

    logits: [..., V] (fp32/bf16); tokens: [...] int -> [...] fp32.  With
    3-D logits [B, T, V], ``n_valid`` scores only ``logits[:, :n_valid]``
    (tokens [B, n_valid]): the trainer passes its whole logits and
    ``T - 1``.  The kernels then read that prefix in place, and the
    backward writes the gradient of the whole logits (zero past
    ``n_valid``), so autograd scatters nothing.
    """
    V = logits.shape[-1]
    if logits.dim() == 3:
        base, n = logits, logits.shape[1] if n_valid is None else n_valid
    elif n_valid is not None:
        raise ValueError(f"n_valid needs 3-D logits, got {tuple(logits.shape)}")
    else:
        base = logits.reshape(1, -1, V)
        n = base.shape[1]
    out = _TokenLogprob.apply(base, tokens.reshape(base.shape[0], n), n)
    return out.reshape(tokens.shape)


class _TokenLogprobVP(torch.autograd.Function):
    """``_TokenLogprob`` on this rank's vocabulary slice ``base`` [B, T,
    V/m] of columns ``[col0, col0 + V/m)``: B1 on the slice scores
    ``tokens - col0`` (a token outside the slice as -1e30), the ranks'
    [rows, 3] fp32 partials (m, s, target logit) are gathered and merged
    in rank order (``merge_logprob_partials``); the backward is B2 on the
    slice with the merged (M, log s), this rank's columns of ``g *
    (onehot - softmax)``."""

    @staticmethod
    def forward(ctx, base, tokens, n, col0, gather):
        view, V = base[:, :n], base.shape[-1]
        local = tokens.long() - col0
        if base.is_cuda:
            _, m, s = fused_logprob_cuda(view, local)
        else:
            _, m, s = (t.reshape(tokens.shape) for t in fused_logprob_plain(
                view.reshape(-1, V), local.reshape(-1)))
        inside = (local >= 0) & (local < V)
        t = view.gather(2, local.clamp(0, V - 1)[..., None])[..., 0].float()
        t = torch.where(inside, t, NEG_INF)
        logp, M, log_s = merge_logprob_partials(
            gather(torch.stack([m, s, t], dim=-1)))
        ctx.n = n
        ctx.save_for_backward(base, local, M, log_s)
        return logp

    @staticmethod
    def backward(ctx, g):
        base, local, M, log_s = ctx.saved_tensors
        n = ctx.n
        if base.is_cuda:
            return fused_logprob_bwd_cuda(base, local, M, log_s, g,
                                          n_valid=n), None, None, None, None
        V = base.shape[-1]
        d = fused_logprob_bwd_plain(base[:, :n].reshape(-1, V),
                                    local.reshape(-1), M.reshape(-1),
                                    log_s.reshape(-1), g.reshape(-1))
        full = torch.zeros_like(base)
        full[:, :n] = d.reshape(base.shape[0], n, V)
        return full, None, None, None, None


def merge_logprob_partials(parts):
    """(log-prob, M, log s) of rows whose vocabulary is split over ranks,
    from every rank's [..., 3] fp32 partial (m_i, s_i, t_i) stacked in
    rank order on a leading axis: M = max m_i, s = the sum of s_i
    exp(m_i - M) in rank order, t the target logit (-1e30 on every rank
    but the token's), log-prob (t - M) - log s (the rule of
    ``fused_logprob_split_plain``)."""
    M = parts[..., 0].amax(dim=0)
    s = torch.zeros_like(M)
    for p in parts:             # rank order
        s = s + p[..., 1] * torch.exp(p[..., 0] - M)
    t = parts[..., 2].amax(dim=0)
    log_s = torch.log(s)
    return (t - M) - log_s, M, log_s


def all_gather_stacked(x, group):
    """Every rank's ``x`` of ``group``, stacked in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def token_logprob_vocab_parallel(local_logits, tokens, col0: int, group,
                                 n_valid=None, *, gather=None):
    """``token_logprob`` of rows whose vocabulary is split over the ranks
    of ``group`` in rank order: ``local_logits`` [B, T, V/m] holds this
    rank's columns ``[col0, col0 + V/m)``; tokens are global ids.  B1 runs
    on the slice (the plain version on the CPU), the ranks' [rows, 3]
    partials are all-gathered (``gather``, by default
    ``all_gather_stacked`` over ``group``) and merged in rank order, so
    every rank holds the same log-probs bit for bit; differentiable, B2
    on the slice in the backward, written through the ``n_valid`` prefix
    as ``token_logprob`` writes it.  The logits are never gathered.
    Returns fp32 in the tokens' shape."""
    if local_logits.dim() != 3:
        raise ValueError("token_logprob_vocab_parallel takes 3-D logits, "
                         f"got {tuple(local_logits.shape)}")
    n = local_logits.shape[1] if n_valid is None else n_valid
    if gather is None:
        def gather(x):
            return all_gather_stacked(x, group)
    return _TokenLogprobVP.apply(local_logits,
                                 tokens.reshape(local_logits.shape[0], n), n,
                                 col0, gather).reshape(tokens.shape)


def sample(logits, key, temperature: float, *, row0: int = 0):
    """Categorical draw + behaviour log-prob in one streamed pass.

    logits: [B, V], the rows ``[row0, row0 + B)`` of the draw (a rank's
    share of split rows); key: a ``rl.prng`` key.  Returns (tokens [B]
    int32, log mu(token) [B] fp32) under the temperature-scaled
    distribution (greedy argmax scored at T = 1 when ``temperature ==
    0``).  Not differentiable, as in the reference.
    """
    if logits.is_cuda:
        return fused_sample_cuda(logits, key, temperature, row0=row0)
    return fused_sample_plain(logits, key, temperature, row0=row0)


def sample_vocab_parallel(local_logits, key, temperature: float, col0: int,
                          group, *, row0: int = 0):
    """``sample`` of rows whose vocabulary is split over the ranks of
    ``group`` in rank order: ``local_logits`` [B, V/m] holds this rank's
    columns ``[col0, col0 + V/m)``.  Each rank runs B3 on its slice in
    its partial mode (the plain version's partial on the CPU), the
    ranks' [B, 5] partials are all-gathered, and every rank merges them
    in rank order (``fused_sample.merge_partials``): the tokens are the
    whole row's draw bit for bit, the log-probs agree to fp32 rounding,
    and every rank holds the same.  Returns (tokens [B] int32, log
    mu(token) [B] fp32)."""
    if local_logits.is_cuda:
        part = fused_sample_partial_cuda(local_logits, key, temperature,
                                         col0=col0, row0=row0)
    else:
        part = fused_sample_split_plain(local_logits, key, temperature,
                                        max(local_logits.shape[1], 1),
                                        col0=col0, row0=row0, partial=True)
    return merge_partials(all_gather_stacked(part, group))


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward; the backward recomputes through
    ``chunked_attention`` under autograd, as the reference's
    ``_flash_vjp_bwd`` does (the reference has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.is_meta:
            return chunked_attention(q, k, v)
        return flash_attention_cuda(q, k, v)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = chunked_attention(*leaves)
        return torch.autograd.grad(out, leaves, g)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """Attention of a prefill or training segment.

    q: [B, Sq, H, hd]; k/v: [B, Sk, K, hd(v)] -> [B, Sq, H, hd(v)], H a
    multiple of K.  Dense causal self-attention (Sq == Sk, no window, no
    offset, one head dim) goes to the flash kernel on the card; the
    rest goes to ``chunked_attention`` on either device, as the reference
    routes it (its flash kernel takes none of it): a sliding-window
    segment (``window``), a prefill continuation (``q_offset``: queries
    at absolute positions ``q_offset ..`` over a cached prefix and
    themselves), asymmetric head dims (MLA's qk 192 against v 128), and
    ``causal=False``: an encoder's self-attention, or cross attention of
    decoder queries over encoder frames (Sq != Sk).
    """
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"attention: {q.shape[2]} query heads are no "
                         f"multiple of {k.shape[2]} kv heads")
    if (not causal or window or q_offset or q.shape[1] != k.shape[1]
            or v.shape[-1] != q.shape[-1]):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    if q.is_cuda or q.is_meta:
        return _FlashAttention.apply(q, k, v)
    return chunked_attention(q, k, v)


def paged_attention(q, arena_k, arena_v, page_table, pos, *,
                    window: int = 0):
    """Paged decode attention: one query per row against the row's page
    table over a shared KV arena (``models/paging.py`` layout).

    q: [B, H, hd]; arena_[kv]: [n_pages + 1, P, K, hd]; page_table:
    [B, max_blocks + 1] int32; pos: [B] int32 -> [B, H, hd] in the
    arena's dtype.  The CUDA kernel on the card, with no size threshold;
    the gather version, bitwise equal to dense ``gqa_decode``, on the CPU.
    """
    if q.is_cuda:
        return paged_attention_cuda(q, arena_k, arena_v, page_table, pos,
                                    window=window)
    return paged_attention_plain(q, arena_k, arena_v, page_table, pos,
                                 window=window)


def int8_matmul(x, w_q, scale):
    """Quantized matmul: x [M, K] (fp32 or bf16) times int8 w_q [K, N]
    times the per-column scale ([N], or the [1, N] of ``quantize_int8``)
    -> [M, N] fp32.  The CUDA kernel on the card, with no size threshold;
    the plain version, fp32 product then scale, on the CPU.  (The
    reference's dispatch surface for its int8 kernel: the generator's
    quantization dequantizes once at weight sync through
    ``ddma.quantize_dequant``, so only tests and ``chip_smoke.py`` call
    this.)"""
    if x.is_cuda:
        return int8_matmul_cuda(x, w_q, scale)
    return int8_matmul_plain(x, w_q, scale)

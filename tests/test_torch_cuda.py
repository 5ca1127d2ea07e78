"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them.  The
file imports neither jax nor the JAX package, so it runs on a machine
without jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import build, fused_logprob, fused_sample
from repro_torch.kernels.flash_attention import chunked_attention, \
    flash_attention_cuda
from repro_torch.rl import prng


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    """max |a - b|; equal infinities agree (a row of -1e30 logits rounds
    below the online max's -1e30 floor in bf16 and scores +inf in both)."""
    a, b = a.float(), b.float()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    assert not torch.isnan(d).any()
    return d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [1000, 1001])     # 16-byte loads, and not
def test_cuda_fused_sample(cuda, temperature, dtype, V):
    x = torch.randn(16, V, generator=torch.Generator().manual_seed(0)) * 3
    x[0, 5], x[1], x[2, 3], x[2, 99] = 1e30, -1e30, 20.0, 20.0
    x = x.to(dtype).to(cuda)
    key = prng.split(prng.PRNGKey(3), 4)[2]
    tok, lp = fused_sample.fused_sample_cuda(x, key, temperature)
    tok_p, lp_p = fused_sample.fused_sample_plain(x, key, temperature)
    assert torch.equal(tok, tok_p)
    assert _err(lp, lp_p) < 1e-4
    if temperature == 0.0:
        assert tok[2].item() == 3       # ties go to the lower column


def _sample_rows(B, V, dtype, seed, cuda, pad=0):
    """Seeded [B, V] logits of randn x 3 on the card, read as a view into
    rows ``pad`` columns wider.  From 16 rows on, the edge rows: one
    dominating logit, a row of -1e30, a duplicate maximum (20.0 at
    columns 3 and 99), a duplicate maximum on both sides of the planned
    first split boundary (30.0), and a row of -inf."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, V + pad, generator=g) * 3
    if B >= 16:
        span, _ = fused_sample.split_plan(B, V, build.sm_count(cuda))
        edge = min(span, V - 1)
        x[0, min(5, V - 1)], x[1] = 1e30, -1e30
        x[2, min(3, V - 1)] = x[2, min(99, V - 1)] = 20.0
        if edge > 0:
            x[3, edge - 1] = x[3, edge] = 30.0
        x[4] = float("-inf")
    return x.to(dtype).to(cuda)[:, :V]


def _sample_equal(x, key):
    """The kernel's tokens equal the plain version's at T = 0, 0.7 and 1,
    its log-probs within 1e-4; returns the greedy tokens."""
    for T in (0.0, 0.7, 1.0):
        tok, lp = fused_sample.fused_sample_cuda(x, key, T)
        tok_p, lp_p = fused_sample.fused_sample_plain(x, key, T)
        bad = (tok != tok_p).nonzero().flatten().tolist()
        assert not bad, (T, bad, tok[bad], tok_p[bad])
        assert _err(lp, lp_p) < 1e-4
        if T == 0.0:
            greedy = tok
    return greedy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [1, 7, 1000, 1001, 49152, 128256, 256000])
@pytest.mark.parametrize("B", [1, 16, 32, 64, 200])
def test_cuda_fused_sample_split_plan(cuda, B, V, dtype):
    """The split kernel at its planned spans: tokens bit for bit, ties to
    the lower column across a split boundary, the -inf row to column 0."""
    x = _sample_rows(B, V, dtype, B + V, cuda)
    greedy = _sample_equal(x, prng.split(prng.PRNGKey(B), 3)[1])
    if B >= 16 and V > 99:
        span, _ = fused_sample.split_plan(B, V, build.sm_count(cuda))
        assert greedy[2].item() == 3 and greedy[4].item() == 0
        assert greedy[3].item() == min(span, V - 1) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [8, 1])     # 16-byte rows, and not
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [1000, 128256])
def test_cuda_fused_sample_row_stride(cuda, V, dtype, pad):
    x = _sample_rows(32, V, dtype, 5, cuda, pad=pad)
    assert x.stride(0) == V + pad
    _sample_equal(x, prng.split(prng.PRNGKey(9), 2)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(1, 4096), (1, 6145), (5, 128256),
                                 (1, 128256), (1, 524296)])
def test_cuda_fused_sample_planned_edges(cuda, B, V, dtype):
    """The plan's edges, reached through ``split_plan`` (at 132 SMs): two
    splits of 2048 columns, a ragged last split of an unaligned row, 52
    and 62 splits a row, and the most splits a row may have (256) with a
    last split of 16 columns; a duplicate maximum sits on both sides of
    the last split boundary."""
    span, n = fused_sample.split_plan(B, V, build.sm_count(cuda))
    assert n > 1, "the shape must split"
    edge = (n - 1) * span
    x = _sample_rows(B, V, dtype, V, cuda)
    x[B - 1, edge - 1] = x[B - 1, edge] = 50.0
    greedy = _sample_equal(x, prng.split(prng.PRNGKey(4), 3)[2])
    assert greedy[B - 1].item() == edge - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V,m", [(16, 1000, 2), (16, 128256, 2),
                                   (16, 128256, 4), (5, 256000, 2),
                                   (32, 1001, 3)])
def test_cuda_fused_sample_vocab_shards(cuda, B, V, m, dtype):
    """B3's partial mode on each of m vocabulary shards (columns
    [col0, col0 + V/m), the last one ragged) of rows [row0, row0 + B):
    each partial's column, max and kept logit equal the plain split
    version's at the kernel's span, s within 1e-4; merged in shard order
    the tokens equal B3 on the whole rows bit for bit, the log-probs
    within 1e-4 (the -inf row, the ties placed across a shard boundary
    included)."""
    x = _sample_rows(B, V, dtype, B + V + m, cuda)
    w = -(-V // m)
    if B >= 16:
        x[5, w - 1] = x[5, w] = 40.0            # a tie across shards
    key = prng.split(prng.PRNGKey(m), 2)[1]
    for T in (0.0, 0.7, 1.0):
        parts = []
        for c0 in range(0, V, w):
            shard = x[:, c0:c0 + w]
            part = fused_sample.fused_sample_partial_cuda(shard, key, T,
                                                          col0=c0, row0=7)
            span, _ = fused_sample.split_plan(B, shard.shape[1],
                                              build.sm_count(cuda))
            plain = fused_sample.fused_sample_split_plain(
                shard, key, T, span, col0=c0, row0=7, partial=True)
            assert torch.equal(part[:, 3], plain[:, 3]), (T, c0)
            assert torch.equal(part[:, [0, 4]], plain[:, [0, 4]]), (T, c0)
            ds = (part[:, 1] - plain[:, 1]).abs()
            assert bool((ds <= 1e-4 * plain[:, 1].abs()).all()), (T, c0)
            parts.append(part)
        tok, lp = fused_sample.merge_partials(torch.stack(parts))
        tok_w, lp_w = fused_sample.fused_sample_cuda(x, key, T, row0=7)
        assert torch.equal(tok, tok_w), T
        assert _err(lp, lp_w) < 1e-4
        if T == 0.0 and B >= 16:
            assert tok[5].item() == w - 1 and tok[4].item() == 0


@pytest.mark.cuda
def test_cuda_fused_sample_counters_and_repeat(cuda):
    """Two calls give the same bits, one launch each, and the merge
    counters are back at zero after each."""
    key = prng.split(prng.PRNGKey(2), 2)[1]
    for B in (16, 32, 64, 16):
        x = _sample_rows(B, 128256, torch.bfloat16, B, cuda)
        build.reset_launches()
        a = fused_sample.fused_sample_cuda(x, key, 1.0)
        b = fused_sample.fused_sample_cuda(x, key, 1.0)
        assert build.LAUNCHES["fused_sample"] == 2
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        counts = build.scratch("fused_sample counters", cuda, 1, torch.int32)
        assert int(counts.abs().sum().item()) == 0


@pytest.mark.cuda
def test_cuda_fused_sample_refuses_bad_spans(cuda):
    """The launcher takes only plans ``split_plan`` can give: (span,
    splits) that cover the row with no empty split, aligned spans, none
    under MIN_SPAN when a row splits, at most MAX_SPLITS."""
    B, V = 2, 4096
    x = torch.zeros(B, V, device=cuda)
    tok = torch.empty(B, dtype=torch.int32, device=cuda)
    lp = torch.empty(B, device=cuda)
    ws = build.scratch("fused_sample partials", cuda, B * 512 * 5,
                       torch.float32)
    count = build.scratch("fused_sample counters", cuda, B, torch.int32)
    fn = build.c_function("fused_sample", "fused_sample_launch",
                          fused_sample._ARGS)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(span, n):
        return fn(x.data_ptr(), 0, B, V, V, 0, 0, 1.0, 1, span, n,
                  ws.data_ptr(), count.data_ptr(), tok.data_ptr(),
                  lp.data_ptr(), stream)
    assert launch(4096, 1) == 0 and launch(2048, 2) == 0
    torch.cuda.synchronize()
    # no split, empty last split, unaligned, under MIN_SPAN, 512 splits
    for span, n in ((4096, 0), (4096, 2), (12, 342), (1024, 4), (8, 512)):
        assert launch(span, n) != 0, (span, n)
    assert int(count.abs().sum().item()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-4)])
def test_cuda_fused_logprob_strided(cuda, dtype, tol):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(3, 12, 257, generator=g) * 4).to(dtype).to(cuda)
    toks = torch.randint(0, 257, (3, 11), generator=g).to(cuda)
    got, m, s = fused_logprob.fused_logprob_cuda(x[:, :-1], toks)
    want, mp, sp = fused_logprob.fused_logprob_plain(
        x[:, :-1].reshape(-1, 257), toks.reshape(-1))
    assert (got.reshape(-1) - want).abs().max().item() < tol
    assert torch.equal(m.reshape(-1), mp)


def _border_logits(shape, V, dtype, seed, cuda, shift=0):
    """Seeded [B, T + 1, V] logits of randn x 4 on the card (read through a
    view ``shift`` columns into rows that much wider), and tokens for
    their [:, :-1] view: column 0, V - 1 and the columns on both sides of
    each split border of B1's and B2's plans (the row's head + i span), in
    turn, row by row; batch 1 holds a +1e30 row, a -1e30 row and a tied
    row.  Returns the logits, the view, the tokens and B1's plan."""
    B, T = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T + 1, V + shift, generator=g) * 4
    x[1, 0, 5 + shift], x[1, 1], x[1, 2, 3 + shift] = 1e30, -1e30, 9.0
    x[1, 2, 99 % V + shift] = 9.0
    x = x.to(dtype).to(cuda)[..., shift:]
    view = x[:, :-1]
    toks = torch.randint(0, V, (B, T), generator=g)
    n_sm = build.sm_count(cuda)
    span, n = fused_logprob.split_plan(B * T, V, n_sm)
    bspan, bn = fused_logprob.bwd_plan(V)
    heads = fused_logprob.row_heads(view)
    cols = [0, V - 1] + [c for sp, k in ((span, n), (bspan, bn))
                         for i in range(1, k) for c in (i * sp - 1, i * sp)]
    flat = toks.reshape(-1)
    for r, h in enumerate(heads.reshape(-1).tolist()):
        c = cols[r % len(cols)]
        flat[r] = min(V - 1, c + (h if c not in (0, V - 1) else 0))
    return x, view, toks.to(cuda), (span, n)


# rows of each phase: V % 8 is 1, 6 and 6, so a [:, :-1] view's rows
# start at every 2-byte phase; 16 x 7 rows take several splits a row at V
# 50310, 16 x 127 rows several waves
LOGPROB_EDGES = [((16, 7), 1001), ((16, 7), 1030), ((16, 7), 50310),
                 ((16, 127), 1030), ((16, 63), 50310)]


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("shape,V", LOGPROB_EDGES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-4)])
def test_cuda_fused_logprob_misaligned(cuda, shape, V, dtype, tol, shift):
    """B1 on strided views whose rows start at any phase, against the plain
    version (m bit for bit) and against ``fused_logprob_split_plain`` at
    the kernel's own plan; one launch a call, the merge counters back at
    zero."""
    x, view, toks, (span, n) = _border_logits(shape, V, dtype, V, cuda, shift)
    build.reset_launches()
    got, m, s = fused_logprob.fused_logprob_cuda(view, toks)
    assert build.LAUNCHES["fused_logprob"] == 1
    want, mp, _ = fused_logprob.fused_logprob_plain(view.reshape(-1, V),
                                                    toks.reshape(-1))
    assert _err(got.reshape(-1), want) < tol
    assert torch.equal(m.reshape(-1), mp)
    split, ms, ss = fused_logprob.fused_logprob_split_plain(view, toks, span)
    assert _err(got, split) < tol and torch.equal(m, ms)
    assert torch.where(s == ss, 0.0, (s - ss).abs() / ss).max().item() < 1e-5
    counts = build.scratch("fused_logprob counters", cuda, 1, torch.int32)
    assert int(counts.abs().sum().item()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])     # input phase = output's, or not
@pytest.mark.parametrize("shape,V", LOGPROB_EDGES)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_cuda_fused_logprob_bwd_misaligned(cuda, shape, V, dtype, rtol, shift):
    """B2 on the same views: every element within its dtype's rounding,
    the last position zero.  With ``shift`` the logits' rows start 3
    columns off the gradient's, so the body's loads go one logit at a
    time."""
    x, view, toks, _ = _border_logits(shape, V, dtype, V + 1, cuda, shift)
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(V)) \
        .to(cuda)
    _, m, s = fused_logprob.fused_logprob_cuda(view, toks)
    build.reset_launches()
    got = fused_logprob.fused_logprob_bwd_cuda(x, toks, m, torch.log(s), w,
                                               n_valid=shape[1])
    assert build.LAUNCHES["fused_logprob_bwd"] == 1
    want = fused_logprob.fused_logprob_bwd_plain(
        view.reshape(-1, V), toks.reshape(-1), m.reshape(-1),
        torch.log(s).reshape(-1), w.reshape(-1))
    assert got.shape == x.shape and got.is_contiguous()
    assert (got[:, -1] == 0).all()
    assert _bwd_excess(got[:, :-1].reshape(-1, V), want, w.reshape(-1),
                       toks.reshape(-1), rtol) <= 1.0


@pytest.mark.cuda
def test_cuda_fused_logprob_refuses_bad_spans(cuda):
    """Both launchers take only plans of the shape ``split_plan`` and
    ``bwd_plan`` give: aligned spans, none under MIN_SPAN when a row
    splits, a last split that keeps a column whatever the head and holds
    less than span + 8, and (B1) at most MAX_SPLITS."""
    rows, width = 2, 257 * 4096 + 8
    x = torch.zeros(rows, width, device=cuda)
    toks = torch.zeros(rows, dtype=torch.int32, device=cuda)
    outs = [torch.empty(rows, device=cuda) for _ in range(3)]
    ws = build.scratch("fused_logprob partials", cuda, rows * 512 * 2,
                       torch.float32)
    count = build.scratch("fused_logprob counters", cuda, rows, torch.int32)
    fwd = build.c_function("fused_logprob", "fused_logprob_launch",
                           fused_logprob._ARGS)
    bwd = build.c_function("fused_logprob_bwd", "fused_logprob_bwd_launch",
                           fused_logprob._BWD_ARGS)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    dl = torch.empty_like(x)

    def launch(span, n, V=8200):
        a = fwd(x.data_ptr(), 0, rows, rows, 0, width, V, span, n,
                toks.data_ptr(), ws.data_ptr(), count.data_ptr(),
                *(o.data_ptr() for o in outs), stream)
        b = bwd(x.data_ptr(), 0, rows, rows, rows, 0, width, V, span, n,
                toks.data_ptr(), *(o.data_ptr() for o in outs),
                dl.data_ptr(), stream)
        torch.cuda.synchronize()
        return a, b
    for span in (8200, 4104, 4096):
        assert launch(span, fused_logprob.n_splits_of(8200, span)) == (0, 0)
    # no split, one split too few, one too many (a head of 1 empties the
    # last), unaligned, under MIN_SPAN
    for span, n in ((8200, 0), (4096, 2), (4104, 3), (4100, 2), (2048, 5)):
        assert all(e != 0 for e in launch(span, n)), (span, n)
    # 258 splits: past the forward's merge, which the backward has not
    assert fused_logprob.n_splits_of(width, 4096) == 258
    a, b = launch(4096, 258, width)
    assert a != 0 and b == 0
    assert int(count.abs().sum().item()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,K,hd", [(128, 8, 2, 32), (100, 4, 4, 64),
                                      (77, 8, 1, 16), (130, 4, 2, 128),
                                      (200, 10, 2, 192), (150, 8, 8, 112)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_flash_attention(cuda, S, H, K, hd, dtype, tol):
    """fp32 within 1e-5; bf16 within 3e-2 of max(1, |o|): the plain
    version rounds the probabilities to bf16 before the PV product, the
    kernel keeps them in fp32."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, S, n, hd, generator=g).to(dtype).to(cuda)
               for n in (H, K, K))
    got = flash_attention_cuda(q, k, v)
    want = chunked_attention(q, k, v).float()
    assert got.dtype == dtype
    err = (got.float() - want).abs() / want.abs().clamp(min=1.0)
    assert err.max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 192])
@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
def test_cuda_flash_attention_bf16_peaked(cuda, hd, layout):
    """The tensor-core kernel at S = 2048 on sharply peaked attention (q x
    4, so |o| nears |v| and an error cannot hide under averaging), at
    every head dim, within 3e-2 of max(1, |o|) as above.  "unaligned"
    reads q, k and v as views one element into wider rows, so no row
    starts on a 16-byte boundary and the kernel copies element by
    element."""
    g = torch.Generator().manual_seed(hd)
    pad = layout == "unaligned"
    q, k, v = (torch.randn(1, 2048, n, hd + pad, generator=g)
               .to(torch.bfloat16).to(cuda)[..., pad:] for n in (8, 2, 2))
    q = q * 4
    got = flash_attention_cuda(q, k, v)
    want = chunked_attention(q, k, v).float()
    err = (got.float() - want).abs() / want.abs().clamp(min=1.0)
    assert err.max().item() < 3e-2


def _logits(shape, dtype, seed, extreme):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(seed)) * 4
    if extreme:
        x[0, 5], x[1], x[2, 3], x[2, 99] = 1e30, -1e30, 7.0, 7.0
    return x.to(dtype)


def _bwd_excess(got, want, g, toks, rtol, atol=1e-12):
    """The largest ratio of |got - want| to rtol |want| + atol, with rtol
    |g| more at each row's token column, where want = g (1 - p) cancels.
    got, want: [N, V]; g, toks: [N].  Equal infinities agree."""
    a, b = got.float(), want.float()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    assert not torch.isnan(d).any()
    tol = torch.where(torch.isfinite(b), b.abs() * rtol,
                      torch.zeros_like(b)) + atol
    tol.scatter_add_(1, toks.long()[:, None], (g.float().abs() * rtol)[:, None])
    return (d / tol).max().item()


# each gradient element within its dtype's rounding: one bf16 ulp, and 1e-6
# relative in fp32; V = 257's rows start at every phase, 1000's at two in
# bf16, 4096's on 16-byte boundaries
@pytest.mark.cuda
@pytest.mark.parametrize("T,V", [(33, 257), (64, 1000), (16, 4096)])
@pytest.mark.parametrize("dtype,rtol,extreme", [(torch.float32, 1e-6, True),
                                                (torch.float32, 1e-6, False),
                                                (torch.bfloat16, 2.0 ** -7,
                                                 True),
                                                (torch.bfloat16, 2.0 ** -7,
                                                 False)])
def test_cuda_fused_logprob_bwd(cuda, T, V, dtype, rtol, extreme):
    x = _logits((T, V), dtype, 3, extreme).to(cuda)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, V, (T,), generator=g).to(cuda)
    w = torch.randn(T, generator=g).to(cuda)
    _, m, s = fused_logprob.fused_logprob_cuda(x, toks)
    got = fused_logprob.fused_logprob_bwd_cuda(x, toks, m, torch.log(s), w)
    want = fused_logprob.fused_logprob_bwd_plain(x, toks, m, torch.log(s), w)
    assert got.dtype == dtype and got.shape == (T, V)
    assert _bwd_excess(got, want, w, toks, rtol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("V", [1000, 1001])     # rows at two phases, at all
def test_cuda_fused_logprob_bwd_prefix_view(cuda, dtype, rtol, V):
    """The trainer's logits[:, :-1]: read in place, and the gradient of the
    whole [B, T, V] written with zeros in the last position.  Extreme rows
    sit in batch 2, so a wrong outer stride shows."""
    x = _logits((3, 12, V), dtype, 5, False)
    x[2, 4, 5], x[2, 5], x[2, 6, 3], x[2, 6, 99] = 1e30, -1e30, 9.0, 9.0
    x = x.to(cuda)
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, V, (3, 11), generator=g).to(cuda)
    w = torch.randn(3, 11, generator=g).to(cuda)
    _, m, s = fused_logprob.fused_logprob_cuda(x[:, :-1], toks)
    got = fused_logprob.fused_logprob_bwd_cuda(x, toks, m, torch.log(s), w,
                                               n_valid=11)
    want = fused_logprob.fused_logprob_bwd_plain(
        x[:, :-1].reshape(-1, V), toks.reshape(-1), m.reshape(-1),
        torch.log(s).reshape(-1), w.reshape(-1))
    assert got.shape == x.shape and (got[:, -1] == 0).all()
    assert _bwd_excess(got[:, :-1].reshape(-1, V), want, w.reshape(-1),
                       toks.reshape(-1), rtol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_token_logprob_grad(cuda, dtype, tol):
    """The autograd Function on the card against the plain path on the
    CPU, scoring ``logits[:, :-1]`` as the trainer does."""
    from repro_torch.kernels import dispatch
    x = _logits((2, 9, 515), dtype, 7, False)
    toks = torch.randint(0, 515, (2, 8),
                         generator=torch.Generator().manual_seed(8))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaf = x.to(dev).requires_grad_()
        lp = dispatch.token_logprob(leaf, toks.to(dev), n_valid=8)
        (lp * torch.arange(16.0, device=dev).reshape(2, 8)).sum().backward()
        grads.append(leaf.grad.cpu())
    assert _err(*grads) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,K,hd", [(80, 8, 2, 128), (100, 4, 4, 64),
                                      (80, 8, 8, 112)])
def test_cuda_attention_grad(cuda, S, H, K, hd):
    """The flash forward's recompute backward against chunked_attention's
    gradient under autograd, on the card in fp32."""
    from repro_torch.kernels import dispatch
    gen = torch.Generator().manual_seed(9)
    qkv = [torch.randn(2, S, n, hd, generator=gen).to(cuda)
           for n in (H, K, K)]
    go = torch.randn(2, S, H, hd, generator=gen).to(cuda)
    results = []
    for fn in (dispatch.attention, chunked_attention):
        leaves = [t.clone().requires_grad_() for t in qkv]
        results.append(torch.autograd.grad(fn(*leaves), leaves, go))
    for a, b in zip(*results):
        assert _err(a, b) < 1e-4


# ------------------------------------------------------ paged attention ---

def _paged_problem(dev, B, H, K, hd, P, mb, n_pages, pos, q_dtype, kv_dtype,
                   seed, perm=True):
    """q, arenas, a table (a random permutation of pages, or the reference
    suite's random ids) whose last column is the trash page, and pos."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g).to(q_dtype)
    ak, av = (torch.randn(n_pages + 1, P, K, hd, generator=g).to(kv_dtype)
              for _ in range(2))
    pages = torch.randperm(n_pages, generator=g)[:B * mb].reshape(B, mb) \
        if perm else torch.randint(0, n_pages, (B, mb), generator=g)
    table = torch.cat([pages, torch.full((B, 1), n_pages)], 1).int()
    return [t.to(dev) for t in (q, ak, av, table,
                                torch.tensor(pos, dtype=torch.int32))]


def _poisoned(ak, av, table, pos, window):
    """(NaN-poisoned, zeroed) copies of the arenas: every slot no row
    attends to -- pages past a row's cursor, below its window, and pages
    no table maps -- holds NaN in the one and 0 in the other."""
    P, mb = ak.shape[1], table.shape[1] - 1
    need = torch.zeros(ak.shape[:2], dtype=torch.bool, device=ak.device)
    for r, p in enumerate(pos.tolist()):
        lo = max(0, p - window + 1) if window else 0
        cols = torch.arange(lo, min(p, mb * P - 1) + 1, device=ak.device)
        need[table[r, cols // P].long(), cols % P] = True
    out = []
    for fill in (float("nan"), 0.0):
        pair = []
        for a in (ak, av):
            a = a.clone()
            a[~need] = fill
            pair.append(a)
        out.append(pair)
    return out


# (B, H, K, hd, P, mb, n_pages, pos, perm): the reference suite's
# arena_problem, the engine's shape (32 slots, prompt 48 + 64 new at page
# 16, a zombie row at the clamp mb * P), a 2048-token context, at head
# dim 192 too, and nemotron-4-340b's heads (96 / 8, hd 192: g = 12)
PAGED_SHAPES = {
    "arena": (3, 4, 2, 16, 5, 4, 16, [3, 11, 19], False),
    "arena_pos0": (3, 4, 2, 16, 5, 4, 16, [0, 0, 0], False),
    "engine": (32, 32, 8, 128, 16, 7, 224,
               [48 + 5 * i % 64 for i in range(31)] + [112], True),
    "long": (16, 32, 8, 128, 16, 128, 2112,
             [0, 15, 16, 2047] + [2047 - 13 * i for i in range(1, 13)],
             True),
    "long_hd192": (16, 32, 8, 192, 16, 128, 2112,
                   [0, 15, 16, 2047] + [2047 - 13 * i for i in range(1, 13)],
                   True),
    "nemotron": (4, 96, 8, 192, 16, 8, 40, [0, 17, 64, 128], True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
@pytest.mark.parametrize("window", [0, 6, 100])
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 2e-5), (torch.bfloat16, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 3e-2)])
def test_cuda_paged_attention(cuda, shape, window, q_dtype, kv_dtype, tol):
    """Against the plain gather version: fp32 arena within 2e-5, bf16
    arena within 3e-2 (the plain version rounds the probabilities to bf16
    before the P V product, the kernel keeps them in fp32); and the kernel
    on an arena whose unread slots are NaN equals the plain version on the
    same arena with those slots zeroed."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, \
        paged_attention_plain
    *dims, pos, perm = PAGED_SHAPES[shape]
    q, ak, av, table, pos = _paged_problem(cuda, *dims, pos, q_dtype,
                                           kv_dtype, 10, perm)
    got = paged_attention_cuda(q, ak, av, table, pos, window=window)
    want = paged_attention_plain(q, ak, av, table, pos, window=window)
    assert got.dtype == kv_dtype and got.shape == q.shape
    assert _err(got, want) < tol
    (pk, pv), (zk, zv) = _poisoned(ak, av, table, pos, window)
    got = paged_attention_cuda(q, pk, pv, table, pos, window=window)
    want = paged_attention_plain(q, zk, zv, table, pos, window=window)
    assert torch.isfinite(got).all() and _err(got, want) < tol


PAIRS = [(torch.float32, torch.float32, 2e-5),
         (torch.bfloat16, torch.float32, 2e-5),
         (torch.float32, torch.bfloat16, 3e-2),
         (torch.bfloat16, torch.bfloat16, 3e-2)]


def _split_edges(span, S):
    """Cursors whose contexts are span - 1, span and span + 1 columns, and
    two spans -1, 0, +1; then the last column and the clamp S."""
    return [span - 2, span - 1, span, 2 * span - 2, 2 * span - 1, 2 * span,
            S - 1, S]


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["none", 6, "span", "span+1", 100])
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", PAIRS)
def test_cuda_paged_attention_split_edges(cuda, window, q_dtype, kv_dtype,
                                          tol):
    """At the split kernel's own span on this card: contexts one column
    either side of a split's edge, windows that empty whole splits below
    the cursor, on arenas whose unread slots are NaN, for all four
    (q, arena) dtype pairs, against the plain version."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, \
        paged_attention_plain, split_plan
    B, H, K, hd, P, mb = 8, 32, 8, 128, 16, 8
    span, n_splits = split_plan(B, K, mb, P, build.sm_count(cuda))
    assert n_splits > 2, "the shape must split"
    window = {"none": 0, "span": span, "span+1": span + 1}.get(window,
                                                               window)
    pos = _split_edges(span, mb * P)
    q, ak, av, table, pos = _paged_problem(cuda, B, H, K, hd, P, mb,
                                           B * mb + 4, pos, q_dtype,
                                           kv_dtype, 12)
    got = paged_attention_cuda(q, ak, av, table, pos, window=window)
    want = paged_attention_plain(q, ak, av, table, pos, window=window)
    assert got.dtype == kv_dtype and _err(got, want) < tol
    (pk, pv), (zk, zv) = _poisoned(ak, av, table, pos, window)
    got = paged_attention_cuda(q, pk, pv, table, pos, window=window)
    want = paged_attention_plain(q, zk, zv, table, pos, window=window)
    assert torch.isfinite(got).all() and _err(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", PAIRS)
def test_cuda_paged_attention_starcoder2_window(cuda, q_dtype, kv_dtype,
                                                tol):
    """starcoder2-3b's decode in the windowed engine: 24 query heads on 2
    kv heads (g = 12), hd 128, window 4096 over a table of 264 pages of
    16 (prompts of 4160 + 64 new tokens), cursors below, at and past the
    window, on arenas whose unread slots are NaN."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, \
        paged_attention_plain
    pos = [100, 4095, 4096, 4160, 4200, 4223]
    q, ak, av, table, pos = _paged_problem(cuda, 6, 24, 2, 128, 16, 264,
                                           6 * 264 + 4, pos, q_dtype,
                                           kv_dtype, 14)
    got = paged_attention_cuda(q, ak, av, table, pos, window=4096)
    want = paged_attention_plain(q, ak, av, table, pos, window=4096)
    assert got.dtype == kv_dtype and _err(got, want) < tol
    (pk, pv), (zk, zv) = _poisoned(ak, av, table, pos, 4096)
    got = paged_attention_cuda(q, pk, pv, table, pos, window=4096)
    want = paged_attention_plain(q, zk, zv, table, pos, window=4096)
    assert torch.isfinite(got).all() and _err(got, want) < tol


@pytest.mark.cuda
def test_cuda_paged_attention_counters_return_to_zero(cuda):
    """The merge counters are left at zero, so back-to-back calls on
    other shapes agree with the plain version each time."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention_cuda, \
        paged_attention_plain
    for shape in ("engine", "long", "engine"):
        *dims, pos, perm = PAGED_SHAPES[shape]
        args = _paged_problem(cuda, *dims, pos, torch.float32,
                              torch.float32, 13, perm)
        assert _err(paged_attention_cuda(*args, window=6),
                    paged_attention_plain(*args, window=6)) < 2e-5
        counts = build.scratch("paged_attention counters", args[0].device, 1,
                               torch.int32)
        assert int(counts.abs().sum().item()) == 0


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_other_shapes(cuda):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q, ak, av, table, pos = _paged_problem(cuda, 2, 4, 2, 16, 4, 2, 4,
                                           [1, 2], torch.float32,
                                           torch.float32, 0)
    with pytest.raises(NotImplementedError):
        paged_attention_cuda(q[..., :8].contiguous(), ak[..., :8].contiguous(),
                             av[..., :8].contiguous(), table, pos)
    # a head dim outside the kernel's set raises, with no plain fallback
    q, ak, av, table, pos = _paged_problem(cuda, 2, 4, 2, 96, 4, 2, 4,
                                           [1, 2], torch.float32,
                                           torch.float32, 0)
    with pytest.raises(NotImplementedError, match="hd 96"):
        paged_attention_cuda(q, ak, av, table, pos)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_cuda(q, ak, av, table.long(), pos)


@pytest.mark.cuda
def test_cuda_engine_decode_matches_cpu(cuda):
    """llama31-smoke at fp32, paged pool: a sampled chunk through the
    card's kernels (paged_attention, fused_sample) against the same chunk
    on the CPU's plain versions -- tokens equal, log-probs within 1e-4."""
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl import rollout
    cfg = smoke()
    params = init_params(cfg, 0, torch.float32, device="cpu")
    pools = []
    for dev in (torch.device("cpu"), cuda):
        p = _to(params, dev)
        pool = rollout.start_row_pool(cfg, 4, 24, 8, device=dev,
                                      kv_layout="paged", kv_page_size=4)
        for slot in (0, 2):
            pr = (torch.arange(8, dtype=torch.int32) + 3 * slot + 5)[None]
            table = torch.arange(6 * slot, 6 * slot + 7, dtype=torch.int32)
            table[-1] = 24
            pool = rollout.admit_row_paged(p, cfg, pool, pr.to(dev),
                                           table.to(dev), slot, n_cached=0)
        build.reset_launches()
        pool = rollout.rollout_rows_chunk(p, cfg, pool, prng.PRNGKey(1),
                                          n_steps=6)
        pools.append(pool)
    assert build.LAUNCHES["paged_attention"] == cfg.n_layers * 6
    cpu, gpu = pools
    assert torch.equal(cpu.tokens, gpu.tokens.cpu())
    assert _err(cpu.behavior_logp, gpu.behavior_logp.cpu()) < 1e-4


# ---------------------------------------------------------- int8 matmul ---

# (M, K, N, view): the JAX suite's shapes, M = 1 with N not a multiple of
# 16, a ragged tile in every dimension, and views one element (x) and
# three bytes (w) into wider rows, which take the kernel's unaligned path
INT8_SHAPES = [(64, 128, 96, False), (50, 70, 90, False), (8, 512, 8, False),
               (1, 4096, 1000, False), (130, 1000, 300, False),
               (33, 300, 200, True), (1, 70, 90, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,view", INT8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_matmul(cuda, M, K, N, view, dtype):
    """dispatch.int8_matmul launches the kernel once and agrees with the
    plain version within 1e-4 of max(1, |plain|): both widen the same x
    and int8 values exactly, so only the order of the fp32 sum differs."""
    from repro_torch.core import ddma
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    g = torch.Generator().manual_seed(M + K + N)
    q, s = ddma.quantize_int8(torch.randn(K, N + 3 * view, generator=g)
                              / K ** 0.5)
    q, s = q.to(cuda)[:, 3 * view:], s.to(cuda)[:, 3 * view:]
    x = torch.randn(M, K + view, generator=g).to(dtype).to(cuda)[:, view:]
    build.reset_launches()
    got = dispatch.int8_matmul(x, q, s)
    assert build.LAUNCHES["int8_matmul"] == 1
    want = int8_matmul_plain(x, q, s)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert err.max().item() < 1e-4


# B6's new tile edges: every M around the decode kernel's 16 rows and the
# wgmma kernel's 64-row warpgroups and 128-row blocks; K and N not
# multiples of the tiles (64 deep, 128 wide), K deep enough to split at
# M <= 16; and views one element (x) and three bytes (w) into wider rows
INT8_EDGE_M = [1, 15, 16, 17, 64, 65, 128, 129]


@pytest.mark.cuda
@pytest.mark.parametrize("M", INT8_EDGE_M)
@pytest.mark.parametrize("K,N,view", [(1000, 300, False), (200, 130, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_matmul_tile_edges(cuda, M, K, N, view, dtype):
    """Within 1e-4 of max(1, |plain|), one launch a call, and the split-K
    counters left at zero."""
    from repro_torch.core import ddma
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.int8_matmul import int8_matmul_plain
    g = torch.Generator().manual_seed(M * 7 + K + N)
    q, s = ddma.quantize_int8(torch.randn(K, N + 3 * view, generator=g)
                              / K ** 0.5)
    q, s = q.to(cuda)[:, 3 * view:], s.to(cuda)[:, 3 * view:]
    x = torch.randn(M, K + view, generator=g).to(dtype).to(cuda)[:, view:]
    build.reset_launches()
    got = dispatch.int8_matmul(x, q, s)
    assert build.LAUNCHES["int8_matmul"] == 1
    want = int8_matmul_plain(x, q, s)
    assert got.shape == (M, N) and torch.isfinite(got).all()
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert err.max().item() < 1e-4
    counts = build.scratch("int8_matmul counters", x.device, 1, torch.int32)
    assert int(counts.abs().sum().item()) == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)

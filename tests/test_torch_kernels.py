"""The port's kernel module against the JAX package's kernels.

On the CPU the port runs each kernel's plain version; the JAX side runs
the Pallas kernel in interpret mode (``repro.kernels.ops``) or its dense
oracle (``repro.kernels.ref``), as ``tests/test_kernels.py`` does.  The
CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops, ref
from repro.kernels.fused_logprob import fused_logprob as jfused_logprob
from repro.kernels.fused_logprob import fused_logprob_bwd as jfused_logprob_bwd
from repro.kernels.fused_sample import hash_uniform as jhash_uniform
from repro_torch import convert
from repro_torch.kernels import dispatch, fused_logprob, fused_sample
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import chunked_attention, \
    flash_attention_cuda
from repro_torch.rl import prng

DTYPES = [(jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)]


def _pair(x, dtype=jnp.float32):
    """The same values for both packages: a jax array and a CPU tensor
    carrying identical bits."""
    j = jnp.asarray(x).astype(dtype)
    return j, convert.from_jax_numpy(np.asarray(jax.device_get(j)),
                                     device="cpu")


def _np(t):
    return t.detach().float().cpu().numpy()


def test_hash_uniform_bits_equal():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4096, size=2000).astype(np.int32)
    cols = rng.integers(0, 128256, size=2000).astype(np.int32)
    for seed in (0, 1, 2 ** 31 + 5):
        k0, k1 = (int(w) for w in prng.split(prng.PRNGKey(seed), 2)[1])
        want = np.asarray(jhash_uniform(jnp.asarray(rows), jnp.asarray(cols),
                                        jnp.uint32(k0), jnp.uint32(k1)))
        got = fused_sample.hash_uniform(torch.as_tensor(rows),
                                        torch.as_tensor(cols), k0, k1)
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.view(np.uint32))


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("block_v", [64, 2048])
def test_fused_sample_plain_matches_reference(temperature, block_v):
    x = np.random.default_rng(1).standard_normal((16, 515)) * 2
    jl, tl = _pair(x)
    key = 42
    tok_ref, lp_ref = ref.fused_sample_ref(jl, jax.random.PRNGKey(key),
                                           temperature)
    tok, lp = fused_sample.fused_sample_plain(tl, prng.PRNGKey(key),
                                              temperature, block_v=block_v)
    assert np.array_equal(tok.numpy(), np.asarray(tok_ref))
    assert np.max(np.abs(lp.numpy() - np.asarray(lp_ref))) < 1e-5
    # the port's dense oracle draws the same tokens
    tok_d, lp_d = tref.fused_sample_ref(tl, prng.PRNGKey(key), temperature)
    assert np.array_equal(tok_d.numpy(), np.asarray(tok_ref))
    assert np.max(np.abs(lp_d.numpy() - np.asarray(lp_ref))) < 1e-5


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_sample_extreme_and_tied_rows(temperature):
    x = np.random.default_rng(2).standard_normal((8, 300)).astype(np.float32)
    x[0, 5] = 1e30            # one dominating logit
    x[1, :] = -1e30           # uniformly tiny row
    x[2, 3] = x[2, 99] = 9.0  # duplicate max
    jl, tl = _pair(x)
    tok_ref, lp_ref = jdispatch.sample(jl, jax.random.PRNGKey(7),
                                       temperature, block_v=64)
    tok, lp = dispatch.sample(tl, prng.PRNGKey(7), temperature)
    assert np.array_equal(tok.numpy(), np.asarray(tok_ref))
    # at T = 0.7 the -1e30 row scales below the -1e30 floor of the online
    # max, so both versions score it +inf: equal infinities compare equal
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), rtol=0,
                               atol=1e-5)
    if temperature == 0.0:
        assert tok[2] == 3          # ties go to the lower column


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("m", [2, 4])
def test_sample_partials_merged_over_vocab_shards(m, temperature):
    """B3's plain partial of each of m vocabulary shards (columns
    ``[col0, col0 + V/m)`` at a span of 64, rows from ``row0``), merged
    in shard order by ``merge_partials``, gives ``fused_sample_plain``'s
    tokens on the whole rows bit for bit and the JAX reference's, with
    log-probs within 1e-5: a tie placed across each shard boundary goes
    to the lower column, and a row whose every z is -inf to column 0."""
    B, V, row0 = 8, 1000, 5
    w = V // m
    x = np.random.default_rng(3).standard_normal((B + row0, V)) * 2
    for r, c in enumerate(range(w, V, w)):
        x[row0 + r, c - 1] = x[row0 + r, c] = 30.0
    x[row0 + B - 1] = -np.inf
    jl, tl = _pair(x)
    key = 11
    parts = torch.stack([fused_sample.fused_sample_split_plain(
        tl[row0:, c0:c0 + w], prng.PRNGKey(key), temperature, 64, col0=c0,
        row0=row0, partial=True) for c0 in range(0, V, w)])
    tok, lp = fused_sample.merge_partials(parts)
    tok_w, lp_w = fused_sample.fused_sample_plain(
        tl[row0:], prng.PRNGKey(key), temperature, row0=row0)
    assert torch.equal(tok, tok_w)
    # rows [row0, row0 + B) of the reference's draw of the whole batch
    tok_r, lp_r = ref.fused_sample_ref(jl, jax.random.PRNGKey(key),
                                       temperature)
    assert np.array_equal(tok.numpy(), np.asarray(tok_r)[row0:])
    got, want = lp.numpy(), lp_w.numpy()
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin])   # the -inf row: +inf
    assert np.max(np.abs(got[fin] - want[fin])) < 1e-5
    if temperature == 0.0:
        for r, c in enumerate(range(w, V, w)):
            assert tok[r] == c - 1
    assert tok[B - 1] == 0


@pytest.mark.parametrize("T,V", [(64, 512), (100, 1000), (33, 257)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fused_logprob_plain_matches_kernel(T, V, dtype, tol):
    rng = np.random.default_rng(3)
    jl, tl = _pair(rng.standard_normal((T, V)) * 4, dtype)
    toks = rng.integers(0, V, size=T).astype(np.int32)
    want = ops.fused_logprob(jl, jnp.asarray(toks), block_t=32, block_v=128)
    got, m, s = fused_logprob.fused_logprob_plain(tl, torch.as_tensor(toks),
                                                  block_v=128)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < tol
    dense = tref.fused_logprob_ref(tl, torch.as_tensor(toks))
    assert np.max(np.abs(got.numpy() - dense.numpy())) < tol
    # the stats rebuild log Z
    lse = torch.logsumexp(tl.float(), dim=-1)
    assert torch.allclose(m + torch.log(s), lse, atol=1e-4)


def test_token_logprob_extreme_rows_and_batched():
    x = np.random.default_rng(4).standard_normal((8, 128)).astype(np.float32)
    x[0, 5] = 1e30
    x[1, :] = -1e30
    x[2, 3] = x[2, 99] = 7.0
    jl, tl = _pair(x)
    toks = np.arange(8, dtype=np.int32) * 3
    want = jdispatch.token_logprob(jl, jnp.asarray(toks), block_v=32)
    got = dispatch.token_logprob(tl, torch.as_tensor(toks))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-5
    # [B, T, V] bf16 through a strided [:, :-1] view, as reference scoring
    rng = np.random.default_rng(5)
    jl, tl = _pair(rng.standard_normal((2, 18, 300)) * 4, jnp.bfloat16)
    toks = rng.integers(0, 300, size=(2, 17)).astype(np.int32)
    want = jdispatch.token_logprob(jl[:, :-1], jnp.asarray(toks))
    got = dispatch.token_logprob(tl[:, :-1], torch.as_tensor(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 17)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 3e-2


# ------------------------------------- B1's split merge and B2's rows --
#
# The CUDA kernels read each row as a head of fewer than 16 // itemsize
# columns up to its first 16-byte boundary, an aligned body and a tail,
# and cut a row into splits from its body: ``fused_logprob_split_plain``
# states that partition and B1's merge in plain PyTorch.  Views whose rows
# start at every phase: V % 8 is 0, 1 and 6; "prefix" is the scorer's
# [:, :-1] of [B, T, V], "shifted" a 2-D view 3 columns into rows 3 wider.

SPLIT_SPANS = [1, 8, 64, 200, 1000, 4096]


def _split_case(V, layout, dtype, seed):
    """Seeded logits of randn x 4 with a +1e30 row, a -1e30 row and a tied
    row, as a torch view in ``layout`` and the same values as a [N, V]
    jax array; tokens (the view's leading shape) at column 0, V - 1 and
    both sides of the first two split borders of each span, row by row."""
    rng = np.random.default_rng(seed)
    B, T = 3, 9
    pad = 3 if layout == "shifted" else 0
    x = (rng.standard_normal((B, T + 1, V + pad)) * 4).astype(np.float32)
    x[1, 0, pad + 5], x[1, 1], x[1, 2, pad + 3] = 1e30, -1e30, 9.0
    x[1, 2, pad + 99 % V] = 9.0
    j, base = _pair(x, dtype)
    if layout == "prefix":
        view, jl = base[:, :-1], j[:, :-1].reshape(-1, V)
    else:
        view = base.reshape(-1, V + pad)[:, pad:]
        jl = j.reshape(-1, V + pad)[:, pad:]
    heads = fused_logprob.row_heads(view).reshape(-1).tolist()
    cols = [0, V - 1] + [i * s + d for s in SPLIT_SPANS for i in (1, 2)
                         for d in (-1, 0)]
    toks = np.array([min(V - 1, c + (h if 0 < c < V - 1 else 0))
                     for c, h in zip(cols * len(heads), heads)],
                    dtype=np.int32).reshape(view.shape[:-1])
    return view, jl, toks


@pytest.mark.parametrize("layout", ["prefix", "shifted"])
@pytest.mark.parametrize("V", [1024, 257, 1030])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fused_logprob_split_plain_matches_jax(V, layout, dtype, tol):
    """The split merge at every span against the JAX package's kernel in
    interpret mode and against the plain version: m bit for bit, the
    log-probs within the dtype's tolerance; and the views' rows do start
    at several phases."""
    view, jl, toks = _split_case(V, layout, dtype, V)
    heads = set(fused_logprob.row_heads(view).reshape(-1).tolist())
    if layout == "prefix" and V % (16 // view.element_size()):
        assert len(heads) > 1
    want = np.asarray(ops.fused_logprob(jl, jnp.asarray(toks.reshape(-1)),
                                        block_t=32, block_v=128))
    t_toks = torch.as_tensor(toks)
    lp_p, m_p, s_p = fused_logprob.fused_logprob_plain(view.reshape(-1, V),
                                                       t_toks.reshape(-1))
    for span in SPLIT_SPANS:
        lp, m, s = fused_logprob.fused_logprob_split_plain(view, t_toks, span)
        assert lp.shape == m.shape == s.shape == toks.shape
        assert torch.equal(m.reshape(-1), m_p), span
        for ref in (want, lp_p.numpy()):
            got = lp.reshape(-1).numpy()
            same = got == ref      # the -1e30 row scores +inf in bf16
            assert np.isfinite(got[~same]).all(), span
            assert np.max(np.abs(got[~same] - ref[~same]), initial=0) < tol
        close = torch.where(s.reshape(-1) == s_p, 0.0,
                            (s.reshape(-1) - s_p).abs() / s_p)
        assert close.max().item() < 1e-5


@pytest.mark.parametrize("span", [8, 64, 1000])
@pytest.mark.parametrize("V", [1024, 257, 1030])
def test_fused_logprob_bwd_from_split_stats_matches_jax(V, span):
    """The backward from the split merge's stats, on the scorer's [:, :-1]
    view, against the JAX package's backward kernel in interpret mode from
    its own stats, in fp32."""
    view, jl, toks = _split_case(V, "prefix", jnp.float32, V + span)
    g = np.random.default_rng(span).standard_normal(toks.size) \
        .astype(np.float32)
    _, jm, js = jfused_logprob(jl, jnp.asarray(toks.reshape(-1)),
                               block_t=32, block_v=128, interpret=True,
                               return_stats=True)
    want = jfused_logprob_bwd(jl, jnp.asarray(toks.reshape(-1)), jm,
                              jnp.log(js), jnp.asarray(g), block_t=32,
                              block_v=128, interpret=True)
    _, m, s = fused_logprob.fused_logprob_split_plain(
        view, torch.as_tensor(toks), span)
    got = fused_logprob.fused_logprob_bwd_plain(
        view.reshape(-1, V), torch.as_tensor(toks).reshape(-1),
        m.reshape(-1), torch.log(s).reshape(-1), torch.as_tensor(g))
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and np.max(np.abs(got - want)) < 1e-5


# the kernel table's launches at 132 SMs: B1's scoring views ([16, T - 1]
# rows) and chip_smoke.py's misaligned check shape; B2's written
# gradients ([16, T] rows)
FWD_SHAPES = [(1264, 128256), (4592, 202048), (4592, 129280), (5104, 50304),
              (2032, 50304), (2032, 256206), (240, 50310)]
BWD_SHAPES = [(1280, 128256), (1280, 129280), (2048, 50304), (512, 50304),
              (2048, 256206), (1536, 256206)]


def _split_bounds(V, span, n, head):
    """[lo, hi) of each split as ``split_cols`` (common.cuh) cuts a row."""
    return [(0 if i == 0 else head + i * span,
             V if i == n - 1 else head + (i + 1) * span) for i in range(n)]


def _check_plan(V, span, n):
    """What both launchers demand of a plan, for every head a row may
    have: aligned spans that cover the row once, no split empty or past
    span + 7 columns, none under MIN_SPAN unless the row is one split."""
    assert span % fused_logprob.SPAN_ALIGN == 0 and span > 0
    assert n == fused_logprob.n_splits_of(V, span) >= 1
    assert n == 1 or span >= fused_logprob.MIN_SPAN
    for head in range(min(8, V + 1)):
        bounds = _split_bounds(V, span, n, head)
        assert bounds[0][0] == 0 and bounds[-1][1] == V
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(0 < hi - lo < span + 8 for lo, hi in bounds)


def _fill(rows, n):
    """The grid's share of its waves' slots at 132 SMs."""
    slots = fused_logprob.BLOCKS_PER_SM * 132
    return rows * n / (-(-rows * n // slots) * slots)


@pytest.mark.parametrize("rows,V", FWD_SHAPES)
def test_logprob_split_plan_fills_the_card(rows, V):
    """B1's plan at the kernel table's shapes runs in whole waves of
    BLOCKS_PER_SM x 132 blocks, or nearly: the last wave leaves under a
    tenth of the grid's slots idle."""
    span, n = fused_logprob.split_plan(rows, V, 132)
    _check_plan(V, span, n)
    assert n <= fused_logprob.MAX_SPLITS
    assert _fill(rows, n) >= 0.9, (span, n)


@pytest.mark.parametrize("rows,V", BWD_SHAPES)
def test_logprob_bwd_plan_fills_the_card(rows, V):
    """B2's spans of BWD_SPAN columns give the trainers' gradients 7 to
    123 waves, the last one at least 0.9 full."""
    span, n = fused_logprob.bwd_plan(V)
    _check_plan(V, span, n)
    assert span == fused_logprob.BWD_SPAN and n > 1
    assert _fill(rows, n) >= 0.9, (span, n)


def test_logprob_split_plan_at_the_main_shapes():
    """The scorer's 1264 rows of llama31-8b take 5 splits (6 waves, 0.997
    full), [21]'s 2032 rows of V 256206 stay one split a row (2 waves,
    0.962 full), the misaligned check shape of chip_smoke.py takes 4; B2
    cuts llama31-8b's rows into 32 splits of 4096 columns (the last of
    1280 less the head) and [21]'s into 63."""
    assert fused_logprob.split_plan(1264, 128256, 132) == (25656, 5)
    assert fused_logprob.split_plan(2032, 256206, 132) == (256208, 1)
    assert fused_logprob.split_plan(240, 50310, 132) == (12584, 4)
    assert fused_logprob.bwd_plan(128256) == (4096, 32)
    assert fused_logprob.bwd_plan(256206) == (4096, 63)
    assert fused_logprob.bwd_plan(4103) == (4096, 1)
    assert fused_logprob.bwd_plan(4104) == (4096, 2)


@pytest.mark.parametrize("n_sm", [1, 114, 132])
@pytest.mark.parametrize("rows", [1, 16, 240, 1264, 66560])
@pytest.mark.parametrize("V", [1, 7, 8, 9, 257, 1030, 4103, 4104, 8200,
                               50310, 128256, 256206, 2 ** 21 + 3])
def test_logprob_split_plan_invariants(V, rows, n_sm):
    """B1's plans hold what its launcher demands, with at most MAX_SPLITS
    splits (one thread each in its merge), and so do B2's."""
    span, n = fused_logprob.split_plan(rows, V, n_sm)
    _check_plan(V, span, n)
    assert n <= fused_logprob.MAX_SPLITS
    _check_plan(V, *fused_logprob.bwd_plan(V))


@pytest.mark.parametrize("B,S,H,K,hd", [
    (2, 128, 8, 2, 32),
    (1, 64, 4, 4, 64),     # MHA (K == H)
    (2, 256, 8, 1, 16),    # MQA
    (1, 100, 4, 2, 32),    # ragged S
    (1, 128, 10, 2, 192),  # hd 192 (nemotron-4-340b), g = 5 (llama4-scout)
])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_plain_matches_kernel(B, S, H, K, hd, dtype, tol):
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng.standard_normal((B, S, H, hd)) * 0.5, dtype)
    jk, tk = _pair(rng.standard_normal((B, S, K, hd)) * 0.5, dtype)
    jv, tv = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    if S % 32:
        want = ref.flash_attention_ref(jq, jk, jv)
    else:
        want = ops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    got = dispatch.attention(tq, tk, tv)
    assert got.dtype == tq.dtype
    err = np.max(np.abs(_np(got) - np.asarray(want.astype(jnp.float32))))
    assert err < tol
    dense = tref.flash_attention_ref(tq, tk, tv)
    assert np.max(np.abs(_np(got) - _np(dense))) < tol


def test_attention_rejects_what_the_kernel_cannot_take():
    """What the flash kernel cannot take goes to ``chunked_attention``, as
    the reference routes it: 8 queries over 6 keys (cross attention,
    unmasked or causal by position) equal the reference's dispatch within
    1e-5; query heads that are no multiple of the kv heads are
    refused."""
    rng = np.random.default_rng(0)
    qn = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    kn = rng.standard_normal((1, 6, 2, 16)).astype(np.float32)
    q, k = torch.as_tensor(qn), torch.as_tensor(kn)
    for causal in (True, False):
        got = dispatch.attention(q, k, k, causal=causal)
        assert torch.equal(got, chunked_attention(q, k, k, causal=causal))
        want = jdispatch.attention(jnp.asarray(qn), jnp.asarray(kn),
                                   jnp.asarray(kn), causal=causal)
        assert np.max(np.abs(_np(got) - np.asarray(want))) < 1e-5
    with pytest.raises(ValueError, match="multiple"):
        dispatch.attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        fused_sample.fused_sample_cuda(x, prng.PRNGKey(0), 1.0)
    with pytest.raises(ValueError):
        fused_logprob.fused_logprob_cuda(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention_cuda(*(torch.zeros(1, 8, 2, 16),) * 3)

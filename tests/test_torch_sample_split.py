"""The merge rule of the split sampling kernel (B3), on the CPU.

The CUDA kernel cuts each row's vocabulary into spans, samples each span
alone to a partial (m, s, best z, its column and scaled logit), and the
last split of a row merges the partials in split order.
``fused_sample_split_plain`` states that rule in plain PyTorch; here it is
held to ``fused_sample_plain`` (tokens bit for bit; fp32 log-probs within
1e-6 of max(1, |log-prob|), and within n 2^-24 of it where a row has n >
16 splits: the merge adds the n partial sums one after another in fp32,
whose rounding grows with n; one fp32 step at |log-prob| near 30 is 2e-6)
at spans from one column to past the row's end, on rows with
extreme logits and with ties placed across a split boundary, and through
the plain version to the JAX package's kernel (interpret mode) and its
dense oracle on the same seeded numpy logits.  The split plan is checked
for the invariants the launcher enforces.  The kernel itself is held to
the plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_sample import fused_sample as jfused_sample
from repro.kernels.ref import fused_sample_ref
from repro_torch.kernels.fused_sample import BLOCKS_PER_SM, MAX_SPLITS, \
    MIN_SPAN, SPAN_ALIGN, fused_sample_plain, fused_sample_split_plain, \
    split_plan
from repro_torch.rl import prng

TEMPERATURES = [0.0, 0.7, 1.0]


def _logits(B, V, span, seed=0):
    """Seeded rows of randn x 3 with the card tests' extreme rows (one
    dominating logit, a row of -1e30, a duplicate maximum), a duplicate
    maximum on both sides of the first split boundary, and a row of
    -inf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32) * 3
    x[0, 5] = 1e30
    x[1] = -1e30
    x[2, 3] = x[2, 99] = 20.0
    edge = min(span, V - 1)
    x[3, edge - 1] = x[3, edge] = 30.0
    x[4] = -np.inf
    return torch.from_numpy(x)


def _tol(V, span):
    return max(1e-6, -(-V // span) * 2.0 ** -24)


def _assert_lp_close(got, want, tol):
    """|got - want| <= tol max(1, |want|); equal infinities agree (the
    -1e30 row scores +inf at T = 0.7 in both versions)."""
    same = got == want
    assert torch.isfinite(got[~same]).all()
    assert torch.isfinite(want[~same]).all()
    d = torch.where(same, torch.zeros_like(got), (got - want).abs())
    scale = torch.where(same, torch.ones_like(want), want.abs().clamp(min=1.0))
    assert (d / scale).max().item() <= tol


@pytest.mark.parametrize("span", [1, 8, 64, 333, 512, 1000, 1001, 1005])
@pytest.mark.parametrize("V", [1000, 1001])
def test_split_merge_matches_plain(V, span):
    """One-column splits, aligned and ragged spans, one split for the
    whole row, and a span past the row's end."""
    x = _logits(6, V, span)
    key = prng.split(prng.PRNGKey(3), 4)[2]
    for T in TEMPERATURES:
        tok, lp = fused_sample_split_plain(x, key, T, span)
        tok_p, lp_p = fused_sample_plain(x, key, T)
        assert tok.dtype == torch.int32 and lp.dtype == torch.float32
        assert torch.equal(tok, tok_p), (T, tok, tok_p)
        _assert_lp_close(lp, lp_p, _tol(V, span))
        if T == 0.0:
            edge = min(span, V - 1)
            assert tok[2].item() == 3 and tok[3].item() == edge - 1
            assert tok[4].item() == 0


@pytest.mark.parametrize("B,V", [(3, 8200), (4, 8192), (1, 4103)])
def test_split_merge_at_planned_spans(B, V):
    """The spans ``split_plan`` gives at the card's 132 SMs, with a
    ragged last split where V is not a multiple of the span."""
    span, n_splits = split_plan(B, V, 132)
    assert n_splits > 1
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, V))
                         .astype(np.float32) * 3)
    key = prng.split(prng.PRNGKey(11), 2)[1]
    for T in TEMPERATURES:
        tok, lp = fused_sample_split_plain(x, key, T, span)
        tok_p, lp_p = fused_sample_plain(x, key, T)
        assert torch.equal(tok, tok_p)
        _assert_lp_close(lp, lp_p, _tol(V, span))


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("span", [64, 333])
def test_split_merge_matches_jax_reference(temperature, span):
    """Through the plain version to the JAX package's Pallas kernel in
    interpret mode and its dense oracle, on seeded numpy logits."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 515)).astype(np.float32) * 2
    x[2, 63] = x[2, 64] = 9.0      # a duplicate maximum across the edge at 64
    key = 42
    jx = jnp.asarray(x)
    tok_k, lp_k = jfused_sample(jx, jax.random.PRNGKey(key),
                                temperature=temperature, block_v=128)
    tok_r, lp_r = fused_sample_ref(jx, jax.random.PRNGKey(key), temperature)
    tok, lp = fused_sample_split_plain(torch.from_numpy(x), prng.PRNGKey(key),
                                       temperature, span)
    for want_tok, want_lp in ((tok_k, lp_k), (tok_r, lp_r)):
        assert np.array_equal(tok.numpy(), np.asarray(want_tok))
        assert np.max(np.abs(lp.numpy() - np.asarray(want_lp))) < 1e-5
    if temperature == 0.0:
        assert tok[2].item() == 63


@pytest.mark.parametrize("n_sm", [1, 114, 132])
@pytest.mark.parametrize("B", [1, 2, 16, 32, 64, 200, 264, 5000])
@pytest.mark.parametrize("V", [1, 7, 8, 1000, 1001, 2049, 4103, 32000,
                               128256, 256000])
def test_split_plan_invariants(V, B, n_sm):
    """Aligned spans that cover the row with no empty split, no split
    below MIN_SPAN unless the row is one split, at most MAX_SPLITS
    splits (one thread each in the merge), and a grid of at most
    BLOCKS_PER_SM blocks an SM unless the rows alone pass it."""
    span, n = split_plan(B, V, n_sm)
    assert span > 0 and span % SPAN_ALIGN == 0
    assert (n - 1) * span < V <= n * span
    assert 1 <= n <= MAX_SPLITS
    assert n == 1 or span >= MIN_SPAN
    assert B * n <= max(B, BLOCKS_PER_SM * n_sm)


def test_split_plan_fills_the_card_at_the_main_path_shapes():
    """The generator's 16 rows and the engine's pool of 32 at Llama 3.1's
    vocabulary take 16 and 8 splits: 256 blocks on 132 SMs."""
    assert split_plan(16, 128256, 132) == (8016, 16)
    assert split_plan(32, 128256, 132) == (16032, 8)
    assert split_plan(1, 128256, 132) == (2072, 62)
    assert split_plan(300, 128256, 132) == (128256, 1)

"""The merge rule of the split paged-attention kernel (B5), on the CPU.

The CUDA kernel splits a row's logical columns into spans, attends each
span alone and merges the spans' (m, l, acc) by log-sum-exp.
``paged_attention_split_plain`` states that rule in plain PyTorch; here it
is held to ``paged_attention_plain`` (fp32, within 1e-6) at spans from one
column to the whole row, and through it to the JAX package's
``paged_attention_ref`` on the same seeded numpy inputs.  The split plans
of both split kernels (B5's spans, B6's split-K) are checked for the
invariants their launchers enforce.  The kernel itself is held to the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.int8_matmul import GEMV_BK, GEMV_BN, \
    MIN_SPLIT_TILES, gemv_splits
from repro_torch.kernels.paged_attention import paged_attention_plain, \
    paged_attention_split_plain, split_plan


def _problem(pos, B=3, H=4, K=2, hd=16, P=5, mb=4, n_pages=16, seed=0):
    """The reference suite's arena_problem shapes by default; the last
    table column is the trash page."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    ak = rng.standard_normal((n_pages + 1, P, K, hd), dtype=np.float32)
    av = rng.standard_normal((n_pages + 1, P, K, hd), dtype=np.float32)
    pt = rng.integers(0, n_pages, (B, mb + 1)).astype(np.int32)
    pt[:, -1] = n_pages
    return q, ak, av, pt, np.asarray(pos, np.int32)


# (pos, window) over mb * P = 20 columns: splits wholly past pos (pos 3),
# pos 0 in every row, splits wholly below the window (pos 19, window 3),
# the zombie row at the clamp mb * P (pos 20), and a window wider than the
# context
CASES = [([3, 11, 19], 0), ([3, 11, 19], 6), ([0, 0, 0], 0), ([0, 0, 0], 6),
         ([19, 14, 20], 3), ([20, 20, 7], 0), ([20, 1, 12], 100)]


@pytest.mark.parametrize("span", [1, 2, 5, 10, 15, 20, 32])
@pytest.mark.parametrize("pos,window", CASES)
def test_split_merge_matches_plain(pos, window, span):
    """One-column splits (span 1), page-sized and ragged spans, one split
    for the whole row, and a span past the row's end."""
    args = [torch.as_tensor(a) for a in _problem(pos)]
    got = paged_attention_split_plain(*args, window=window, span=span)
    want = paged_attention_plain(*args, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos,window", CASES)
def test_split_merge_matches_jax_reference(pos, window):
    """Through the plain version to the JAX package's gather reference,
    at the reference suite's tolerance, 2e-5."""
    args = _problem(pos)
    want = np.asarray(paged_attention_ref(*map(jnp.asarray, args),
                                          window=window))
    for span in (1, 5, 20):
        got = paged_attention_split_plain(*map(torch.as_tensor, args),
                                          window=window, span=span)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_split_merge_engine_shape():
    """The engine's shape (32 rows, g = 4, hd 128, page 16, 7 pages a
    row) at the span the kernel takes there, cursors ragged across
    split edges and a zombie row at the clamp."""
    B, mb, P = 32, 7, 16
    span, n_splits = split_plan(B, 8, mb, P, 132)
    pos = [48 + 5 * i % 64 for i in range(B - 1)] + [mb * P]
    args = [torch.as_tensor(a) for a in _problem(
        pos, B=B, H=32, K=8, hd=128, P=P, mb=mb, n_pages=B * mb)]
    for window in (0, 6, 100):
        got = paged_attention_split_plain(*args, window=window, span=span)
        want = paged_attention_plain(*args, window=window)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,K,mb,P", [(32, 8, 7, 16), (16, 8, 128, 16),
                                      (3, 2, 4, 5), (1, 1, 1, 1),
                                      (64, 8, 256, 16), (4, 8, 9, 7)])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_split_plan_invariants(B, K, mb, P, n_sm):
    """span is a multiple of P; the splits cover mb * P columns and none
    is empty by construction -- what the launcher refuses otherwise."""
    span, n = split_plan(B, K, mb, P, n_sm)
    assert span > 0 and span % P == 0
    assert n * span >= mb * P > (n - 1) * span


def test_split_plan_at_the_timed_shapes():
    """The engine's 32 rows split four ways (1024 blocks on 132 SMs), the
    16 rows of 2048 columns nine ways."""
    assert split_plan(32, 8, 7, 16, 132) == (32, 4)
    assert split_plan(16, 8, 128, 16, 132) == (240, 9)


@pytest.mark.parametrize("N,K", [(14336, 4096), (4096, 4096), (1024, 4096),
                                 (4096, 14336), (90, 70), (1000, 4096),
                                 (8, 512), (300, 0)])
@pytest.mark.parametrize("slots", [132, 528])
def test_gemv_splits_invariants(N, K, slots):
    """Every split owns at least MIN_SPLIT_TILES K tiles, the last split
    is not empty (the launcher refuses that), and the blocks fit one wave
    where the column tiles alone do."""
    s = gemv_splits(N, K, slots)
    nk = -(-K // GEMV_BK)
    assert s >= 1
    if s > 1:
        per = -(-nk // s)
        assert per >= MIN_SPLIT_TILES and per * (s - 1) < nk
        assert -(-N // GEMV_BN) * s <= slots


def test_gemv_splits_at_w_gate():
    """w_gate [4096, 14336] at decode: 112 column tiles split four ways
    fill 528 resident blocks in one wave."""
    assert gemv_splits(14336, 4096, 528) == 4

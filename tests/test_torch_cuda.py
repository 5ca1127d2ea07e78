"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them.  The
file imports neither jax nor the JAX package, so it runs on a machine
without jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import fused_logprob, fused_sample
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


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,K,hd", [(128, 8, 2, 32), (100, 4, 4, 64),
                                      (77, 8, 1, 16), (130, 4, 2, 128)])
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
# relative in fp32; V = 257 takes the scalar path, 1000 and 4096 the
# 16-byte vector path
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
@pytest.mark.parametrize("V", [1000, 1001])     # 16-byte loads, and not
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
@pytest.mark.parametrize("S,H,K,hd", [(80, 8, 2, 128), (100, 4, 4, 64)])
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

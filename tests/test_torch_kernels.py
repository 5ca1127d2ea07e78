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

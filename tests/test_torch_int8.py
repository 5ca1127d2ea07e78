"""The port's int8 matmul (kernel B6's module) against the JAX package's.

The same seeded numpy inputs go through JAX's Pallas kernel in interpret
mode (``repro.kernels.ops``, as ``tests/test_kernels.py`` runs it), JAX's
dense oracle, and the port's dispatch, which on the CPU takes the plain
version.  The CUDA kernel is held against the plain version on the card
by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ddma import quantize_int8 as jquantize_int8
from repro.kernels import ops, ref
from repro_torch import convert
from repro_torch.core import ddma
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, \
    int8_matmul_plain

# tests/test_kernels.py's shapes and TPU block sizes: M, K, N, bm, bn, bk
SHAPES = [(64, 128, 96, 32, 32, 64),
          (50, 70, 90, 16, 32, 32),     # ragged
          (8, 512, 8, 8, 8, 128)]
# fp32 x: tests/test_kernels.py's own tolerance.  bf16 x: both packages
# widen the same bf16 values to fp32 and multiply by the same int8 values,
# so the products are equal and only the order of the fp32 sum differs,
# as with fp32 x: the same 1e-3 holds (|out| here is at most about 90)
TOL = {jnp.float32: 1e-3, jnp.bfloat16: 1e-3}


def _t(a):
    return convert.from_jax_numpy(np.asarray(jax.device_get(a)), device="cpu")


def _problem(M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.float32).astype(dtype)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
    wq, sc = jquantize_int8(w)
    return x, w, wq, sc


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_int8_matmul_matches_jax(M, K, N, bm, bn, bk, dtype):
    """JAX's kernel and oracle, the port's dispatch and oracle, on the
    same x and the same quantized weights; scale as [N] and as the [1, N]
    ``quantize_int8`` returns."""
    x, _, wq, sc = _problem(M, K, N, dtype, seed=M + K + N)
    want_kernel = ops.int8_matmul(x, wq, sc[0], block_m=bm, block_n=bn,
                                  block_k=bk)
    want_ref = ref.int8_matmul_ref(x, wq, sc[0])
    tx, twq, tsc = _t(x), _t(wq), _t(sc)
    assert twq.dtype == torch.int8 and tsc.shape == (1, N)
    for scale in (tsc[0], tsc):
        got = dispatch.int8_matmul(tx, twq, scale)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert _err(got, want_kernel) < TOL[dtype]
        assert _err(got, want_ref) < TOL[dtype]
    got_ref = tref.int8_matmul_ref(tx, twq, tsc[0])
    assert _err(got_ref, want_ref) < TOL[dtype]


def test_port_quantize_int8_equals_jax():
    """The port's ``ddma.quantize_int8`` gives JAX's int8 values and
    scales bit for bit, so either package's weights feed the other."""
    _, w, wq, sc = _problem(50, 70, 90, jnp.float32, seed=3)
    q, s = ddma.quantize_int8(_t(w))
    assert torch.equal(q, _t(wq)) and torch.equal(s, _t(sc))


def test_plain_applies_the_scale_after_the_sum():
    """The plain version keeps the TPU kernel's order, the fp32 product
    over all of K and then the scale; the oracle dequantizes first."""
    _, _, wq, sc = _problem(8, 512, 8, jnp.float32, seed=4)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((8, 512)),
                        dtype=torch.float32)
    twq, tsc = _t(wq), _t(sc)[0]
    want = (x @ twq.float()) * tsc
    assert torch.equal(int8_matmul_plain(x, twq, tsc), want)
    assert _err(int8_matmul_plain(x, twq, tsc),
                tref.int8_matmul_ref(x, twq, tsc)) < 1e-3


def test_int8_matmul_rejects_bad_scale():
    x = torch.zeros(4, 16)
    wq = torch.zeros(16, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        dispatch.int8_matmul(x, wq, torch.ones(9))
    with pytest.raises(ValueError, match="scale"):
        dispatch.int8_matmul(x, wq, torch.ones(2, 8))


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "scale_dtype",
                                 "shape", "stride", "cpu"])
def test_int8_matmul_cuda_refuses(bad):
    """The wrapper launches only on CUDA tensors of the kernel's types and
    layouts; here on the CPU every call raises, the last for the device."""
    x = torch.zeros(4, 16)
    wq = torch.zeros(16, 8, dtype=torch.int8)
    scale = torch.ones(8)
    if bad == "x_dtype":
        x = x.half()
    elif bad == "w_dtype":
        wq = wq.to(torch.uint8)
    elif bad == "scale_dtype":
        scale = scale.double()
    elif bad == "shape":
        x = torch.zeros(4, 15)
    elif bad == "stride":
        x = torch.zeros(16, 4).t()
    match = {"x_dtype": "fp32 or bf16", "w_dtype": "int8",
             "scale_dtype": "fp32", "shape": "vs w_q",
             "stride": "unit last-dim", "cpu": "CUDA tensors"}[bad]
    with pytest.raises(ValueError, match=match):
        int8_matmul_cuda(x, wq, scale)

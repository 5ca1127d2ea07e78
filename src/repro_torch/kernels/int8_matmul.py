"""Float activations times int8 weights with per-column scales.

Replaces the TPU kernel ``repro/kernels/int8_matmul.py::int8_matmul``
(body ``_kernel``): ``x [M, K]`` (fp32 or bf16) times ``w_q [K, N]`` int8,
accumulated in fp32 over all of K, then multiplied by the per-column
``scale [N]`` once, into an fp32 ``[M, N]`` (the reference's default
``out_dtype``, the only one its dispatch uses).  The TPU block sizes are
not part of the signature.

``int8_matmul_plain`` keeps the TPU kernel's own order: the whole fp32
product first, the scale last.  The dense oracle ``ref.int8_matmul_ref``
dequantizes first, as the reference's does.

CUDA kernel (``csrc/int8_matmul.cu``): one block per [BM, BN] output
tile walks K in 64-deep tiles through a three-stage ``cp.async`` ring in
shared memory, the weights kept as bytes there and converted at use;
ragged M, N and K are masked in the kernel.  bf16 x runs on the tensor
cores (``mma.sync`` m16n8k16, exact products since int8 -> bf16 is
exact), a 16-row tile at decode M and a 128-row one above; fp32 x runs
on the fp32 cores, since TF32 would round x.  At decode M it is bound by
the weight bytes, at prefill M by the operations.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale_vector(scale, N):
    """``scale`` as [N]: accepts [N] and the [1, N] of ``quantize_int8``."""
    if scale.dim() == 2 and scale.shape[0] == 1:
        scale = scale[0]
    if scale.shape != (N,):
        raise ValueError(f"int8_matmul: scale {tuple(scale.shape)} for "
                         f"N = {N}")
    return scale


def int8_matmul_plain(x, w_q, scale):
    """x: [M, K] float; w_q: [K, N] int8; scale: [N] or [1, N] fp32 ->
    [M, N] fp32: the fp32 product over all of K, then the scale."""
    s = _scale_vector(scale, w_q.shape[1])
    return (x.float() @ w_q.float()) * s.float()


_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
         + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def _vec(t) -> int:
    """1 when the rows of a 2-D tensor start on 16-byte boundaries."""
    return int(t.data_ptr() % 16 == 0
               and t.stride(0) * t.element_size() % 16 == 0)


def int8_matmul_cuda(x, w_q, scale):
    """The CUDA kernel on CUDA tensors: x [M, K] fp32 or bf16, w_q [K, N]
    int8, scale [N] or [1, N] fp32, each with unit last-dim stride.
    Returns [M, N] fp32."""
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul_cuda: x fp32 or bf16, w_q int8, scale "
                         f"fp32; got {x.dtype}, {w_q.dtype}, {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul_cuda: x {tuple(x.shape)} vs w_q "
                         f"{tuple(w_q.shape)}")
    M, K = x.shape
    N = w_q.shape[1]
    scale = _scale_vector(scale, N)
    if x.stride(1) != 1 or w_q.stride(1) != 1 or scale.stride(0) != 1:
        raise ValueError("int8_matmul_cuda needs unit last-dim strides")
    if not (x.is_cuda and w_q.is_cuda and scale.is_cuda):
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    fn = build.c_function("int8_matmul", "int8_matmul_launch", _ARGS)
    err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             _DTYPES[x.dtype], M, N, K, x.stride(0), w_q.stride(0), _vec(x),
             _vec(w_q), torch.cuda.current_stream(x.device).cuda_stream)
    build.check("int8_matmul", err)
    return out

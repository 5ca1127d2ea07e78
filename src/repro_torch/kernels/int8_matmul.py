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

CUDA kernels (``csrc/int8_matmul.cu``), every one masking ragged M, N
and K itself and applying the scale once, after the last K tile; int8
widens to bf16 exactly.  bf16 x above 16 rows (prefill, bound by the
operations): 128 x 128 tiles on ``wgmma``, each weight tile widened once a
block into shared memory.  Up to 16 rows (decode, bound by the weight
bytes), bf16 or fp32 x: ``mma.sync`` over a 16-row tile with split-K over
the blocks, planned here by ``gemv_splits`` from the card's resident-block
count; the last block of a column tile sums the splits in order.  fp32 x
runs there exactly as three bf16 parts (TF32 would round x).  fp32 x above
16 rows runs on the fp32 cores.
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


_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
         + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
# the decode kernel's tile (csrc/int8_matmul.cu GV_BN, GV_BK) and the
# fewest K tiles a split takes, so the partials stay small beside the
# weight bytes
GEMV_ROWS, GEMV_BN, GEMV_BK, MIN_SPLIT_TILES = 16, 128, 64, 4
_SLOTS: dict = {}
_SPLITS: dict = {}


def gemv_splits(N: int, K: int, slots: int) -> int:
    """The number of blocks that share each column tile's K at M <= 16:
    as many as one wave of ``slots`` resident blocks holds, each split
    owning at least MIN_SPLIT_TILES K tiles, and none empty."""
    n_tiles, nk = -(-N // GEMV_BN), -(-K // GEMV_BK)
    s = max(1, min(slots // n_tiles, nk // MIN_SPLIT_TILES))
    return -(-nk // -(-nk // s)) if s > 1 else 1


def _gemv_slots(device, dtype_code: int) -> int:
    key = (device, dtype_code)
    if key not in _SLOTS:
        fn = build.c_function("int8_matmul", "int8_matmul_gemv_slots",
                              (ctypes.c_int, ctypes.c_void_p))
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(dtype_code, ctypes.addressof(out))
        if err != 0 or out.value <= 0:
            raise RuntimeError(f"int8_matmul: no resident-block count "
                               f"(cudaError_t {err})")
        _SLOTS[key] = out.value
    return _SLOTS[key]


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
    code = _DTYPES[x.dtype]
    splits, partial, count = 1, None, None
    if M <= GEMV_ROWS:
        key = (x.device, code, N, K)
        splits = _SPLITS.get(key)
        if splits is None:
            splits = _SPLITS[key] = gemv_splits(N, K,
                                                _gemv_slots(x.device, code))
    if splits > 1:
        # the splits' fp32 partials, summed by the kernel's last block
        partial = build.scratch("int8_matmul partials", x.device,
                                splits * M * N, torch.float32).data_ptr()
        count = build.scratch("int8_matmul counters", x.device,
                              -(-N // GEMV_BN), torch.int32).data_ptr()
    fn = build.c_function("int8_matmul", "int8_matmul_launch", _ARGS)
    err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             partial, count, code, M, N, K, x.stride(0), w_q.stride(0),
             _vec(x), _vec(w_q), splits,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("int8_matmul", err)
    return out

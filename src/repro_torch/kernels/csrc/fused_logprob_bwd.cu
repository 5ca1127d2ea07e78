// Fused per-token log-prob, backward: dlogits = g * (onehot(tok) - softmax)
// with the softmax rebuilt from the forward's saved online stats (m, log s).
//
// Replaces the TPU kernel repro/kernels/fused_logprob.py::fused_logprob_bwd
// (body _bwd_kernel).  Every element is independent, so there is no
// reduction: one block per row, threads stride over the vocabulary with
// 16-byte loads and stores where the rows allow.  Bound: bytes (each logit
// read once, each gradient written once).
//
// The logits are read through two row strides, as in the forward, so the
// trainer's logits[:, :-1] is read in place.  The gradient is written for
// the whole [outer, inner, V] tensor the view was cut from: rows t >=
// n_valid get zeros.  Autograd then hands it straight to the full logits,
// with no zero-filled buffer and no scatter of a [B, T-1, V] result.
#include "common.cuh"

template <typename T, int VEC>
__global__ void __launch_bounds__(256) fused_logprob_bwd_kernel(
    const T* __restrict__ logits, int64_t inner, int64_t n_valid, int64_t outer_stride,
    int64_t inner_stride, int64_t V, const int* __restrict__ tokens,
    const float* __restrict__ m, const float* __restrict__ log_s,
    const float* __restrict__ g, T* __restrict__ dl) {
  const int64_t r = blockIdx.x;
  const int64_t b = r / inner, t = r % inner;
  T* out = dl + r * V;
  const int64_t step = (int64_t)blockDim.x * VEC;
  if (t >= n_valid) {
    VecT<T, VEC> z;
#pragma unroll
    for (int u = 0; u < VEC; ++u) z.v[u] = from_f32<T>(0.0f);
    for (int64_t c0 = (int64_t)threadIdx.x * VEC; c0 < V; c0 += step)
      *reinterpret_cast<VecT<T, VEC>*>(out + c0) = z;
    return;
  }
  const int64_t i = b * n_valid + t;
  const T* p = logits + b * outer_stride + t * inner_stride;
  const float mi = m[i], lsi = log_s[i], gi = g[i];
  const int64_t tok = tokens[i];
  for (int64_t c0 = (int64_t)threadIdx.x * VEC; c0 < V; c0 += step) {
    float x[VEC];
    load_f32<T, VEC>(p + c0, x);
    VecT<T, VEC> o;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      // subtract m, then log s: |m| ~ 1e30 would absorb log s in m + log s
      const float prob = expf((x[u] - mi) - lsi);
      const float onehot = (c0 + u == tok) ? 1.0f : 0.0f;
      o.v[u] = from_f32<T>((onehot - prob) * gi);
    }
    *reinterpret_cast<VecT<T, VEC>*>(out + c0) = o;
  }
}

template <typename T>
static cudaError_t launch(const void* logits, long long n_rows, long long inner,
                          long long n_valid, long long outer_stride, long long inner_stride,
                          long long V, const int* tokens, const float* m, const float* log_s,
                          const float* g, void* dl, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = ((uintptr_t)logits % 16 == 0) && ((uintptr_t)dl % 16 == 0) &&
                      (outer_stride * sizeof(T)) % 16 == 0 &&
                      (inner_stride * sizeof(T)) % 16 == 0 && V % VEC == 0;
  const int threads = 256;
  if (vec_ok)
    fused_logprob_bwd_kernel<T, VEC><<<(unsigned)n_rows, threads, 0, stream>>>(
        (const T*)logits, inner, n_valid, outer_stride, inner_stride, V, tokens, m, log_s, g,
        (T*)dl);
  else
    fused_logprob_bwd_kernel<T, 1><<<(unsigned)n_rows, threads, 0, stream>>>(
        (const T*)logits, inner, n_valid, outer_stride, inner_stride, V, tokens, m, log_s, g,
        (T*)dl);
  return cudaGetLastError();
}

extern "C" int fused_logprob_bwd_launch(const void* logits, int dtype, long long n_rows,
                                        long long inner, long long n_valid,
                                        long long outer_stride, long long inner_stride,
                                        long long V, const void* tokens, const void* m,
                                        const void* log_s, const void* g, void* dl,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(logits, n_rows, inner, n_valid, outer_stride, inner_stride, V,
                         (const int*)tokens, (const float*)m, (const float*)log_s,
                         (const float*)g, dl, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(logits, n_rows, inner, n_valid, outer_stride, inner_stride, V,
                                 (const int*)tokens, (const float*)m, (const float*)log_s,
                                 (const float*)g, dl, st);
  return cudaErrorInvalidValue;
}

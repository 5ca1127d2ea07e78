// Fused per-token log-prob, backward: dlogits = g * (onehot(tok) - softmax)
// with the softmax rebuilt from the forward's saved online stats (m, log s).
//
// Replaces the TPU kernel repro/kernels/fused_logprob.py::fused_logprob_bwd
// (body _bwd_kernel).  Bound: bytes (each logit read once, each gradient
// written once: 4 bytes a logit in bf16, so about 40 instructions a logit
// at 3.35 TB/s).  Every element is independent, so there is no reduction
// and no merge.
//
// The logits are read through two row strides, as in the forward, so the
// trainer's logits[:, :-1] is read in place.  The gradient is written for
// the whole [outer, inner, V] tensor the view was cut from: rows t >=
// n_valid get zeros.  Autograd then hands it straight to the full logits,
// with no zero-filled buffer and no scatter of a [B, T-1, V] result.
//
// The grid is rows x n_splits blocks of the output, cut as the forward
// cuts its rows (split_cols in common.cuh): span columns a split from the
// output row's first 16-byte boundary.  The wrapper's bwd_plan sets span
// to 4096 columns: at the trainers' shapes spans of 4096 to 8192 columns
// ran within about 1% of each other and 5-20% ahead of whole rows, and
// tens of waves of such blocks leave little tail.  Each split is an
// edge of fewer than VEC columns, an aligned body and an edge after it;
// the edges go one column a thread, the body as 16-byte stores, two a
// thread an iteration, the zero rows too.  Where the input row has the
// output row's phase modulo 16 bytes, as it always has when the logits
// are contiguous, the body's loads are 16 bytes as well.  Where it has
// not, each thread loads its vector's VEC logits one at a time (the warp
// still reads whole contiguous lines) and stores them as one vector.
//
// The softmax keeps the accurate expf and the order (x - m) - log s:
// subtracting m first keeps |m| ~ 1e30 from absorbing log s.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int UNROLL = 2;
constexpr int64_t MIN_SPAN = 8 * THREADS * UNROLL;
constexpr int64_t SPAN_ALIGN = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) fused_logprob_bwd_kernel(
    const T* __restrict__ logits, int64_t inner, int64_t n_valid, int64_t outer_stride,
    int64_t inner_stride, int64_t V, int64_t span, int n_splits, const int* __restrict__ tokens,
    const float* __restrict__ m, const float* __restrict__ log_s,
    const float* __restrict__ g, T* __restrict__ dl) {
  constexpr int VEC = 16 / sizeof(T);
  using Vec = VecT<T, VEC>;
  const int64_t r = blockIdx.x / n_splits;
  const int split = (int)(blockIdx.x % n_splits);
  const int tid = threadIdx.x;
  const int64_t b = r / inner, t = r % inner;
  T* out = dl + r * V;
  const Cols c = split_cols(out, V, span, split, n_splits);
  const int64_t edge = edge_col<T>(c, tid);
  Vec* ob = reinterpret_cast<Vec*>(out + c.body);
  if (t >= n_valid) {
    Vec z;
#pragma unroll
    for (int e = 0; e < VEC; ++e) z.v[e] = from_f32<T>(0.0f);
    if (edge >= 0) out[edge] = z.v[0];
#pragma unroll 1
    for (int64_t v = tid; v < c.n_vec; v += THREADS) ob[v] = z;
    return;
  }
  const int64_t i = b * n_valid + t;
  const T* p = logits + b * outer_stride + t * inner_stride;
  const float mi = m[i], lsi = log_s[i], gi = g[i];
  const int64_t tok = tokens[i];
  // onehot is 1 where e == hit
  auto grad = [&](float x, int e, int hit) {
    const float prob = expf((x - mi) - lsi);
    return from_f32<T>(((e == hit ? 1.0f : 0.0f) - prob) * gi);
  };
  auto grad_vec = [&](const Vec& x, int64_t col0) {
    const int64_t d = tok - col0;
    const int hit = (d >= 0 && d < VEC) ? (int)d : -1;
    Vec o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = grad(to_f32(x.v[e]), e, hit);
    return o;
  };
  if (edge >= 0) out[edge] = grad(to_f32(p[edge]), 0, edge == tok ? 0 : -1);
  if ((((uintptr_t)p ^ (uintptr_t)out) & 15) == 0) {
    const Vec* ib = reinterpret_cast<const Vec*>(p + c.body);
    int64_t v = tid;
#pragma unroll 1
    for (; v + (UNROLL - 1) * THREADS < c.n_vec; v += UNROLL * THREADS) {
      Vec x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) x[u] = ib[v + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        ob[v + u * THREADS] = grad_vec(x[u], c.body + (v + u * THREADS) * VEC);
    }
#pragma unroll 1
    for (; v < c.n_vec; v += THREADS) ob[v] = grad_vec(ib[v], c.body + v * VEC);
  } else {
#pragma unroll 1
    for (int64_t v = tid; v < c.n_vec; v += THREADS) {
      const int64_t col0 = c.body + v * VEC;
      Vec x;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = p[col0 + e];
      ob[v] = grad_vec(x, col0);
    }
  }
}

template <typename T>
static cudaError_t launch(const void* logits, long long n_rows, long long inner,
                          long long n_valid, long long outer_stride, long long inner_stride,
                          long long V, long long span, int n_splits, const int* tokens,
                          const float* m, const float* log_s, const float* g, void* dl,
                          cudaStream_t stream) {
  // the forward's plans: aligned spans, a last split that is not empty and
  // holds less than span + 8 columns whatever the row's head, and no split
  // under MIN_SPAN when a row splits
  if (n_rows < 1 || V < 1 || n_splits < 1 || span < SPAN_ALIGN || span % SPAN_ALIGN != 0 ||
      V >= n_splits * span + SPAN_ALIGN || n_rows * n_splits > (long long)INT32_MAX ||
      (n_splits > 1 && ((n_splits - 1) * span + SPAN_ALIGN > V || span < MIN_SPAN)))
    return cudaErrorInvalidValue;
  fused_logprob_bwd_kernel<T><<<(unsigned)(n_rows * n_splits), THREADS, 0, stream>>>(
      (const T*)logits, inner, n_valid, outer_stride, inner_stride, V, span, n_splits, tokens,
      m, log_s, g, (T*)dl);
  return cudaGetLastError();
}

extern "C" int fused_logprob_bwd_launch(const void* logits, int dtype, long long n_rows,
                                        long long inner, long long n_valid,
                                        long long outer_stride, long long inner_stride,
                                        long long V, long long span, int n_splits,
                                        const void* tokens, const void* m, const void* log_s,
                                        const void* g, void* dl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(logits, n_rows, inner, n_valid, outer_stride, inner_stride, V, span,
                         n_splits, (const int*)tokens, (const float*)m, (const float*)log_s,
                         (const float*)g, dl, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(logits, n_rows, inner, n_valid, outer_stride, inner_stride, V,
                                 span, n_splits, (const int*)tokens, (const float*)m,
                                 (const float*)log_s, (const float*)g, dl, st);
  return cudaErrorInvalidValue;
}

// Fused Gumbel-max sampling: token and its log-prob in one pass over V.
//
// Replaces the TPU kernel repro/kernels/fused_sample.py::fused_sample
// (body _kernel).  Bound: instruction issue, not bytes.  Each logit is
// read once (2 bytes in bf16), but costs about 78 instructions (the
// bf16 loop's SASS holds 620 for 8 logits): the splitmix32 hash's column
// stage, two accurate logf for the Gumbel noise (most of the count; no
// fast math, so tokens equal the plain version's bit for bit), the
// softmax update and the running argmax.  One block per row, as this kernel
// first was, issued that work from B of the 132 SMs.
//
// So the grid is (row, split): split s owns the columns [s span,
// min(V, (s + 1) span)), span a multiple of 8 (16 bytes of bf16) that the
// wrapper's split_plan sets so that B x n_splits blocks fill the card.
// Threads stride over their split with 16-byte loads where the row
// allows (else one element at a time).  Each thread keeps the online
// softmax (m, s) of the scaled logits, updated once a vector without a
// branch: the vector's max, one rescale, and e^(x - m) by ex2.approx (the
// log-prob is held to 1e-4, the tokens exactly, so only the noise keeps
// the accurate logf); and its best Gumbel score z with that z's column
// and scaled logit.  Columns rise within a thread, so a strict > keeps
// the first maximum.  The noise is the reference's hash of (absolute
// row, absolute column, key words) in native uint32, its row stage
// hoisted out of the loop, its mantissa step exact, and -log(-log(u));
// the scaled logit and z are rounded as separate IEEE operations.  A
// block merge combines the threads, ties going to the lower column.
//
// Merge across splits, in the same launch: a row of one split is written
// by its block.  Otherwise each split writes its partial (m, s, z, col,
// x) to an fp32 workspace and counts itself in the row's counter; the
// last block of the row to arrive resets the counter to zero and merges
// the row's partials in split order: M = max m, s = sum of s_i e^(m_i - M)
// with the accurate expf, added in split order by one thread, and the
// first split of the largest z (ties to the lower split, which holds the
// lower columns).  The result depends on no timing and is the same from
// call to call; fused_sample_split_plain states the rule.  The
// log-prob is (x_best - M) - log s, m subtracted first.
//
// On a shard of the vocabulary (tensor-parallel serving: a rank holds the
// columns [col0, col0 + V) of rows [row0, row0 + B) of the whole draw)
// the noise and the kept column are those of the absolute (row0 + row,
// col0 + col), so a rank's draw is the whole draw's on its columns.  With
// part_out the row's merged partial (M, s, z, col, x) is written in place
// of (token, log-prob), col as a float (-1 where no z beat -inf): the
// ranks' partials are then merged in rank order by the same rule
// (dispatch.sample_vocab_parallel).  fused_sample_launch is the whole
// row's launch, row0 = col0 = 0 and no partial.
#include "common.cuh"
#include <limits.h>

constexpr int THREADS = 256;
constexpr int MAX_SPLITS = THREADS;   // the merge gives each split one thread
constexpr int MIN_SPAN = 8 * THREADS;  // the wrapper's split_plan cuts no split below it
constexpr int PART = 5;               // a partial: m, s, z, col (an int), x

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the noise at column col, given hk = the row stage plus k1
__device__ __forceinline__ float gumbel(uint32_t hk, uint32_t col) {
  uint32_t x = mix32(hk + col * 0x85EBCA6Bu);
  float u = __fmul_rn(__fadd_rn((float)(x >> 8), 0.5f), 1.0f / 16777216.0f);
  return -logf(-logf(u));
}

struct Best { float z; int col; float x; };

__device__ __forceinline__ Best best_merge(Best a, Best b) {
  return (b.z > a.z || (b.z == a.z && b.col < a.col)) ? b : a;
}

// a row whose every z is -inf keeps column 0, as the plain version does
__device__ __forceinline__ int token_of(const Best& b) { return b.col == INT_MAX ? 0 : b.col; }

// a partial's column as a float: exact below 2^24, -1 where no z beat -inf
__device__ __forceinline__ float col_of(const Best& b) {
  return b.col == INT_MAX ? -1.0f : (float)b.col;
}

__device__ __forceinline__ void write_part(float* w, float m, float s, const Best& b) {
  w[0] = m;
  w[1] = s;
  w[2] = b.z;
  w[3] = col_of(b);
  w[4] = b.x;
}

template <typename T, int VEC, bool NOISY>
__global__ void __launch_bounds__(THREADS)
fused_sample_kernel(const T* __restrict__ logits, int64_t V, int64_t row_stride, uint32_t k0,
                    uint32_t k1, float inv_temp, int64_t span, int64_t row0, int64_t col0,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int* __restrict__ tok_out, float* __restrict__ lp_out,
                    float* __restrict__ part_out) {
  const int row = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const T* p = logits + (int64_t)row * row_stride;
  const int64_t end = (int64_t)(split + 1) * span, hi = end < V ? end : V;
  const uint32_t hk = mix32((uint32_t)(row0 + row) * 0x9E3779B9u + k0) + k1;
  MS st = {NEG_INF_F, 0.0f};
  Best best = {-INFINITY, INT_MAX, NEG_INF_F};
#pragma unroll 1
  for (int64_t c0 = (int64_t)split * span + threadIdx.x * VEC; c0 < hi; c0 += THREADS * VEC) {
    float x[VEC];
    load_f32<T, VEC>(p + c0, x);
    float m = st.m;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      x[u] = __fmul_rn(x[u], inv_temp);
      m = fmaxf(m, x[u]);
    }
    float s = st.s * exp_approx(st.m - m);
#pragma unroll
    for (int u = 0; u < VEC; ++u) s += exp_approx(x[u] - m);
    st = {m, s};
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int col = (int)(col0 + c0 + u);
      const float z = NOISY ? __fadd_rn(x[u], gumbel(hk, (uint32_t)col)) : x[u];
      if (z > best.z) best = {z, col, x[u]};
    }
  }
  st = block_merge(
      st, MS{NEG_INF_F, 0.0f}, [](MS a, int off) { return ms_shfl_xor(a, off); },
      [](MS a, MS b) { return ms_merge(a, b); });
  best = block_merge(
      best, Best{-INFINITY, INT_MAX, NEG_INF_F},
      [](Best b, int off) {
        return Best{__shfl_xor_sync(FULL_MASK, b.z, off), __shfl_xor_sync(FULL_MASK, b.col, off),
                    __shfl_xor_sync(FULL_MASK, b.x, off)};
      },
      [](Best a, Best b) { return best_merge(a, b); });
  const int tid = threadIdx.x;
  if (n_splits == 1) {
    if (tid == 0 && part_out != nullptr) {
      write_part(part_out + (int64_t)row * PART, st.m, st.s, best);
    } else if (tid == 0) {
      tok_out[row] = token_of(best);
      // subtract m before log s: |m| ~ 1e30 would absorb log s in m + log s
      lp_out[row] = (best.x - st.m) - logf(st.s);
    }
    return;
  }

  // this split's partial, then the last split of the row to arrive merges
  if (tid == 0) {
    float* w = ws + ((int64_t)row * n_splits + split) * PART;
    w[0] = st.m;
    w[1] = st.s;
    w[2] = best.z;
    reinterpret_cast<int*>(w)[3] = best.col;
    w[4] = best.x;
  }
  if (!last_to_arrive(&counters[row], n_splits)) return;
  __shared__ float term_s[MAX_SPLITS], z_s[MAX_SPLITS], x_s[MAX_SPLITS];
  __shared__ int col_s[MAX_SPLITS];
  float m_t = -INFINITY, s_t = 0.0f;
  if (tid < n_splits) {
    const float* w = ws + ((int64_t)row * n_splits + tid) * PART;
    m_t = __ldcg(w);
    s_t = __ldcg(w + 1);
    z_s[tid] = __ldcg(w + 2);
    col_s[tid] = __ldcg(reinterpret_cast<const int*>(w) + 3);
    x_s[tid] = __ldcg(w + 4);
  }
  const float M = block_merge(
      m_t, -INFINITY, [](float a, int off) { return __shfl_xor_sync(FULL_MASK, a, off); },
      [](float a, float b) { return fmaxf(a, b); });
  if (tid < n_splits) term_s[tid] = s_t * expf(m_t - M);
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    Best b = {-INFINITY, INT_MAX, NEG_INF_F};
    for (int i = 0; i < n_splits; ++i) {   // split order
      s += term_s[i];
      if (z_s[i] > b.z) b = {z_s[i], col_s[i], x_s[i]};
    }
    if (part_out != nullptr) {
      write_part(part_out + (int64_t)row * PART, M, s, b);
      return;
    }
    tok_out[row] = token_of(b);
    lp_out[row] = (b.x - M) - logf(s);
  }
}

template <typename T, int VEC>
static cudaError_t launch_vec(const T* logits, long long B, long long V, long long row_stride,
                              uint32_t k0, uint32_t k1, float inv_temp, int noisy,
                              long long span, int n_splits, long long row0, long long col0,
                              float* ws, int* counters, int* tok, float* lp, float* part,
                              cudaStream_t stream) {
  dim3 grid((unsigned)B, (unsigned)n_splits);
  if (noisy)
    fused_sample_kernel<T, VEC, true><<<grid, THREADS, 0, stream>>>(
        logits, V, row_stride, k0, k1, inv_temp, span, row0, col0, ws, counters, tok, lp, part);
  else
    fused_sample_kernel<T, VEC, false><<<grid, THREADS, 0, stream>>>(
        logits, V, row_stride, k0, k1, inv_temp, span, row0, col0, ws, counters, tok, lp, part);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* logits, long long B, long long V, long long row_stride,
                          uint32_t k0, uint32_t k1, float inv_temp, int noisy, long long span,
                          int n_splits, long long row0, long long col0, float* ws, int* counters,
                          int* tok, float* lp, float* part, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (n_splits < 1 || n_splits > MAX_SPLITS || span % 8 != 0 || (n_splits - 1) * span >= V ||
      n_splits * span < V || row0 < 0 || col0 < 0 || col0 + V > (1LL << 24) ||
      (part == nullptr && (tok == nullptr || lp == nullptr)) ||
      (n_splits > 1 && (span < MIN_SPAN || ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec_ok = ((uintptr_t)logits % 16 == 0) && (row_stride * sizeof(T)) % 16 == 0 &&
                      V % VEC == 0;
  if (vec_ok)
    return launch_vec<T, VEC>((const T*)logits, B, V, row_stride, k0, k1, inv_temp, noisy, span,
                              n_splits, row0, col0, ws, counters, tok, lp, part, stream);
  return launch_vec<T, 1>((const T*)logits, B, V, row_stride, k0, k1, inv_temp, noisy, span,
                          n_splits, row0, col0, ws, counters, tok, lp, part, stream);
}

// rows [row0, row0 + B) and columns [col0, col0 + V) of the whole draw;
// with part non-null each row's merged partial (5 floats) in place of
// (token, log-prob)
extern "C" int fused_sample_launch_at(const void* logits, int dtype, long long B, long long V,
                                      long long row_stride, uint32_t k0, uint32_t k1,
                                      float inv_temp, int noisy, long long span, int n_splits,
                                      long long row0, long long col0, void* ws, void* counters,
                                      void* tok, void* lp, void* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(logits, B, V, row_stride, k0, k1, inv_temp, noisy, span, n_splits, row0,
                         col0, (float*)ws, (int*)counters, (int*)tok, (float*)lp, (float*)part, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(logits, B, V, row_stride, k0, k1, inv_temp, noisy, span,
                                 n_splits, row0, col0, (float*)ws, (int*)counters, (int*)tok,
                                 (float*)lp, (float*)part, s);
  return cudaErrorInvalidValue;
}

extern "C" int fused_sample_launch(const void* logits, int dtype, long long B, long long V,
                                   long long row_stride, uint32_t k0, uint32_t k1,
                                   float inv_temp, int noisy, long long span, int n_splits,
                                   void* ws, void* counters, void* tok, void* lp,
                                   void* stream) {
  return fused_sample_launch_at(logits, dtype, B, V, row_stride, k0, k1, inv_temp, noisy, span,
                                n_splits, 0, 0, ws, counters, tok, lp, nullptr, stream);
}

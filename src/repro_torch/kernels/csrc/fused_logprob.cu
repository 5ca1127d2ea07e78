// Fused per-token log-prob, forward: log_softmax(logits)[tok] with the
// online (m, s) stats, no [T, V] intermediate.
//
// Replaces the TPU kernel repro/kernels/fused_logprob.py::fused_logprob
// (body _kernel).  Bound: bytes.  Each logit is read once, 2 bytes in
// bf16: at 3.35 TB/s that leaves about 20 instructions a logit to the
// 132 SMs.  Row r lives at (r / inner) * outer_stride + (r % inner) *
// inner_stride, so a strided view such as logits[:, :-1] is read in
// place; its rows start at any 2-byte phase (V 256206 is 6 mod 8).
//
// So the design does three things:
// - Any alignment, 16-byte loads.  Each row is a head of fewer than VEC
//   columns up to its first 16-byte boundary, an aligned body read with
//   16-byte loads, and a tail of fewer than VEC columns (split_cols in
//   common.cuh).  Head and tail go one column a thread.
// - The vocabulary split over blocks.  The grid is rows x n_splits
//   blocks; split s owns [head + s span, head + (s + 1) span) of its row
//   (split 0 from column 0, the last to V), span a multiple of 8 that
//   the wrapper's split_plan sets so that the blocks fill the card's
//   8-a-SM slots in whole waves, or nearly.  __launch_bounds__ holds a
//   thread to 32 registers, so 8 blocks of 256 fill an SM's 2048 threads.
// - An update cheap enough for the bytes: each thread loads two 16-byte
//   vectors (evict-first: each logit is read once), then folds all their
//   logits into its online (m, s) at once, with no branch: their max, one
//   rescale of s, and e^(x - m) of each by exp_approx (ms_push in
//   common.cuh).  m is a max, so it is exact.
//
// A block merge combines the threads.  A row of one split is finished by
// its block.  Otherwise each split writes its (m, s) to an fp32 workspace
// and counts itself in the row's counter; the last block of the row to
// arrive resets the counter and merges the partials in split order: M =
// max m_i, s = the sum of s_i e^(m_i - M) with the accurate expf, added in
// split order by one thread.  It reads the target logit (NEG_INF for a
// token outside [0, V)) and writes (t - M) - log s, M and s.  The result
// depends on no timing; fused_logprob_split_plain states the rule.
#include "common.cuh"

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int UNROLL = 2;              // 16-byte loads a thread issues before it updates
constexpr int MAX_SPLITS = THREADS;    // the merge gives each split one thread
constexpr int64_t MIN_SPAN = 8 * THREADS * UNROLL;  // split_plan cuts no split below it
constexpr int64_t SPAN_ALIGN = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
fused_logprob_kernel(const T* __restrict__ logits, int64_t inner, int64_t outer_stride,
                     int64_t inner_stride, int64_t V, int64_t span, int n_splits,
                     const int* __restrict__ tokens, float* __restrict__ ws,
                     int* __restrict__ counters, float* __restrict__ logp,
                     float* __restrict__ m_out, float* __restrict__ s_out) {
  constexpr int VEC = 16 / sizeof(T);
  using Vec = VecT<T, VEC>;
  const int64_t r = blockIdx.x / n_splits;
  const int split = (int)(blockIdx.x % n_splits);
  const int tid = threadIdx.x;
  const T* p = logits + (r / inner) * outer_stride + (r % inner) * inner_stride;
  const Cols c = split_cols(p, V, span, split, n_splits);
  MS st = {NEG_INF_F, 0.0f};
  {
    const int64_t col = edge_col<T>(c, tid);
    if (col >= 0) {
      const float x = to_f32(p[col]);
      ms_push<1>(st, &x);
    }
  }
  const Vec* body = reinterpret_cast<const Vec*>(p + c.body);
  int64_t v = tid;
#pragma unroll 1
  for (; v + (UNROLL - 1) * THREADS < c.n_vec; v += UNROLL * THREADS) {
    Vec raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = load_once(body + v + u * THREADS);
    float x[UNROLL * VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[u * VEC + e] = to_f32(raw[u].v[e]);
    ms_push<UNROLL * VEC>(st, x);
  }
#pragma unroll 1
  for (; v < c.n_vec; v += THREADS) {   // fewer than UNROLL vectors left
    const Vec raw = load_once(body + v);
    float x[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f32(raw.v[e]);
    ms_push<VEC>(st, x);
  }
  st = block_merge(
      st, MS{NEG_INF_F, 0.0f}, [](MS a, int off) { return ms_shfl_xor(a, off); },
      [](MS a, MS b) { return ms_merge(a, b); });

  float M = st.m, s = st.s;
  if (n_splits > 1) {
    if (tid == 0) {
      float* w = ws + (r * n_splits + split) * 2;
      w[0] = st.m;
      w[1] = st.s;
    }
    if (!last_to_arrive(&counters[r], n_splits)) return;
    __shared__ float term_s[MAX_SPLITS];
    float m_t = -INFINITY, s_t = 0.0f;
    if (tid < n_splits) {
      const float* w = ws + (r * n_splits + tid) * 2;
      m_t = __ldcg(w);
      s_t = __ldcg(w + 1);
    }
    M = block_merge(
        m_t, -INFINITY, [](float a, int off) { return __shfl_xor_sync(FULL_MASK, a, off); },
        [](float a, float b) { return fmaxf(a, b); });
    if (tid < n_splits) term_s[tid] = s_t * expf(m_t - M);
    __syncthreads();
    if (tid == 0) {
      s = 0.0f;
      for (int i = 0; i < n_splits; ++i) s += term_s[i];   // split order
    }
  }
  if (tid == 0) {
    const int tok = tokens[r];
    const float t = (tok >= 0 && tok < V) ? to_f32(p[tok]) : NEG_INF_F;
    // subtract m before log s: |m| ~ 1e30 would absorb log s in m + log s
    logp[r] = (t - M) - logf(s);
    m_out[r] = M;
    s_out[r] = s;
  }
}

template <typename T>
static cudaError_t launch(const void* logits, long long n_rows, long long inner,
                          long long outer_stride, long long inner_stride, long long V,
                          long long span, int n_splits, const int* tokens, float* ws,
                          int* counters, float* logp, float* m, float* s, cudaStream_t stream) {
  // only the plans split_plan gives: aligned spans, at most MAX_SPLITS, a
  // last split that is not empty and holds less than span + 8 columns
  // whatever the row's head, and no split under MIN_SPAN when a row splits
  if (n_rows < 1 || V < 1 || n_splits < 1 || n_splits > MAX_SPLITS || span < SPAN_ALIGN ||
      span % SPAN_ALIGN != 0 || V >= n_splits * span + SPAN_ALIGN ||
      n_rows * n_splits > (long long)INT32_MAX ||
      (n_splits > 1 && ((n_splits - 1) * span + SPAN_ALIGN > V || span < MIN_SPAN ||
                        ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  fused_logprob_kernel<T><<<(unsigned)(n_rows * n_splits), THREADS, 0, stream>>>(
      (const T*)logits, inner, outer_stride, inner_stride, V, span, n_splits, tokens, ws,
      counters, logp, m, s);
  return cudaGetLastError();
}

extern "C" int fused_logprob_launch(const void* logits, int dtype, long long n_rows,
                                    long long inner, long long outer_stride,
                                    long long inner_stride, long long V, long long span,
                                    int n_splits, const void* tokens, void* ws, void* counters,
                                    void* logp, void* m, void* s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(logits, n_rows, inner, outer_stride, inner_stride, V, span, n_splits,
                         (const int*)tokens, (float*)ws, (int*)counters, (float*)logp,
                         (float*)m, (float*)s, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(logits, n_rows, inner, outer_stride, inner_stride, V, span,
                                 n_splits, (const int*)tokens, (float*)ws, (int*)counters,
                                 (float*)logp, (float*)m, (float*)s, st);
  return cudaErrorInvalidValue;
}

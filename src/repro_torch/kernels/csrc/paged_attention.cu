// Paged-attention decode: one query token per row over the row's page
// table into a shared KV arena [n_pages + 1, P, KH, HD].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_kernel (body _kernel).  Bound: bytes (each needed K and
// V element read once; 4 g HD operations a column and kv head), and at
// the engine's small batch, latency: one block per (row, kv head) walking
// its columns alone leaves the card mostly idle.  So the grid is (row x
// kv head, split): split s owns the logical columns [s span, (s + 1) span),
// span a multiple of the page size P that the wrapper sets from the
// table's width alone (never from pos, which lives on the card).  A block
// whose span holds none of the row's valid columns [lo, min(pos, S - 1)]
// (lo = pos - window + 1 with a window, else 0) exits at once.
//
// Within a split, tiles of TT = 32 columns come by 16-byte cp.async, in
// the arena's own dtype, into a two-buffer ring; each column's page id is
// loaded from the table as it goes, so no slot past the cursor, or wholly
// below the window, is read.  A staged column is padded by 16 bytes (an
// odd number of 16-byte chunks a column), so lanes reading one column
// each are free of bank conflicts.  Warp w takes query heads w, w + 4,
// ...: lane t scores column t and the online softmax (m, l) is merged by
// xor shuffles; p goes through shared memory, and each thread keeps the
// fp32 P V sums of its (head, dim) pairs (V's columns past the tile's end
// are zero-filled).  Masked lanes score -1e30 and their p is re-zeroed
// under the mask; the denominator is floored at 1e-30, as in the
// reference.  HD is 16, 32, 64, 128 or 192: each is a whole number of
// 16-byte chunks a column in either dtype, which is all the staging and
// the (head, dim) split of the P V sums need.
//
// Merge: a row whose valid columns lie in one split writes its output
// from that block.  Otherwise each non-empty split writes (m, l, acc) to
// an fp32 workspace, and the last of them to finish (an atomic counter a
// (row, kv head), reset by that block) combines the splits by
// log-sum-exp; empty splits write nothing and are never read.
#include "mma.cuh"

constexpr int THREADS = 128, NWARPS = THREADS / 32, TT = 32, GMAX = 16;

// GM: the most query heads a kv head has that this instance holds (4,
// Llama's group, or GMAX); registers and static shared memory scale with it
template <typename TKV, int HD, int GM>
struct Paged {
  static constexpr int HPW = GM / NWARPS;               // heads a warp, at most
  static constexpr int VEC = 16 / sizeof(TKV);          // elements a chunk
  static constexpr int CPC = HD / VEC;                  // chunks a column
  static constexpr int ROW = HD * sizeof(TKV) + 16;     // bytes a staged column
  static constexpr int TILE = TT * ROW;
  static constexpr int ACC = (GM * HD + THREADS - 1) / THREADS;     // acc a thread
  static constexpr int LOADS = (TT * CPC + THREADS - 1) / THREADS;   // chunks a thread
  // [K, V] of buffer 0, then of buffer 1: a split of one tile needs
  // only the first two
  static constexpr int smem(int n_buf) { return 2 * n_buf * TILE; }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

template <typename TQ, typename TKV, int HD, int GM>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ ak,
                       const TKV* __restrict__ av, const int* __restrict__ table,
                       const int* __restrict__ pos, TKV* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters, int H, int KH,
                       int P, int mb, int64_t q_sb, int64_t q_sh, int64_t t_sb, int window,
                       float scale, int span) {
  using C = Paged<TKV, HD, GM>;
  constexpr int HPW = C::HPW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float qs[GM][HD];
  __shared__ float ps[GM][TT];
  __shared__ float alpha_s[GM];
  __shared__ float m_s[GM];
  __shared__ float l_s[GM];
  unsigned char* kbuf = smem;               // buffer b's K at 2 b TILE
  unsigned char* vbuf = smem + C::TILE;     // and its V one TILE on

  const int bk = blockIdx.x, b = bk / KH, kh = bk % KH, split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int g = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p_b = pos[b];
  const int hi = min(p_b, mb * P - 1);
  const int lo = window > 0 ? max(0, p_b - window + 1) : 0;
  TKV* ob = out + ((int64_t)b * H + kh * g) * HD;
  if (lo > hi) {   // no valid column (a window past the clamp): zeros
    if (split == 0)
      for (int i = tid; i < g * HD; i += THREADS) ob[i] = from_f32<TKV>(0.0f);
    return;
  }
  const int s_lo = lo / span, s_hi = hi / span;
  if (split < s_lo || split > s_hi) return;   // no valid column here
  const int c_lo = max(lo, split * span), c_hi = min(hi, split * span + span - 1);
  const int n_tiles = (c_hi - c_lo + TT) / TT;
  const int* trow = table + b * t_sb;

  // tile `tile`'s K and V columns into buffer `buf`, 16 bytes a copy;
  // V's columns past the tile's end are zeros, so the fixed-length P V
  // loop below adds 0 * 0 there
  auto load = [&](int buf, int tile) {
    const int c0 = c_lo + tile * TT, n = min(TT, c_hi - c0 + 1);
#pragma unroll
    for (int j = 0; j < C::LOADS; ++j) {
      const int i = tid + j * THREADS, t = i / C::CPC, c = i % C::CPC;
      const int so = buf * 2 * C::TILE + t * C::ROW + c * 16;
      if (i < TT * C::CPC && t < n) {
        const int col = c0 + t;
        const int64_t page = trow[col / P];
        const int64_t off = ((page * P + col % P) * KH + kh) * HD + c * C::VEC;
        cp_async16(kbuf + so, ak + off);
        cp_async16(vbuf + so, av + off);
      } else if (i < TT * C::CPC) {
        *reinterpret_cast<uint4*>(vbuf + so) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load(0, 0);
  cp_async_commit();
  for (int idx = tid; idx < g * HD; idx += THREADS)
    qs[idx / HD][idx % HD] = to_f32(q[b * q_sb + (int64_t)(kh * g + idx / HD) * q_sh + idx % HD]);

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.0f;
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) { m_run[i] = NEG_INF_F; l_run[i] = 0.0f; }

  for (int it = 0; it < n_tiles; ++it) {
    // the other buffer was last read in iteration it - 1, which every
    // thread finished before that iteration's closing barrier
    if (it + 1 < n_tiles) load((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int n = min(TT, c_hi - (c_lo + it * TT) + 1);
    const unsigned char* kt = kbuf + (it & 1) * 2 * C::TILE;
    const TKV* vt = reinterpret_cast<const TKV*>(vbuf + (it & 1) * 2 * C::TILE);

    // scores: warp w takes heads w, w + 4, ..., lane t column t
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = warp + i * NWARPS;
      if (h < g) {
        const bool valid = lane < n;
        float dot = 0.0f;
        if (valid) {
          const VecT<TKV, C::VEC>* kr =
              reinterpret_cast<const VecT<TKV, C::VEC>*>(kt + lane * C::ROW);
#pragma unroll 8
          for (int c = 0; c < C::CPC; ++c) {
            const VecT<TKV, C::VEC> kv = kr[c];
#pragma unroll
            for (int u = 0; u < C::VEC; ++u) dot += qs[h][c * C::VEC + u] * to_f32(kv.v[u]);
          }
        }
        const float s = valid ? dot * scale : NEG_INF_F;
        const float m_new = fmaxf(m_run[i], warp_max(s));
        // a tile with no valid column keeps m at -1e30, where exp(s - m)
        // would be 1: re-zero p under the mask
        const float p = valid ? expf(s - m_new) : 0.0f;
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * alpha + warp_sum(p);
        m_run[i] = m_new;
        ps[h][lane] = p;
        if (lane == 0) alpha_s[h] = alpha;
      }
    }
    __syncthreads();

    // acc += P V (p and V are zeros past the tile's valid columns)
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) {
      const int idx = tid + i * THREADS, h = idx / HD, d = idx % HD;
      if (h < g) {
        float a = acc[i] * alpha_s[h];
#pragma unroll 8
        for (int t = 0; t < TT; ++t) a += ps[h][t] * to_f32(vt[t * (C::ROW / sizeof(TKV)) + d]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = warp + i * NWARPS;
    if (h < g && lane == 0) {
      m_s[h] = m_run[i];
      l_s[h] = l_run[i];
    }
  }
  __syncthreads();
  if (s_lo == s_hi) {   // the whole row in this split
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) {
      const int idx = tid + i * THREADS, h = idx / HD;
      if (h < g) ob[idx] = from_f32<TKV>(acc[i] / fmaxf(l_s[h], 1e-30f));
    }
    return;
  }

  // this split's (m [g], l [g], acc [g, HD]) at ws[(bk, split)], then the
  // last split to finish merges s_lo .. s_hi
  const int stride = g * (HD + 2);
  float* wp = ws + ((int64_t)bk * n_splits + split) * stride;
  if (tid < g) {
    wp[tid] = m_s[tid];
    wp[g + tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < g * HD) wp[2 * g + idx] = acc[i];
  }
  if (!last_to_arrive(&counters[bk], s_hi - s_lo + 1)) return;   // the non-empty splits
  const float* wr = ws + (int64_t)bk * n_splits * stride;
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    const int idx = tid + i * THREADS, h = idx / HD;
    if (h >= g) continue;
    float m = NEG_INF_F, num = 0.0f, den = 0.0f;
    for (int s0 = s_lo; s0 <= s_hi; s0 += 4) {
      float ms[4], ls[4], as[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {   // four splits' loads in flight at once
        const float* w = wr + (s0 + u) * stride;
        const bool in = s0 + u <= s_hi;
        ms[u] = in ? __ldcg(w + h) : NEG_INF_F;
        ls[u] = in ? __ldcg(w + g + h) : 0.0f;
        as[u] = in ? __ldcg(w + 2 * g + idx) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {   // online log-sum-exp; an absent split adds 0
        const float m_new = fmaxf(m, ms[u]);
        const float a_old = expf(m - m_new), a_new = expf(ms[u] - m_new);
        num = num * a_old + as[u] * a_new;
        den = den * a_old + ls[u] * a_new;
        m = m_new;
      }
    }
    ob[idx] = from_f32<TKV>(num / fmaxf(den, 1e-30f));
  }
}

// The dynamic shared memory of each instance is set once a device, at
// two buffers, on its first launch there; a split of one tile takes one.
template <typename TQ, typename TKV, int HD, int GM>
static cudaError_t launch_gm(const void* q, const void* ak, const void* av, const void* table,
                             const void* pos, void* out, void* ws, void* counters, int B,
                             int H, int KH, int P, int mb, long long q_sb, long long q_sh,
                             long long t_sb, int window, float scale, int span, int n_splits,
                             cudaStream_t stream) {
  using C = Paged<TKV, HD, GM>;
  auto kernel = paged_attention_kernel<TQ, TKV, HD, GM>;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(kernel, C::smem(2), done);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * KH), (unsigned)n_splits);
  kernel<<<grid, THREADS, C::smem(span > TT ? 2 : 1), stream>>>(
      (const TQ*)q, (const TKV*)ak, (const TKV*)av, (const int*)table, (const int*)pos,
      (TKV*)out, (float*)ws, (int*)counters, H, KH, P, mb, q_sb, q_sh, t_sb, window, scale,
      span);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
static cudaError_t launch(const void* q, const void* ak, const void* av, const void* table,
                          const void* pos, void* out, void* ws, void* counters, int B, int H,
                          int KH, int P, int mb, long long q_sb, long long q_sh,
                          long long t_sb, int window, float scale, int span, int n_splits,
                          cudaStream_t stream) {
  if (H / KH <= 4)
    return launch_gm<TQ, TKV, HD, 4>(q, ak, av, table, pos, out, ws, counters, B, H, KH, P,
                                     mb, q_sb, q_sh, t_sb, window, scale, span, n_splits,
                                     stream);
  return launch_gm<TQ, TKV, HD, GMAX>(q, ak, av, table, pos, out, ws, counters, B, H, KH, P,
                                      mb, q_sb, q_sh, t_sb, window, scale, span, n_splits,
                                      stream);
}

template <typename TQ, typename TKV>
static cudaError_t launch_hd(const void* q, const void* ak, const void* av, const void* table,
                             const void* pos, void* out, void* ws, void* counters, int B,
                             int H, int KH, int HD, int P, int mb, long long q_sb,
                             long long q_sh, long long t_sb, int window, float scale,
                             int span, int n_splits, cudaStream_t s) {
#define PA_CASE(D)                                                                         \
  case D:                                                                                  \
    return launch<TQ, TKV, D>(q, ak, av, table, pos, out, ws, counters, B, H, KH, P, mb,  \
                              q_sb, q_sh, t_sb, window, scale, span, n_splits, s);
  switch (HD) {
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
    // nemotron-4-340b: 24 chunks a bf16 column (48 fp32), not a power of
    // two; the layout above takes any HD that is a multiple of 16 bytes
    PA_CASE(192)
    default: return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

// span: the logical columns a split owns, a multiple of P; n_splits *
// span covers mb * P.  ws: B * KH * n_splits * g * (HD + 2) fp32 and
// counters: B * KH zeroed ints, both needed only when n_splits > 1.
extern "C" int paged_attention_launch(const void* q, const void* ak, const void* av,
                                      const void* table, const void* pos, void* out,
                                      void* ws, void* counters, int q_dtype, int kv_dtype,
                                      int B, int H, int KH, int HD, int P, int mb,
                                      long long q_sb, long long q_sh, long long t_sb,
                                      int window, float scale, int span, int n_splits,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KH <= 0 || H % KH || H / KH > GMAX || P <= 0 || mb <= 0 || span <= 0 || span % P ||
      n_splits <= 0 || (long long)span * n_splits < (long long)mb * P ||
      (long long)span * (n_splits - 1) >= (long long)mb * P ||
      (n_splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
#define PA_ARGS \
  q, ak, av, table, pos, out, ws, counters, B, H, KH, HD, P, mb, q_sb, q_sh, t_sb, window, \
      scale, span, n_splits, s
  if (q_dtype == DT_F32 && kv_dtype == DT_F32) return launch_hd<float, float>(PA_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_F32) return launch_hd<__nv_bfloat16, float>(PA_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16) return launch_hd<float, __nv_bfloat16>(PA_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

// Paged-attention decode: one query token per row over the row's page
// table into a shared KV arena [n_pages + 1, P, KH, HD].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_kernel (body _kernel).  Grid B * KH: one block per (row,
// kv head), THREADS = 128.  The block walks the row's valid columns
// [lo, min(pos, S - 1)] (lo = pos - window + 1 with a window, else 0) in
// tiles of TT = 32, loading each column's page id from the table as it
// goes: a page past the cursor, or wholly below the window, is never read,
// and each page that is read is read once for all g = H / KH query heads.
// A tile's K and V are loaded with 16-byte loads, all issued before any is
// used, and staged in fp32 in shared memory (rows padded to HD + 1 floats,
// so lanes reading one column each hit distinct banks).  Warp w scores
// heads w, w + 4, ... one lane a column and keeps their online softmax
// (m, l) in registers, merged over the tile with xor shuffles; the P V
// product keeps acc in fp32 registers, g * HD values over the block.
// Masked lanes score -1e30 and their p is re-zeroed under the mask, the
// denominator is floored at 1e-30, as in the reference.
// Bound: bytes (each needed K and V element read once; 4 g HD operations a
// column and kv head).
#include "common.cuh"

constexpr int THREADS = 128, NWARPS = THREADS / 32, TT = 32, GMAX = 16;

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

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ ak,
                       const TKV* __restrict__ av, const int* __restrict__ table,
                       const int* __restrict__ pos, TKV* __restrict__ out, int H, int KH,
                       int P, int mb, int64_t q_sb, int64_t q_sh, int64_t t_sb, int window,
                       float scale) {
  constexpr int VEC = 16 / sizeof(TKV);                    // elements a 16-byte load
  constexpr int CPR = HD / VEC;                            // loads a column
  constexpr int LOADS = (TT * CPR + THREADS - 1) / THREADS;
  constexpr int ACC = (GMAX * HD + THREADS - 1) / THREADS;
  constexpr int HPW = GMAX / NWARPS;                       // heads a warp, at most
  __shared__ float ks[TT][HD + 1];
  __shared__ float vs[TT][HD + 1];
  __shared__ float qs[GMAX][HD];
  __shared__ float ps[GMAX][TT];
  __shared__ float alpha_s[GMAX];
  __shared__ float l_s[GMAX];

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int g = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p_b = pos[b];
  const int hi = min(p_b, mb * P - 1);
  const int lo = window > 0 ? max(0, p_b - window + 1) : 0;
  const int* trow = table + b * t_sb;

  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int h = idx / HD, d = idx % HD;
    qs[h][d] = to_f32(q[b * q_sb + (int64_t)(kh * g + h) * q_sh + d]);
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) { m_run[i] = NEG_INF_F; l_run[i] = 0.0f; }

  for (int c0 = lo; c0 <= hi; c0 += TT) {
    const int n = min(TT, hi - c0 + 1);
    __syncthreads();   // the previous tile's reads of ks, vs, ps are done
    VecT<TKV, VEC> rk[LOADS], rv[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS, t = idx / CPR, c = idx % CPR;
      if (idx < TT * CPR && t < n) {
        const int col = c0 + t;
        const int64_t page = trow[col / P];
        const int64_t off = ((page * P + col % P) * KH + kh) * HD + c * VEC;
        rk[i] = *reinterpret_cast<const VecT<TKV, VEC>*>(ak + off);
        rv[i] = *reinterpret_cast<const VecT<TKV, VEC>*>(av + off);
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS, t = idx / CPR, c = idx % CPR;
      if (idx < TT * CPR) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          ks[t][c * VEC + u] = t < n ? to_f32(rk[i].v[u]) : 0.0f;
          vs[t][c * VEC + u] = t < n ? to_f32(rv[i].v[u]) : 0.0f;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = warp + i * NWARPS;
      if (h < g) {
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += qs[h][d] * ks[lane][d];
        const bool valid = lane < n;              // lo <= c0 + lane <= hi
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

#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int idx = tid + i * THREADS, h = idx / HD, d = idx % HD;
      if (h < g) {
        float a = acc[i] * alpha_s[h];
#pragma unroll 8
        for (int t = 0; t < TT; ++t) a += ps[h][t] * vs[t][d];
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = warp + i * NWARPS;
    if (h < g && lane == 0) l_s[h] = l_run[i];
  }
  __syncthreads();
  TKV* ob = out + ((int64_t)b * H + kh * g) * HD;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * THREADS, h = idx / HD, d = idx % HD;
    if (h < g) ob[h * HD + d] = from_f32<TKV>(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD>
static cudaError_t launch(const void* q, const void* ak, const void* av, const void* table,
                          const void* pos, void* out, int B, int H, int KH, int P, int mb,
                          long long q_sb, long long q_sh, long long t_sb, int window,
                          float scale, cudaStream_t stream) {
  paged_attention_kernel<TQ, TKV, HD><<<(unsigned)(B * KH), THREADS, 0, stream>>>(
      (const TQ*)q, (const TKV*)ak, (const TKV*)av, (const int*)table, (const int*)pos,
      (TKV*)out, H, KH, P, mb, q_sb, q_sh, t_sb, window, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
static cudaError_t launch_hd(const void* q, const void* ak, const void* av, const void* table,
                             const void* pos, void* out, int B, int H, int KH, int HD, int P,
                             int mb, long long q_sb, long long q_sh, long long t_sb,
                             int window, float scale, cudaStream_t s) {
  switch (HD) {
    case 16: return launch<TQ, TKV, 16>(q, ak, av, table, pos, out, B, H, KH, P, mb, q_sb,
                                        q_sh, t_sb, window, scale, s);
    case 32: return launch<TQ, TKV, 32>(q, ak, av, table, pos, out, B, H, KH, P, mb, q_sb,
                                        q_sh, t_sb, window, scale, s);
    case 64: return launch<TQ, TKV, 64>(q, ak, av, table, pos, out, B, H, KH, P, mb, q_sb,
                                        q_sh, t_sb, window, scale, s);
    case 128: return launch<TQ, TKV, 128>(q, ak, av, table, pos, out, B, H, KH, P, mb, q_sb,
                                          q_sh, t_sb, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int paged_attention_launch(const void* q, const void* ak, const void* av,
                                      const void* table, const void* pos, void* out,
                                      int q_dtype, int kv_dtype, int B, int H, int KH, int HD,
                                      int P, int mb, long long q_sb, long long q_sh,
                                      long long t_sb, int window, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KH <= 0 || H % KH || H / KH > GMAX || P <= 0 || mb <= 0) return cudaErrorInvalidValue;
#define PA_ARGS q, ak, av, table, pos, out, B, H, KH, HD, P, mb, q_sb, q_sh, t_sb, window, scale, s
  if (q_dtype == DT_F32 && kv_dtype == DT_F32) return launch_hd<float, float>(PA_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_F32) return launch_hd<__nv_bfloat16, float>(PA_ARGS);
  if (q_dtype == DT_F32 && kv_dtype == DT_BF16) return launch_hd<float, __nv_bfloat16>(PA_ARGS);
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

// Float x [M, K] times int8 w [K, N] times a per-column scale [N], fp32 out.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (body
// _kernel).  Accumulators are fp32 over all of K; the scale is applied
// once, after the last K tile, as the TPU kernel does.  Ragged M, N and K
// are masked here with zero-filled tiles and a masked store (the TPU
// version pads instead); rows that are not 16-byte aligned are copied
// element by element.  Int8 widens to bf16 exactly (|q| <= 127), so every
// tensor-core product is exact and only the order of the fp32 sum differs
// from the plain version.  Three kernels:
//
// bf16 x, M > 16 (prefill): bound by operations (962 GFLOP at w_gate and
// M 8192, about 1 ms at the bf16 tensor rate).  A 128 x 128 block tile,
// two consumer warpgroups each issuing wgmma m64n128k16.  x and the raw
// weight bytes come by cp.async through a three-stage ring; each weight
// K tile is widened ONCE a block into a bf16 tile laid out as wgmma's
// MN-major B (no swizzle), double-buffered, so the widening of tile k + 1
// overlaps the wgmma of tile k.  x reaches wgmma from registers
// (ldmatrix).  The bytes are widened by the fp32 magic-number trick
// (prmt, one add, prmt): no int-to-float conversion unit.
//
// x at M <= 16 (decode), bf16 or fp32: bound by the weight bytes (58.7 MB
// at w_gate [4096, 14336]).  mma.sync m16n8k16 over a 16-row tile, a
// four-stage ring of 64 x 128 weight bytes, and split-K over the blocks
// so that enough of them, and enough bytes, are in flight to fill the
// card; the last block of a column tile to finish (an atomic counter)
// sums the splits' fp32 partials in split order and applies the scale.
// A warp owns 32 columns as four m16n8 tiles whose column c of tile j is
// column 4c + j, so one 32-bit shared load of a weight row feeds all four.
// fp32 x is split exactly into three bf16 parts, x = hi + mid + lo (8
// bits each of the 24), so the fp32-x product runs on the tensor cores at
// three times the bf16 work with every product exact; TF32 would round x.
//
// fp32 x, M > 16: the fp32 cores, a [64, 128] tile; no model path or
// timed shape uses it.
#include "mma.cuh"

constexpr int W_PAD = 16;     // bytes: weight-byte rows 144 bytes apart
constexpr int X_PAD = 16;     // bytes likewise for an x tile row

// A [ROWS, COLS] tile of E from g (row stride ldg elements) into s (row
// stride LDS elements): 16-byte cp.async chunks where `vec` and the chunk
// lies wholly inside [rows_left, cols_left), element copies at the edge,
// zeros outside.
template <typename E, int ROWS, int COLS, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile(E* s, const E* g, int64_t ldg, int rows_left,
                                          int cols_left, bool vec) {
  constexpr int EPC = 16 / sizeof(E), CPR = COLS / EPC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    E* dst = s + r * LDS + c;
    const E* src = g + (int64_t)r * ldg + c;
    if (vec && r < rows_left && c + EPC <= cols_left) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        dst[e] = (r < rows_left && c + e < cols_left) ? src[e] : E(0);
    }
  }
}

// int8 byte j of u (already xor 0x80, so the byte is q + 128) as an exact
// fp32: 0x4B0000uu is 2^23 + u
__device__ __forceinline__ float i8_to_f32(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) - 8388736.0f;
}
// the upper halves of two fp32 values that are exact in bf16, as a bf16
// pair (a in the low half)
__device__ __forceinline__ uint32_t hi_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// ---------------------------------------------------- prefill: wgmma ---
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 3, WG_THREADS = 256;
constexpr int WG_XLD = WG_BK + X_PAD / 2;                    // bf16 elements
constexpr int WG_X_STAGE = WG_BM * WG_XLD * 2;               // bytes
constexpr int WG_W_STAGE = WG_BK * WG_BN;                    // bytes, swizzled
constexpr int WG_B_TILE = WG_BK * WG_BN * 2;                 // bytes, bf16
constexpr int WG_SMEM = WG_STAGES * (WG_X_STAGE + WG_W_STAGE) + 2 * WG_B_TILE;
constexpr uint32_t WG_KGROUP = WG_BN * 16;                   // bytes between 8-k groups
constexpr int WG_WCH = WG_BN / 16;                           // 16-byte chunks a row

// The raw weight tile [WG_BK, WG_BN] bytes: row k's 16-byte chunk c at
// k * WG_BN + (c ^ (k % 8)) * 16, so the widening's reads (eight rows, one
// chunk each) and the copies (one row, eight chunks) are conflict-free.
__device__ __forceinline__ void load_w_swizzled(int8_t* s, const int8_t* g, int64_t ldw,
                                                int rows_left, int cols_left, bool vec) {
  for (int i = threadIdx.x; i < WG_BK * WG_WCH; i += WG_THREADS) {
    const int r = i / WG_WCH, c = i % WG_WCH;
    int8_t* dst = s + r * WG_BN + ((c ^ (r & 7)) << 4);
    const int8_t* src = g + (int64_t)r * ldw + c * 16;
    if (vec && r < rows_left && c * 16 + 16 <= cols_left) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (r < rows_left && c * 16 + e < cols_left) ? src[e] : int8_t(0);
    }
  }
}

// Widen the byte tile into bf16 wgmma core matrices: (k, n) at byte
// (k / 8) * WG_KGROUP + (n / 8) * 128 + (k % 8) * 16 + (n % 8) * 2 -- the
// MN-major B of mma.cuh (LBO WG_KGROUP along K, SBO 128 along N).  Eight
// consecutive threads take rows k .. k + 7 of one 16-byte chunk.
__device__ __forceinline__ void widen_tile(unsigned char* b, const int8_t* w) {
  for (int i = threadIdx.x; i < WG_BK * WG_WCH; i += WG_THREADS) {
    const int k = (i & 7) + i / (8 * WG_WCH) * 8, c = (i >> 3) % WG_WCH;
    const uint4 raw = *reinterpret_cast<const uint4*>(w + k * WG_BN + ((c ^ (k & 7)) << 4));
    const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                               raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = hi_halves(i8_to_f32(words[j], 0), i8_to_f32(words[j], 1));
      o[2 * j + 1] = hi_halves(i8_to_f32(words[j], 2), i8_to_f32(words[j], 3));
    }
    unsigned char* dst = b + (k >> 3) * WG_KGROUP + (2 * c) * 128 + (k & 7) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + 128) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 2)
int8_matmul_wgmma_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scale, float* __restrict__ out, int M,
                         int N, int K, int64_t ldx, int64_t ldw, int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  int8_t* wq = reinterpret_cast<int8_t*>(smem + WG_STAGES * WG_X_STAGE);
  unsigned char* wb = smem + WG_STAGES * (WG_X_STAGE + WG_W_STAGE);

  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (nk == 0) {   // K = 0: the sum is empty
    for (int i = threadIdx.x; i < WG_BM * WG_BN; i += WG_THREADS) {
      const int row = m0 + i / WG_BN, col = n0 + i % WG_BN;
      if (row < M && col < N) out[(int64_t)row * N + col] = 0.0f;
    }
    return;
  }
  // no zeroing: the first k-step overwrites (a write by another
  // instruction inside the wgmma pipeline would serialize it)
  float acc[WG_BN / 2];

  auto load = [&](int stage, int kt) {
    const int k0 = kt * WG_BK;
    load_tile<uint16_t, WG_BM, WG_BK, WG_XLD, WG_THREADS>(
        xs + stage * (WG_X_STAGE / 2), x + (int64_t)m0 * ldx + k0, ldx, M - m0, K - k0, x_vec);
    load_w_swizzled(wq + stage * WG_W_STAGE, w + (int64_t)k0 * ldw + n0, ldw, K - k0, N - n0,
                    w_vec);
  };
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed; every warpgroup has waited for its wgmma of
    // tile kt - 2, which read the bf16 buffer widened below
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    if (kt + WG_STAGES - 1 < nk) load((kt + WG_STAGES - 1) % WG_STAGES, kt + WG_STAGES - 1);
    cp_async_commit();
    unsigned char* bt = wb + (kt & 1) * WG_B_TILE;
    widen_tile(bt, wq + (kt % WG_STAGES) * WG_W_STAGE);   // overlaps wgmma kt - 1
    fence_proxy_async();
    __syncthreads();
    wgmma_wait<0>();   // tile kt - 1's wgmma done: its A registers are free

    const uint16_t* xt = xs + (kt % WG_STAGES) * (WG_X_STAGE / 2) +
                         (wg * 64 + warp * 16 + (lane & 15)) * WG_XLD + (lane >> 4) * 8;
    uint32_t a[WG_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) ldmatrix_x4(a[kk], xt + kk * 16);
#pragma unroll
    for (int e = 0; e < WG_BN / 2; ++e) fence_operand(acc[e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      Wgmma<WG_BN>::template rs<1>(acc, a[kk], wgmma_desc(bt + kk * 2 * WG_KGROUP, WG_KGROUP, 128),
                                   kt > 0 || kk > 0);
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < WG_BN / 2; ++e) fence_operand(acc[e]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < WG_BN / 2; ++e) fence_operand(acc[e]);
  cp_async_wait<0>();

  const bool pair = (N & 1) == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
    const float s0 = scale[col];
    const float s1 = col + 1 < N ? scale[col + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= M) continue;
      float* op = out + (int64_t)row * N + col;
      const float v0 = acc[4 * j + 2 * h] * s0, v1 = acc[4 * j + 2 * h + 1] * s1;
      if (pair) {
        *reinterpret_cast<float2*>(op) = make_float2(v0, v1);
      } else {
        op[0] = v0;
        if (col + 1 < N) op[1] = v1;
      }
    }
  }
}

// ------------------------------------------ decode: M <= 16, split-K ---
constexpr int GV_BN = 128, GV_BK = 64, GV_STAGES = 4, GV_THREADS = 128;
static_assert(GV_THREADS == GV_BN, "the split-K sum takes one column a thread");
constexpr int GV_WLD = GV_BN + W_PAD;             // bytes
constexpr int GV_W_STAGE = GV_BK * GV_WLD;

template <typename TX>
struct Gemv {
  static constexpr int XLD = GV_BK + X_PAD / 2;   // elements: 144- or 288-byte rows
  static constexpr int X_STAGE = 16 * XLD * (int)sizeof(TX);
  static constexpr int SMEM = GV_STAGES * (X_STAGE + GV_W_STAGE);
};

// fp32 x as three bf16 parts hi + mid + lo == x (8 bits each of 24)
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v.x), h1 = __float2bfloat16_rn(v.y);
  const float r0 = v.x - __bfloat162float(h0), r1 = v.y - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  hi = __bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  mid = __bfloat16_as_ushort(m0) | ((uint32_t)__bfloat16_as_ushort(m1) << 16);
  lo = pack_bf16(r0 - __bfloat162float(m0), r1 - __bfloat162float(m1));
}

// Eight consecutive fp32 values at p, the first n of them in range;
// float4 stores when `vec` (the row and column are 16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float* v, int n, bool vec) {
  if (vec && n >= 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) p[e] = v[e];
  }
}

template <typename TX>
__global__ void __launch_bounds__(GV_THREADS)
int8_matmul_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, float* __restrict__ out,
                        float* __restrict__ partial, int* __restrict__ counters, int M, int N,
                        int K, int64_t ldx, int64_t ldw, int x_vec, int w_vec, int per_split) {
  using C = Gemv<TX>;
  constexpr bool F32 = sizeof(TX) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* xs = reinterpret_cast<TX*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + GV_STAGES * C::X_STAGE);

  const int n0 = blockIdx.x * GV_BN, split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk_all = (K + GV_BK - 1) / GV_BK;
  const int kt0 = split * per_split, nk = max(0, min(nk_all - kt0, per_split));

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  auto load = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * GV_BK;
    load_tile<TX, 16, GV_BK, C::XLD, GV_THREADS>(xs + stage * (C::X_STAGE / sizeof(TX)),
                                                 x + k0, ldx, M, K - k0, x_vec);
    load_tile<int8_t, GV_BK, GV_BN, GV_WLD, GV_THREADS>(
        ws + stage * GV_W_STAGE, w + (int64_t)k0 * ldw + n0, ldw, K - k0, N - n0, w_vec);
  };
#pragma unroll
  for (int s = 0; s < GV_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GV_STAGES - 2>();
    __syncthreads();
    if (kt + GV_STAGES - 1 < nk) load((kt + GV_STAGES - 1) % GV_STAGES, kt + GV_STAGES - 1);
    cp_async_commit();

    const TX* xt = xs + (kt % GV_STAGES) * (C::X_STAGE / sizeof(TX));
    const int8_t* wt = ws + (kt % GV_STAGES) * GV_W_STAGE + warp * 32 + 4 * g;
#pragma unroll
    for (int kk = 0; kk < GV_BK / 16; ++kk) {
      // A: rows g, g + 8; k 2t, 2t + 1, 2t + 8, 2t + 9 of this k-step
      uint32_t a[3][4];
      if constexpr (F32) {
        const float* xr = reinterpret_cast<const float*>(xt) + g * C::XLD + kk * 16 + 2 * t;
        const float2 v[4] = {*reinterpret_cast<const float2*>(xr),
                             *reinterpret_cast<const float2*>(xr + 8 * C::XLD),
                             *reinterpret_cast<const float2*>(xr + 8),
                             *reinterpret_cast<const float2*>(xr + 8 * C::XLD + 8)};
#pragma unroll
        for (int r = 0; r < 4; ++r) split3(v[r], a[0][r], a[1][r], a[2][r]);
      } else {
        ldmatrix_x4(a[0], reinterpret_cast<const uint16_t*>(xt) + (lane & 15) * C::XLD +
                              kk * 16 + (lane >> 4) * 8);
      }
      // B: one word of each of the four k rows holds this thread's column
      // of all four n8 tiles
      const int8_t* wr = wt + (kk * 16 + 2 * t) * GV_WLD;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wr) ^ 0x80808080u;
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wr + GV_WLD) ^ 0x80808080u;
      const uint32_t r8 = *reinterpret_cast<const uint32_t*>(wr + 8 * GV_WLD) ^ 0x80808080u;
      const uint32_t r9 = *reinterpret_cast<const uint32_t*>(wr + 9 * GV_WLD) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = hi_halves(i8_to_f32(r0, j), i8_to_f32(r1, j));
        const uint32_t b1 = hi_halves(i8_to_f32(r8, j), i8_to_f32(r9, j));
        mma_bf16(acc[j], a[0], b0, b1);
        if constexpr (F32) {
          mma_bf16(acc[j], a[1], b0, b1);
          mma_bf16(acc[j], a[2], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this thread's columns: n0 + warp * 32 + 8t + e, e = 0 .. 7 (tile j
  // gives e = j and e = 4 + j); rows g and g + 8
  const int col0 = n0 + warp * 32 + 8 * t;
  const int n_in = min(8, N - col0);
  const bool vec = (N & 3) == 0;
  float v[2][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[0][j] = acc[j][0];
    v[0][4 + j] = acc[j][1];
    v[1][j] = acc[j][2];
    v[1][4 + j] = acc[j][3];
  }
  if (splits == 1) {
    if (n_in > 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[h][e] *= e < n_in ? scale[col0 + e] : 0.0f;
        store8(out + (int64_t)row * N + col0, v[h], n_in, vec);
      }
    return;
  }

  // split-K: write this split's partial, then the last block of the
  // column tile sums them in split order
  if (n_in > 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (row < M) store8(partial + ((int64_t)split * M + row) * N + col0, v[h], n_in, vec);
    }
  if (!last_to_arrive(&counters[blockIdx.x], splits)) return;
  // one column a thread, its rows' loads of two splits in flight at once
  const int col = n0 + threadIdx.x;
  if (col >= N) return;
  float sum[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) sum[m] = 0.0f;
#pragma unroll 2
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = partial + (int64_t)sp * M * N + col;
#pragma unroll
    for (int m = 0; m < 16; ++m)
      if (m < M) sum[m] += __ldcg(p + (int64_t)m * N);
  }
  const float sc = scale[col];
#pragma unroll
  for (int m = 0; m < 16; ++m)
    if (m < M) out[(int64_t)m * N + col] = sum[m] * sc;
}

// ------------------------------------- fp32 x, M > 16: the fp32 cores ---
// a [64, 128] tile, each thread 4 rows by 8 adjacent columns, the 8 weight
// bytes of a k read as one 8-byte word
constexpr int THREADS = 256, STAGES = 3;
constexpr int FBM = 64, FBN = 128, FBK = 32;
constexpr int F_XLD = FBK + 4;                 // floats: 144-byte rows
constexpr int F_WLD = FBN + W_PAD;             // bytes
constexpr int F_X_STAGE = FBM * F_XLD * 4, F_W_STAGE = FBK * F_WLD;
constexpr int F_SMEM = STAGES * (F_X_STAGE + F_W_STAGE);

__global__ void __launch_bounds__(THREADS)
int8_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ out, int M,
                       int N, int K, int64_t ldx, int64_t ldw, int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + STAGES * F_X_STAGE);

  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nk = (K + FBK - 1) / FBK;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * FBK;
    load_tile<float, FBM, FBK, F_XLD, THREADS>(xs + stage * (F_X_STAGE / 4),
                                               x + (int64_t)m0 * ldx + k0, ldx, M - m0,
                                               K - k0, x_vec);
    load_tile<int8_t, FBK, FBN, F_WLD, THREADS>(ws + stage * F_W_STAGE,
                                                w + (int64_t)k0 * ldw + n0, ldw, K - k0,
                                                N - n0, w_vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const float* xt = xs + (kt % STAGES) * (F_X_STAGE / 4);
    const int8_t* wt = ws + (kt % STAGES) * F_W_STAGE;
#pragma unroll 4
    for (int k = 0; k < FBK; ++k) {
      const uint2 packed = *reinterpret_cast<const uint2*>(wt + k * F_WLD + tx * 8);
      const int8_t* wb = reinterpret_cast<const int8_t*>(&packed);
      float wf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wf[j] = (float)wb[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xt[(ty * 4 + i) * F_XLD + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 8 + j;
      if (col < N) out[(int64_t)row * N + col] = acc[i][j] * scale[col];
    }
  }
}

// ---------------------------------------------------------- launches ---
template <typename TX>
static cudaError_t gemv_attr() {
  static unsigned long long done = 0;
  return set_smem_once(int8_matmul_gemv_kernel<TX>, Gemv<TX>::SMEM, done);
}

template <typename TX>
static cudaError_t launch_gemv(const void* x, const void* w, const void* scale, void* out,
                               void* partial, void* counters, int M, int N, int K,
                               long long ldx, long long ldw, int x_vec, int w_vec, int splits,
                               cudaStream_t stream) {
  cudaError_t err = gemv_attr<TX>();
  if (err != cudaSuccess) return err;
  const int nk = (K + GV_BK - 1) / GV_BK;
  const int per = splits > 1 ? (nk + splits - 1) / splits : max(nk, 1);
  if (splits < 1 || (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (long long)per * (splits - 1) >= (long long)max(nk, 1))
    return cudaErrorInvalidValue;   // every split must own at least one K tile
  dim3 grid((unsigned)((N + GV_BN - 1) / GV_BN), (unsigned)splits);
  int8_matmul_gemv_kernel<TX><<<grid, GV_THREADS, Gemv<TX>::SMEM, stream>>>(
      (const TX*)x, (const int8_t*)w, (const float*)scale, (float*)out, (float*)partial,
      (int*)counters, M, N, K, ldx, ldw, x_vec, w_vec, per);
  return cudaGetLastError();
}

// The blocks of the decode kernel that fit on the card at once: its
// streaming multiprocessors times the blocks each holds.  The wrapper
// plans split-K from it.
extern "C" int int8_matmul_gemv_slots(int dtype, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dtype == DT_BF16) {
    err = gemv_attr<uint16_t>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int8_matmul_gemv_kernel<uint16_t>, GV_THREADS, Gemv<uint16_t>::SMEM);
  } else if (dtype == DT_F32) {
    err = gemv_attr<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int8_matmul_gemv_kernel<float>, GV_THREADS, Gemv<float>::SMEM);
  } else {
    return cudaErrorInvalidValue;
  }
  *slots = sms * per_sm;
  return err;
}

// x_vec / w_vec: the caller found the base pointer 16-byte aligned and the
// row stride a whole number of 16-byte chunks, so interior chunks may be
// copied by cp.async.  At M <= 16, `splits` blocks share each column tile's
// K (the wrapper's plan); `partial` holds splits x M x N fp32 and
// `counters` one zeroed int a column tile, which the kernel leaves zeroed.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* scale, void* out,
                                  void* partial, void* counters, int dtype, int M, int N,
                                  int K, long long ldx, long long ldw, int x_vec, int w_vec,
                                  int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (dtype != DT_BF16 && dtype != DT_F32) return cudaErrorInvalidValue;
  if (M <= 16) {
    if (dtype == DT_BF16)
      return launch_gemv<uint16_t>(x, w, scale, out, partial, counters, M, N, K, ldx, ldw,
                                   x_vec, w_vec, splits, s);
    return launch_gemv<float>(x, w, scale, out, partial, counters, M, N, K, ldx, ldw, x_vec,
                              w_vec, splits, s);
  }
  if (dtype == DT_BF16) {
    static unsigned long long done = 0;
    cudaError_t err = set_smem_once(int8_matmul_wgmma_kernel, WG_SMEM, done);
    if (err != cudaSuccess) return err;
    dim3 grid((unsigned)((N + WG_BN - 1) / WG_BN), (unsigned)((M + WG_BM - 1) / WG_BM));
    int8_matmul_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(
        (const uint16_t*)x, (const int8_t*)w, (const float*)scale, (float*)out, M, N, K, ldx,
        ldw, x_vec, w_vec);
    return cudaGetLastError();
  }
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(int8_matmul_f32_kernel, F_SMEM, done);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + FBN - 1) / FBN), (unsigned)((M + FBM - 1) / FBM));
  int8_matmul_f32_kernel<<<grid, THREADS, F_SMEM, s>>>(
      (const float*)x, (const int8_t*)w, (const float*)scale, (float*)out, M, N, K, ldx, ldw,
      x_vec, w_vec);
  return cudaGetLastError();
}

// Float x [M, K] times int8 w [K, N] times a per-column scale [N], fp32 out.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (body
// _kernel).  Each block owns one [BM, BN] output tile and walks K in tiles
// of BK, staged in shared memory by a STAGES-deep cp.async ring, so the
// next tiles load while this one computes.  The int8 weights stay bytes
// in shared memory (copied 16 at a time where the row is 16-byte aligned,
// byte by byte at a ragged or unaligned edge) and are converted at use.
// Accumulators are fp32; the scale is applied once, after the last K
// tile, as the TPU kernel does.  Ragged M, N and K are masked here with
// zero-filled tiles and a masked store (the TPU version pads instead).
//
// bf16 x runs on the tensor cores: mma.sync m16n8k16 bf16 with fp32
// accumulators; x fragments come from shared memory by ldmatrix, and each
// weight byte becomes a bf16 in registers (exact for |q| <= 127), so every
// product is exact and only the order of the fp32 sum differs from the
// plain version.  fp32 x stays on the fp32 cores: TF32 would round x.
//
// Bound: at decode M (16 rows) the int8 weight bytes (58.7 MB at
// w_gate [4096, 14336]) bound it; at prefill M (8192) the operations do
// (962 GFLOP, about 1 ms at the bf16 tensor rate).  Decode uses a 16-row
// tile so no tensor work is spent on absent rows.
#include "mma.cuh"

constexpr int THREADS = 256, BK = 64, STAGES = 3;
constexpr int W_PAD = 16;     // bytes: rows 144 bytes apart, conflict-free
constexpr int X_PAD = 16;     // bytes likewise for the x tile

// A [ROWS, COLS] tile of E from g (row stride ldg elements) into s (row
// stride LDS elements): 16-byte cp.async chunks where `vec` and the chunk
// lies wholly inside [rows_left, cols_left), element copies at the edge,
// zeros outside.
template <typename E, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(E* s, const E* g, int64_t ldg, int rows_left,
                                          int cols_left, bool vec) {
  constexpr int EPC = 16 / sizeof(E), CPR = COLS / EPC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
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

// ---- bf16 x on the tensor cores.  8 warps as WM x WN; a warp owns MT
// m16 tiles by NT n8 tiles.
template <int WM, int WN, int MT, int NT>
struct MmaCfg {
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int XLD = BK + X_PAD / 2;     // bf16 elements
  static constexpr int WLD = BN + W_PAD;         // bytes
  static constexpr int X_STAGE = BM * XLD * 2, W_STAGE = BK * WLD;
  static constexpr int SMEM = STAGES * (X_STAGE + W_STAGE);
};

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_mma_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ out, int M,
                       int N, int K, int64_t ldx, int64_t ldw, int x_vec, int w_vec) {
  using C = MmaCfg<WM, WN, MT, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + STAGES * C::X_STAGE);

  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + BK - 1) / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    load_tile<uint16_t, C::BM, BK, C::XLD>(xs + stage * (C::X_STAGE / 2),
                                           x + (int64_t)m0 * ldx + k0, ldx, M - m0,
                                           K - k0, x_vec);
    load_tile<int8_t, BK, C::BN, C::WLD>(ws + stage * C::W_STAGE,
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

    const uint16_t* xt = xs + (kt % STAGES) * (C::X_STAGE / 2);
    const int8_t* wt = ws + (kt % STAGES) * C::W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xt + (wm * MT * 16 + i * 16 + (lane & 15)) * C::XLD + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* wc = wt + (kk * 16 + 2 * t) * C::WLD + (wn * NT + j) * 8 + g;
        const uint32_t b0 = pack_bf16((float)wc[0], (float)wc[C::WLD]);
        const uint32_t b1 = pack_bf16((float)wc[8 * C::WLD], (float)wc[9 * C::WLD]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + (wn * NT + j) * 8 + 2 * t;
    const float s0 = col < N ? scale[col] : 0.0f;
    const float s1 = col + 1 < N ? scale[col + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float* op = out + (int64_t)row * N + col;
        if (col < N) op[0] = acc[i][j][2 * h] * s0;
        if (col + 1 < N) op[1] = acc[i][j][2 * h + 1] * s1;
      }
  }
}

// ---- fp32 x on the fp32 cores: a [64, 128] tile, each thread 4 rows by
// 8 adjacent columns, the 8 weight bytes of a k read as one 8-byte word.
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
    load_tile<float, FBM, FBK, F_XLD>(xs + stage * (F_X_STAGE / 4),
                                      x + (int64_t)m0 * ldx + k0, ldx, M - m0, K - k0,
                                      x_vec);
    load_tile<int8_t, FBK, FBN, F_WLD>(ws + stage * F_W_STAGE, w + (int64_t)k0 * ldw + n0,
                                       ldw, K - k0, N - n0, w_vec);
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

template <int WM, int WN, int MT, int NT>
static cudaError_t launch_mma(const void* x, const void* w, const void* scale, void* out,
                             int M, int N, int K, long long ldx, long long ldw, int x_vec,
                             int w_vec, cudaStream_t stream) {
  using C = MmaCfg<WM, WN, MT, NT>;
  auto kernel = int8_matmul_mma_kernel<WM, WN, MT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + C::BN - 1) / C::BN), (unsigned)((M + C::BM - 1) / C::BM));
  kernel<<<grid, THREADS, C::SMEM, stream>>>((const uint16_t*)x, (const int8_t*)w,
                                             (const float*)scale, (float*)out, M, N, K, ldx,
                                             ldw, x_vec, w_vec);
  return cudaGetLastError();
}

// x_vec / w_vec: the caller found the base pointer 16-byte aligned and the
// row stride a whole number of 16-byte chunks, so interior chunks may be
// copied by cp.async.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* scale, void* out,
                                  int dtype, int M, int N, int K, long long ldx,
                                  long long ldw, int x_vec, int w_vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    if (M <= 16) return launch_mma<1, 8, 1, 1>(x, w, scale, out, M, N, K, ldx, ldw, x_vec,
                                              w_vec, s);
    return launch_mma<2, 4, 4, 4>(x, w, scale, out, M, N, K, ldx, ldw, x_vec, w_vec, s);
  }
  if (dtype == DT_F32) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid((unsigned)((N + FBN - 1) / FBN), (unsigned)((M + FBM - 1) / FBM));
    int8_matmul_f32_kernel<<<grid, THREADS, F_SMEM, s>>>(
        (const float*)x, (const int8_t*)w, (const float*)scale, (float*)out, M, N, K, ldx,
        ldw, x_vec, w_vec);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

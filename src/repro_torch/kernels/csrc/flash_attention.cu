// Causal GQA flash attention, forward.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel).  Grid (B*H, query blocks), heaviest query blocks first.
// Tensors are read through their [B, S, H, hd] strides; kv head h / (H/K);
// a ragged S is masked here (the reference pads instead).  Online softmax
// (m, l, acc) in fp32, masked scores -1e30, the denominator floored at
// 1e-30, the output cast to q's dtype, as in the reference.  At
// [4, 2048, 32, 8, 128] the work is 137 GFLOP against 0.27 GB of q, k, v
// and o: bound by operations (0.139 ms at the bf16 tensor rate).
//
// bf16 (flash_fwd_wgmma_kernel): FlashAttention-2's walk on Hopper's
// warpgroup products.  A block is NWG = 3 warpgroups of 64 query rows
// each (192 rows; 2 and 128 at hd 192, see FlashWg; zamba2's hd 112 keeps
// three, with m64n112k16 for P V), which share every
// K and V tile: a tile read from L2
// serves three times the rows it would serve one warpgroup alone, and
// the K/V bytes re-read from L2, not the tensor instruction, set the
// time at the main shape (the same walk on mma.sync, or with one
// warpgroup a block, takes longer).  64-key tiles of K and V go into
// shared memory by cp.async, double-buffered with one barrier a tile, as
// 8 x 16-byte core matrices that wgmma reads by descriptor.  S = q k^T
// is wgmma m64n64k16 with q in registers for the whole walk; the online
// softmax runs in registers (a row lives in the four lanes of a quad: max
// and sum by two xor shuffles), in base 2 with the scale folded into
// log2(e); P is rounded to bf16 in registers and is the A operand of
// acc += P V, wgmma m64nHDk16 with V read transposed (MN-major).  Only a
// warpgroup's diagonal tile (its last) is masked: it holds the causal
// edge and the ragged end of S; tiles above the diagonal are not visited.
//
// fp32 (flash_fwd_kernel): the first, SIMT design on the fp32 cores.  On
// the tensor cores fp32 would mean TF32, which rounds q and k to 10
// mantissa bits, and the fp32 checks hold 1e-5 and 1e-4.
#include "mma.cuh"

// ---- fp32, SIMT.  A block holds BQ = 64 query rows, TPR = 4 threads to a
// row; thread `part` of a row owns the head dims {c*16 + part*4 + e}, so
// its q slice and output accumulator live in registers and its
// shared-memory reads are float4 without bank conflicts.  The block walks
// BK = 32-key tiles of K and V (in fp32 in dynamic shared memory, 28 KB at
// hd = 112, 32 KB at hd = 128, 48 KB at hd = 192, the most a block may
// take without opting in) up to the diagonal; each row's score is the four partial dots
// merged by two xor shuffles.
constexpr int BQ = 64, BK = 32, TPR = 4, THREADS = BQ * TPR;

// Two blocks to an SM up to hd = 128: the bound caps registers at 128 a
// thread, and at hd = 128 ptxas then spills 176 bytes a thread to local
// memory (the build log's ptxas -v lines say so).  At hd = 192 a thread's
// q slice, accumulator and 32 scores alone take 128 registers, so that
// instance runs one block an SM under a 255-register cap instead of
// spilling.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD > 128 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int KH,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                 int64_t o_ss, int64_t o_sh, float scale) {
  constexpr int DPT = HD / TPR;       // head dims per thread
  constexpr int NC = HD / 16;         // float4 chunks per thread
  extern __shared__ __align__(16) float f32_smem[];
  float(*ks)[HD] = reinterpret_cast<float(*)[HD]>(f32_smem);
  float(*vs)[HD] = reinterpret_cast<float(*)[HD]>(f32_smem + BK * HD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, part = tid % TPR;
  const int qi = q0 + tid / TPR;

  float qr[DPT], acc[DPT];
  const T* qp = q + b * q_sb + (int64_t)qi * q_ss + h * q_sh;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c * 4 + e] = qi < S ? to_f32(qp[c * 16 + part * 4 + e]) : 0.0f;
      acc[c * 4 + e] = 0.0f;
    }
  float m = NEG_INF_F, l = 0.0f;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int kend = min(S, q0 + BQ);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD, key = k0 + j;
      ks[j][d] = key < S ? to_f32(kb[(int64_t)key * k_ss + d]) : 0.0f;
      vs[j][d] = key < S ? to_f32(vb[(int64_t)key * v_ss + d]) : 0.0f;
    }
    __syncthreads();

    float sc[BK];
    float mt = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][c * 16 + part * 4]);
        dot += qr[c * 4 + 0] * kk.x + qr[c * 4 + 1] * kk.y + qr[c * 4 + 2] * kk.z +
               qr[c * 4 + 3] * kk.w;
      }
      dot += __shfl_xor_sync(FULL_MASK, dot, 1);
      dot += __shfl_xor_sync(FULL_MASK, dot, 2);
      const int key = k0 + j;
      sc[j] = (key <= qi && key < S) ? dot * scale : NEG_INF_F;
      mt = fmaxf(mt, sc[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][c * 16 + part * 4]);
        acc[c * 4 + 0] += sc[j] * vv.x;
        acc[c * 4 + 1] += sc[j] * vv.y;
        acc[c * 4 + 2] += sc[j] * vv.z;
        acc[c * 4 + 3] += sc[j] * vv.w;
      }
    m = m_new;
  }

  if (qi < S) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + b * o_sb + (int64_t)qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) op[c * 16 + part * 4 + e] = from_f32<T>(acc[c * 4 + e] / den);
  }
}

// ---- bf16, wgmma.  MK keys a tile; a warpgroup owns 64 query rows.
constexpr int MK = 64;
constexpr float LOG2E = 1.4426950408889634f;

// the bf16 pair at p[0], p[1] (zeros past S)
__device__ __forceinline__ uint32_t load_pair(const uint16_t* p, bool inside, bool vec) {
  if (!inside) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

__device__ __forceinline__ void store_pair(uint16_t* p, float lo, float hi, bool vec) {
  const uint32_t v = pack_bf16(lo, hi);
  if (vec) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    p[0] = (uint16_t)(v & 0xffffu);
    p[1] = (uint16_t)(v >> 16);
  }
}

// K and V tiles live in shared memory as core matrices: key n, dim k at
// byte (n / 8) * HD * 16 + (k / 8) * 128 + (n % 8) * 16 + (k % 8) * 2, so
// for q k^T K is a K-major B (8-key groups HD * 16 bytes apart along N,
// 8-dim groups 128 bytes apart along K) and for P V the same bytes are an
// MN-major B (8-dim groups 128 apart along N, 8-key groups HD * 16 apart
// along K).
//
// NWG warpgroups a block.  Three up to hd = 128: 384 threads, so the
// bound caps a thread at 168 registers.  At hd = 192 a thread holds q's
// fragments (48 registers), the P V accumulator (96) and a tile's scores
// (32), 176 before any address, so that instance runs two warpgroups (256
// threads, a 255-register cap) and shares each K/V tile over 128 rows
// instead of 192.
template <int HD>
struct FlashWg {
  static constexpr int NWG = HD > 128 ? 2 : 3;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BQ = 64 * NWG;             // query rows a block
  static constexpr int TILE = MK * HD;            // bf16 a tile
  static constexpr int SMEM = 2 * 2 * TILE * 2;   // K and V, two buffers; bytes
  static constexpr uint32_t GROUP = HD * 16;      // bytes between 8-key groups
};

// keys key0 .. key0 + 63 of K or V into a tile; rows past `valid` (the
// ragged end of S) are zeros, so 0 * garbage never reaches P V
template <int HD>
__device__ __forceinline__ void load_kv_core(uint16_t* s, const uint16_t* g, int64_t ld,
                                             int valid, bool vec) {
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < MK * CPR; i += FlashWg<HD>::THREADS) {
    // eight consecutive threads fill one 128-byte core matrix
    const int r = i % 8 + i / (8 * CPR) * 8, c = i / 8 % CPR;
    uint16_t* dst = s + r / 8 * (HD * 8) + c * 64 + r % 8 * 8;
    const uint16_t* src = g + (int64_t)r * ld + c * 8;
    if (r >= valid) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(FlashWg<HD>::THREADS)
flash_fwd_wgmma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int S, int H,
                       int KH, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                       int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale_log2, int vec) {
  using F = FlashWg<HD>;
  constexpr int KD = HD / 16;   // k-steps of q k^T over the head dim
  constexpr int ND = HD / 8;    // n8 tiles of a warp's output rows
  constexpr int NS = MK / 8;    // n8 tiles of a warp's score rows
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vs = ks + 2 * F::TILE;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::BQ;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg;                     // this warpgroup's first row
  const int ra = row0 + warp * 16 + g, rb = ra + 8;  // this thread's two rows
  // the key tiles this warpgroup needs, and the block's
  const int my_tiles = row0 < S ? (min(S, row0 + 64) + MK - 1) / MK : 0;
  const int n_tiles = (min(S, q0 + F::BQ) + MK - 1) / MK;

  // q as A fragments, in registers for the whole walk
  uint32_t qf[KD][4];
  const uint16_t* qp = q + b * q_sb + h * q_sh;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qp + (int64_t)ra * q_ss + c, ra < S, vec);
    qf[kk][1] = load_pair(qp + (int64_t)rb * q_ss + c, rb < S, vec);
    qf[kk][2] = load_pair(qp + (int64_t)ra * q_ss + c + 8, ra < S, vec);
    qf[kk][3] = load_pair(qp + (int64_t)rb * q_ss + c + 8, rb < S, vec);
  }

  float acc[ND * 4];
#pragma unroll
  for (int e = 0; e < ND * 4; ++e) acc[e] = 0.0f;
  float m_a = NEG_INF_F, m_b = NEG_INF_F, l_a = 0.0f, l_b = 0.0f;

  const uint16_t* kb = k + b * k_sb + kvh * k_sh;
  const uint16_t* vb = v + b * v_sb + kvh * v_sh;
  auto load = [&](int buf, int tile) {
    const int key0 = tile * MK, valid = min(MK, S - key0);
    load_kv_core<HD>(ks + buf * F::TILE, kb + (int64_t)key0 * k_ss, k_ss, valid, vec);
    load_kv_core<HD>(vs + buf * F::TILE, vb + (int64_t)key0 * v_ss, v_ss, valid, vec);
  };

  load(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    fence_proxy_async();   // this thread's copies, visible to wgmma
    __syncthreads();
    // the other buffer was read in iteration j - 1, which every thread
    // finished (its wgmma waited) before the barrier
    if (j + 1 < n_tiles) load((j + 1) & 1, j + 1);
    cp_async_commit();
    if (j >= my_tiles) continue;   // past this warpgroup's diagonal
    const uint16_t* kt = ks + (j & 1) * F::TILE;
    const uint16_t* vt = vs + (j & 1) * F::TILE;

    // S = q k^T over the head dim, 16 at a time
    float sc[NS * 4];
#pragma unroll
    for (int e = 0; e < NS * 4; ++e) sc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Wgmma<MK>::template rs<0>(sc, qf[kk], wgmma_desc(kt + kk * 128, 128, F::GROUP),
                                kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // scale into base 2; the warpgroup's last tile holds its diagonal and
    // the end of S
    const int key0 = j * MK;
    const bool edge = j == my_tiles - 1;
    float mx_a = NEG_INF_F, mx_b = NEG_INF_F;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + n * 8 + 2 * t + e;
        float sa = sc[4 * n + e] * scale_log2, sb = sc[4 * n + 2 + e] * scale_log2;
        if (edge) {
          if (key > ra || key >= S) sa = NEG_INF_F;
          if (key > rb || key >= S) sb = NEG_INF_F;
        }
        sc[4 * n + e] = sa;
        sc[4 * n + 2 + e] = sb;
        mx_a = fmaxf(mx_a, sa);
        mx_b = fmaxf(mx_b, sb);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;   // this thread's columns; quads merge at the end
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * n + e] = exp2f(sc[4 * n + e] - mn_a);
        sc[4 * n + 2 + e] = exp2f(sc[4 * n + 2 + e] - mn_b);
        ps_a += sc[4 * n + e];
        ps_b += sc[4 * n + 2 + e];
      }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[4 * d + 0] *= al_a;
      acc[4 * d + 1] *= al_a;
      acc[4 * d + 2] *= al_b;
      acc[4 * d + 3] *= al_b;
    }

    // acc += P V: the score accumulators of two n8 key tiles are the A
    // fragment of one k16 step, rounded to bf16 in registers
    uint32_t pa[MK / 16][4];
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk)
      Wgmma<HD>::template rs<1>(acc, pa[kk], wgmma_desc(vt + kk * 2 * HD * 8, F::GROUP, 128),
                                1);
    wgmma_commit();
    wgmma_wait<0>();
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(FULL_MASK, l_a, off);
    l_b += __shfl_xor_sync(FULL_MASK, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  uint16_t* op = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = d * 8 + 2 * t;
    if (ra < S)
      store_pair(op + (int64_t)ra * o_ss + c, acc[4 * d] / den_a, acc[4 * d + 1] / den_a, vec);
    if (rb < S)
      store_pair(op + (int64_t)rb * o_ss + c, acc[4 * d + 2] / den_b, acc[4 * d + 3] / den_b,
                 vec);
  }
}

template <int HD>
static cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                                int S, int H, int KH, const long long* st, float scale,
                                int vec, cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  const int smem = FlashWg<HD>::SMEM;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(kernel, smem, done);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + FlashWg<HD>::BQ - 1) / FlashWg<HD>::BQ));
  kernel<<<grid, FlashWg<HD>::THREADS, smem, stream>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v, (uint16_t*)o, S, H, KH,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * LOG2E, vec);
  return cudaGetLastError();
}


template <typename T, int HD>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                          int H, int KH, const long long* st, float scale,
                          cudaStream_t stream) {
  dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  constexpr int smem = 2 * BK * HD * (int)sizeof(float);   // at most 48 KB
  static_assert(smem <= 48 * 1024, "fp32 K/V tiles above the default limit");
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KH, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

static cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int H, int KH, int HD, const long long* st, float scale,
                              cudaStream_t stream) {
  switch (HD) {
    case 16: return launch<float, 16>(q, k, v, o, B, S, H, KH, st, scale, stream);
    case 32: return launch<float, 32>(q, k, v, o, B, S, H, KH, st, scale, stream);
    case 64: return launch<float, 64>(q, k, v, o, B, S, H, KH, st, scale, stream);
    case 112: return launch<float, 112>(q, k, v, o, B, S, H, KH, st, scale, stream);
    case 128: return launch<float, 128>(q, k, v, o, B, S, H, KH, st, scale, stream);
    case 192: return launch<float, 192>(q, k, v, o, B, S, H, KH, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

static cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int H, int KH, int HD, const long long* st, float scale,
                               cudaStream_t stream) {
  // 16-byte copies and 4-byte pairs need aligned bases and strides in
  // whole 16-byte chunks; otherwise the kernel copies element by element
  bool vec = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 8 == 0;
  switch (HD) {
    case 16: return launch_wgmma<16>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    case 32: return launch_wgmma<32>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    case 112: return launch_wgmma<112>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    case 192: return launch_wgmma<192>(q, k, v, o, B, S, H, KH, st, scale, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int S, int H, int KH, int HD,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      float scale, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KH) return cudaErrorInvalidValue;
  if (dtype == DT_F32) return launch_f32(q, k, v, o, B, S, H, KH, HD, st, scale, s);
  if (dtype == DT_BF16) return launch_bf16(q, k, v, o, B, S, H, KH, HD, st, scale, s);
  return cudaErrorInvalidValue;
}


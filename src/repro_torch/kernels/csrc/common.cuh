// Shared pieces of the port's CUDA kernels: dtype conversion, 16-byte
// vector loads, the columns of a split row read from any phase, and the
// online-softmax (m, s) state with its block merge.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#define NEG_INF_F (-1e30f)
#define FULL_MASK 0xffffffffu

// Sets a kernel's dynamic shared memory limit once a device, on its first
// launch there: `done` is the caller's static bit set of devices done.
template <typename F>
static inline cudaError_t set_smem_once(F kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// dtype codes passed by the Python wrappers
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) VecT { T v[VEC]; };

// The columns a block of a split row owns.  A row's head is the columns
// before its first 16-byte boundary, fewer than VEC = 16 / sizeof(T) (at
// most V); split 0 starts at column 0, split i > 0 at head + i span (span
// a multiple of 8), and the last split ends at V.  So every split but
// the first starts on a 16-byte boundary, and each is an edge of fewer
// than VEC columns, read one at a time, an aligned body of n_vec whole
// vectors from column body, and an edge after it.
struct Cols { int64_t lo, hi, body, n_vec; };

template <typename T>
__device__ __forceinline__ Cols split_cols(const T* row, int64_t V, int64_t span, int split,
                                           int n_splits) {
  constexpr int64_t VEC = 16 / sizeof(T);
  const int64_t phase = (int64_t)(((uintptr_t)row / sizeof(T)) & (VEC - 1));
  const int64_t to_boundary = (VEC - phase) & (VEC - 1);
  const int64_t head = to_boundary < V ? to_boundary : V;
  Cols c;
  c.lo = split == 0 ? 0 : head + split * span;
  c.hi = split == n_splits - 1 ? V : head + (split + 1) * span;
  c.body = split == 0 ? head : c.lo;
  c.n_vec = (c.hi - c.body) / VEC;
  return c;
}

// The e-th column of a split's two edges: the columns [lo, body) and
// those after the body, up to hi; -1 past the last.  At most 2 (VEC - 1)
// columns, so the first threads of a block take one each.
template <typename T>
__device__ __forceinline__ int64_t edge_col(const Cols& c, int e) {
  constexpr int64_t VEC = 16 / sizeof(T);
  const int64_t n_head = c.body - c.lo, tail = c.body + c.n_vec * VEC;
  if (e < n_head) return c.lo + e;
  return e - n_head < c.hi - tail ? tail + (e - n_head) : -1;
}

// A 16-byte vector read once, marked evict-first (ld.global.cs): a stream
// through the logits then keeps less of the cache from other data
template <typename T, int VEC>
__device__ __forceinline__ VecT<T, VEC> load_once(const VecT<T, VEC>* p) {
  static_assert(sizeof(VecT<T, VEC>) == 16, "16-byte vectors only");
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const VecT<T, VEC>*>(&u);
}

// VEC consecutive elements at p (aligned to sizeof(T) * VEC) as fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  VecT<T, VEC> v = *reinterpret_cast<const VecT<T, VEC>*>(p);
#pragma unroll
  for (int u = 0; u < VEC; ++u) out[u] = to_f32(v.v[u]);
}

// e^d for d <= 0 by one ex2.approx (relative error about 2^-22); a d
// of -1e30 or -inf gives 0, d = 0 gives 1
__device__ __forceinline__ float exp_approx(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

// Online softmax state: running max m and sum of exp(x - m).  The start
// value is (NEG_INF_F, 0) as in the reference, so a value below -1e30
// adds exp(x + 1e30) == 0, exactly as there.
struct MS { float m; float s; };

// The state after the N values x, with no branch: their max with m, one
// rescale of s, and e^(x - m) of each by exp_approx.  m stays exact (a
// max); -inf values add nothing, whatever the state.
template <int N>
__device__ __forceinline__ void ms_push(MS& st, const float* x) {
  float m = st.m;
#pragma unroll
  for (int u = 0; u < N; ++u) m = fmaxf(m, x[u]);
  float s = st.s * exp_approx(st.m - m);
#pragma unroll
  for (int u = 0; u < N; ++u) s += exp_approx(x[u] - m);
  st = {m, s};
}

__device__ __forceinline__ MS ms_merge(MS a, MS b) {
  float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ MS ms_shfl_xor(MS a, int off) {
  return {__shfl_xor_sync(FULL_MASK, a.m, off), __shfl_xor_sync(FULL_MASK, a.s, off)};
}

// A split's side of a merge in one launch.  Every thread of the block
// calls it once, after writing its part of the block's partial to global
// memory, and gets the same answer: whether this block is the last of
// the n blocks that count themselves in *counter.  The last one resets
// the counter to zero for the next launch, and its threads then see
// every other block's partial.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
  __shared__ int is_last;
  __threadfence();   // this block's partial, before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == n - 1;
    if (is_last) *counter = 0;   // every block has arrived
  }
  __syncthreads();
  const bool last = is_last;
  if (last) __threadfence();   // and the others' partials after it
  return last;
}

// Block-wide merge of a value with an associative, commutative merge
// whose identity is `identity`; every thread returns the result.
// blockDim.x is a multiple of 32, at most 1024.  Lanes past the number of
// warps take the identity: a merge such as the (m, s) sum is not
// idempotent, so no partial may enter twice.
template <typename T, typename Shfl, typename Merge>
__device__ __forceinline__ T block_merge(T v, T identity, Shfl shfl, Merge merge) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = merge(v, shfl(v, off));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < n_warps ? part[lane] : identity;
  __syncthreads();   // part may be reused by the next merge
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = merge(v, shfl(v, off));
  return v;
}

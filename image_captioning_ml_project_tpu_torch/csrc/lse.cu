// One-pass row log-sum-exp and per-block maxima over vocab-sized logits,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lse_and_block_max`
// (image_captioning_ml_project_tpu/ops/pallas_lse.py). For each row r of
// the [R, V] logits (float32, bfloat16 or float16, unit column stride, any
// row stride) it writes, in float32:
//   lse[r]        = log(sum_v exp(x[r, v]))
//   bm[r, i]      = max of columns [i * block, (i + 1) * block), the ragged
//                   last block padded with -1e30, as there
// The beam candidate step reads both once per decode step.
//
// What bounds it on the card: device memory. The flagship's step reads
// [320, 50257] bf16 logits, 32 MB, in 9.6 us at 3.35 TB/s (less where the
// LM head leaves them in the 50 MB L2), with a max, an exp and an add per
// element. What held a first version of this kernel to a third of that
// rate was not the arithmetic but the chain of dependent steps each warp
// ran for each block (load, warp maximum, exps, warp sum, merge) before
// it could start the next, in short-lived CTAs. The design streams:
// - A warp reads a `block`-wide column block (at most 512) in 16-byte
//   vectors from the 16-byte boundary at or below its first column (a bf16
//   row of 50257 columns starts 2r mod 16 bytes off a boundary) and
//   attributes each value to its column: values outside the block or the
//   row are masked. A vector holding any byte of the row lies in a page of
//   the row, so no read faults.
// - Each warp walks several blocks of one row, the next block's vectors in
//   flight while it reduces the current one. Each lane keeps its own
//   running (max, sum of exp(x - max)) across them, so that the exps of a
//   block wait for no other lane; only the block maximum, exact in float32
//   and written once by the warp's first lane, takes a warp reduction.
// - A CTA of up to 4 warps covers consecutive blocks of one row; each row
//   is split over a few CTAs, enough that the grid is about one full wave
//   of resident CTAs (fewer warps where rows are few, as at R = 5).
//   Their (max, rescaled sum) partials meet in one launch: each CTA writes
//   its partial to a scratch array and counts itself on the row's counter;
//   the last CTA of the row to finish merges every partial in CTA order and
//   resets the counter to 0 for the next launch. Every merge runs in a
//   fixed order, so two runs on the same input are bit-identical.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMinCtas = 2 * 132;      // two CTAs on every SM of an H100
constexpr int kResidentCtas = 8 * 132;  // a full wave of 4-warp CTAs
constexpr float kPad = -1e30f;          // the ragged block's padding
constexpr float kLog2e = 1.4426950408889634f;

// The 16 / sizeof(T) values of a 16-byte vector, widened to float32.
__device__ __forceinline__ void widen(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float (&v)[8]);
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u,
                                                     float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void widen<__half>(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

template <typename T>
struct Lanes {
  static constexpr int N = 16 / sizeof(T);  // values per vector
  // vectors per lane: a 512-wide block and the one it straddles, in one
  // pass (f32: 129 vectors, 5 a lane; 16-bit: 65, 3 a lane)
  static constexpr int U = (512 / N + 1 + 31) / 32;
};

template <typename T>
__device__ __forceinline__ void widen_vec(const uint4& u,
                                          float (&v)[Lanes<T>::N]) {
  if constexpr (sizeof(T) == 4) {
    widen(u, v);
  } else {
    widen<T>(u, v);
  }
}

// 2^x on the special function unit (relative error under 2^-22; results
// under 2^-126 flush to 0, negligible beside a sum of at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) for x <= m, 0 where x is -inf.
__device__ __forceinline__ float exp_below(float x, float m) {
  return ex2(__fmul_rn(__fsub_rn(x, m), kLog2e));
}

// (m, s) := the merge of (m, s) and (m2, s2), each a max and a sum of
// exp(x - max).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;  // both empty (or every value -inf)
  s = (m == -CUDART_INF_F ? 0.f : s * exp_below(m, mn)) +
      (m2 == -CUDART_INF_F ? 0.f : s2 * exp_below(m2, mn));
  m = mn;
}

// The lanes' (m, s) pairs merged, every lane holding the result: the
// maximum first, then the rescaled sums, each in butterfly order.
__device__ __forceinline__ void warp_merge(float& m, float& s) {
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float t = m == -CUDART_INF_F ? 0.f : s * exp_below(m, mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  m = mx, s = t;
}

__device__ __forceinline__ float finish(float m, float s) {
  return m == -CUDART_INF_F ? m : m + logf(s);
}

// A column block of a row, read from the 16-byte boundary at or below its
// first column.
struct Block {
  const uint4* first;
  int lead;  // values of vector 0 before the block's first column
  int len;   // the block's columns (at most 512)
};

template <typename T>
__device__ __forceinline__ Block block_at(const T* row, int c0, int len) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row + c0);
  // rows and 16-byte boundaries are both sizeof(T)-aligned
  return {reinterpret_cast<const uint4*>(addr & ~uintptr_t(15)),
          static_cast<int>(addr & 15) / static_cast<int>(sizeof(T)), len};
}

// Lane `lane`'s vectors of the block (zero past its end).
template <typename T>
__device__ __forceinline__ void load_block(const Block& b, int lane,
                                           uint4 (&raw)[Lanes<T>::U]) {
  constexpr int N = Lanes<T>::N, U = Lanes<T>::U;
  const int nvec = (b.lead + b.len + N - 1) / N;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = u * 32 + lane;
    raw[u] = v < nvec ? __ldg(b.first + v) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Folds the lane's values of the block into its running (m, s); returns
// the block's maximum (every lane holds it).
template <typename T>
__device__ __forceinline__ float fold_block(const Block& b, int lane,
                                            const uint4 (&raw)[Lanes<T>::U],
                                            float& m, float& s) {
  constexpr int N = Lanes<T>::N, U = Lanes<T>::U;
  float x[U][N];
  float lm = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    widen_vec<T>(raw[u], x[u]);
    const int rel = (u * 32 + lane) * N - b.lead;  // column of value 0
    if (rel < 0 || rel + N > b.len) {  // the block's edges, or past it
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (static_cast<unsigned>(rel + i) >= static_cast<unsigned>(b.len))
          x[u][i] = -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) lm = fmaxf(lm, x[u][i]);
  }
  const float mn = fmaxf(m, lm);
  if (mn != -CUDART_INF_F) {
    float add = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i) add += exp_below(x[u][i], mn);
    s = (m == -CUDART_INF_F ? 0.f : s * exp_below(m, mn)) + add;
    m = mn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, o));
  return lm;
}

// Grid: R * nct CTAs, CTA c of row r covering column blocks
// [c * warps * bpw, (c + 1) * warps * bpw): warp w takes blocks
// c * warps * bpw + t * warps + w for t < bpw, so that the CTA's warps read
// one stretch of the row at a time.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) lse_block_max_kernel(
    const T* __restrict__ x, int64_t ld, int V, int block, int nblk, int bpw,
    int nct, float* __restrict__ lse, float* __restrict__ bm,
    unsigned* __restrict__ counters, float2* __restrict__ partials) {
  constexpr int U = Lanes<T>::U;
  __shared__ float2 part[kMaxWarps];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x / nct, c = blockIdx.x - r * nct;
  const T* row = x + r * ld;
  const int blk0 = c * warps * bpw + warp;
  auto block_of = [&](int blk) {
    const int c0 = blk * block;
    return block_at<T>(row, c0, min(block, V - c0));
  };
  float m = -CUDART_INF_F, s = 0.f;
  uint4 cur[U], next[U];
  if (blk0 < nblk) load_block<T>(block_of(blk0), lane, cur);
  for (int t = 0; t < bpw; ++t) {
    const int blk = blk0 + t * warps;
    if (blk >= nblk) break;
    if (t + 1 < bpw && blk + warps < nblk)
      load_block<T>(block_of(blk + warps), lane, next);
    const Block b = block_of(blk);
    const float bmx = fold_block<T>(b, lane, cur, m, s);
    if (lane == 0)
      bm[static_cast<int64_t>(r) * nblk + blk] =
          b.len < block ? fmaxf(bmx, kPad) : bmx;
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
  }
  warp_merge(m, s);
  if (lane == 0) part[warp] = make_float2(m, s);
  __syncthreads();
  if (warp != 0) return;
  // warp 0: the CTA's partial, its warps merged in butterfly order
  float cm = -CUDART_INF_F, cs = 0.f;
  if (lane < warps) cm = part[lane].x, cs = part[lane].y;
  warp_merge(cm, cs);
  if (nct == 1) {
    if (lane == 0) lse[r] = finish(cm, cs);
    return;
  }
  unsigned ticket = 0;
  if (lane == 0) {
    partials[static_cast<int64_t>(r) * nct + c] = make_float2(cm, cs);
    __threadfence();
    ticket = atomicAdd(&counters[r], 1u);
  }
  if (__shfl_sync(0xffffffffu, ticket, 0) != static_cast<unsigned>(nct - 1))
    return;
  // the row's last CTA: every partial in CTA order, lane by lane, then the
  // lanes in butterfly order
  __threadfence();
  float rm = -CUDART_INF_F, rs = 0.f;
  for (int i = lane; i < nct; i += 32) {
    const float2 p = __ldcg(&partials[static_cast<int64_t>(r) * nct + i]);
    merge(rm, rs, p.x, p.y);
  }
  warp_merge(rm, rs);
  if (lane == 0) {
    lse[r] = finish(rm, rs);
    counters[r] = 0u;
  }
}

template <typename T>
cudaError_t launch(const void* x, int64_t ld, int R, int V, int block,
                   float* lse, float* bm, int* scratch, cudaStream_t stream) {
  if (block > 512) return cudaErrorInvalidValue;  // one pass a block
  const int nblk = (V + block - 1) / block;
  // warps a CTA: the most that leave two CTAs on every SM; CTAs a row: as
  // many as make about one wave of resident CTAs; blocks a warp: the rest
  int warps = kMaxWarps;
  while (warps > 1 && static_cast<int64_t>(R) *
                              ((nblk + warps - 1) / warps) < kMinCtas)
    warps >>= 1;
  const int most = (nblk + warps - 1) / warps;
  const int want = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(most, kResidentCtas / R)));
  const int bpw = (nblk + want * warps - 1) / (want * warps);
  const int nct = (nblk + warps * bpw - 1) / (warps * bpw);
  const int64_t grid = static_cast<int64_t>(R) * nct;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  unsigned* counters = reinterpret_cast<unsigned*>(scratch);
  float2* partials = reinterpret_cast<float2*>(scratch + (R + 1) / 2 * 2);
  lse_block_max_kernel<T><<<static_cast<unsigned>(grid), warps * 32, 0,
                            stream>>>(static_cast<const T*>(x), ld, V, block,
                                      nblk, bpw, nct, lse, bm, counters,
                                      partials);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 =
// bfloat16, 2 = float16. x is [R, V] with unit column stride and row
// stride `ld` (elements); lse [R] and bm [R, ceil(V / block)] float32;
// scratch holds (R + 1) / 2 * 2 + 2 * R * ceil(V / block) int32, zero on
// the first launch and left zero by every launch (the rows' counters,
// then the CTAs' partials). Returns the cudaError_t of the launch (0 =
// success).
extern "C" int lse_and_block_max(int dtype, int device, const void* x,
                                 long long ld, int R, int V, int block,
                                 float* lse, float* bm, int* scratch,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R < 1 || V < 1 || block < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(x, ld, R, V, block, lse, bm, scratch, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(x, ld, R, V, block, lse, bm, scratch, s);
      break;
    case 2:
      err = launch<__half>(x, ld, R, V, block, lse, bm, scratch, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

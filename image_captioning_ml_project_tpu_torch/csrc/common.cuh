// Device building blocks shared by the port's layer kernels (sm_90a): the
// flax-exact LayerNorm, the activations, and a tiled GEMM with the JAX
// `nn.Dense` epilogue, on the primitives of device.cuh (conversions,
// reductions, cp.async, mma.sync).
//
// Rounding follows the JAX package, not `nn.Linear`: a Dense layer's f32
// dot is rounded to the working type and the bias is then added in that
// type (two roundings in bf16; `F.linear` on CUDA adds the bias in f32 and
// rounds once). Residual adds and activations take working-type inputs
// and round their result to the working type. In float32 every rounding
// is the identity. Each f32 expression is written with `__f*_rn`
// intrinsics where the plain PyTorch version evaluates it as separate
// operations, so that nvcc does not contract it into an FMA the plain
// version does not have.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <cstdio>
#include <mutex>
#include <unordered_map>

#include "device.cuh"

namespace port {

// HF `gelu_new` as jax.nn.gelu(approximate=True) spells it, in f32.
__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi) in f32
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

// CLIP's quick_gelu, in f32 (the Pallas encoder runs its sigmoid in f32).
__device__ __forceinline__ float quick_gelu(float x) {
  const float s = 1.0f / (1.0f + expf(-__fmul_rn(1.702f, x)));
  return __fmul_rn(x, s);
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, flax `_normalize` numerics (f32 mean and
// mean of squares, variance clipped at 0, gamma folded into the rsqrt
// multiplier before the elementwise multiply). gamma/beta are f32.
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;

// The V = 16 / sizeof(T) values of one 16-byte chunk, widened to f32.
__device__ __forceinline__ void unpack_chunk(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack_chunk(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows are read and written in 16-byte chunks (H a multiple of 8, x, out,
// gamma and beta 16-byte aligned: the callers' wrappers check), a lane
// taking every 32nd chunk.
template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(T* __restrict__ out, const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, int M, int H,
                      float eps) {
  constexpr int V = 16 / sizeof(T);
  launch_dependents();
  grid_dependency_wait();  // x is the kernel before's output
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (int64_t)row * H);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < H / V; c += 32) {
    float v[V];
    unpack_chunk(xr[c], v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s += v[i];
      s2 += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = __fdiv_rn(s, (float)H);
  const float mu2 = __fdiv_rn(s2, (float)H);
  const float var = fmaxf(0.f, __fsub_rn(mu2, __fmul_rn(mu, mu)));
  const float r = rsqrtf(__fadd_rn(var, eps));
  T* orow = out + (int64_t)row * H;
  for (int c = lane; c < H / V; c += 32) {
    float v[V];
    unpack_chunk(xr[c], v);
    alignas(16) T y[V];
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 g = *reinterpret_cast<const float4*>(gamma + c * V + i);
      const float4 b = *reinterpret_cast<const float4*>(beta + c * V + i);
      const float gs[4] = {g.x, g.y, g.z, g.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float mul = __fmul_rn(r, gs[j]);
        y[i + j] = from_f32<T>(__fadd_rn(
            __fmul_rn(__fsub_rn(v[i + j], mu), mul), bs[j]));
      }
    }
    *reinterpret_cast<uint4*>(orow + c * V) = *reinterpret_cast<uint4*>(y);
  }
}

template <typename T>
cudaError_t layer_norm(T* out, const T* x, const float* gamma,
                       const float* beta, int M, int H, float eps,
                       cudaStream_t stream) {
  cudaLaunchAttribute attr = dependent_launch_attribute();
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((M + kLnWarps - 1) / kLnWarps);
  config.blockDim = dim3(kLnWarps * 32);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, layer_norm_kernel<T>, out, x, gamma,
                            beta, M, H, eps);
}

// ---------------------------------------------------------------------------
// GEMM with the Dense epilogue:
//   C[m, n] = epi(round_T(sum_k A[m, k] * W[n, k]), bias[n], R[m, n])
// A is row-major [M, K] (row stride lda); W is [N, K] row-major (the
// `nn.Linear` weight layout, row stride ldw), so both operands are
// contiguous along K; C and R are row-major with strides ldc and ldr.
// ---------------------------------------------------------------------------

enum Epilogue : int {
  kBias = 0,          // round(dot) + bias
  kBiasGeluNew = 1,   // gelu_new(round(dot) + bias)
  kBiasQuickGelu = 2, // quick_gelu(round(dot) + bias)
  kBiasResidual = 3,  // R + (round(dot) + bias)
};

// The epilogue on values: `acc` the f32 dot, `b` the bias and `r` the
// residual (read only under kBiasResidual) widened to f32. The result is
// still to be rounded to T.
template <typename T>
__device__ __forceinline__ float epilogue_value(float acc, float b, float r,
                                                int epi) {
  float v = round_to<T>(__fadd_rn(round_to<T>(acc), b));
  if (epi == kBiasGeluNew) {
    v = gelu_new(v);
  } else if (epi == kBiasQuickGelu) {
    v = quick_gelu(v);
  } else if (epi == kBiasResidual) {
    v = __fadd_rn(r, v);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T dense_epilogue(float acc, int m, int n,
                                            const T* __restrict__ bias,
                                            const T* __restrict__ res, int ldr,
                                            int epi) {
  const float r =
      epi == kBiasResidual ? to_f32(res[(int64_t)m * ldr + n]) : 0.f;
  return from_f32<T>(epilogue_value<T>(acc, to_f32(bias[n]), r, epi));
}

// bf16 on Hopper's tensor cores: `wgmma` fed by TMA.
//
// A block computes a 128 x 128 tile of C (64 x 128 with one consumer
// warpgroup, where the GEMM has few tiles; see `dense`). One producer warp
// asks the TMA unit for a 128-row x 64-deep box of A and one of W per K
// step (`cp.async.bulk.tensor`, 16 KB each, in the 128-byte swizzle) into a
// ring of kStages stages (kDeepStages when the launch has at most one block
// per SM: few rows, where the weights stream from device memory and the
// ring is all that hides their latency); each stage has a "full" mbarrier
// that the copies complete and an "empty" one that the consumers release.
// Two consumer warpgroups take 64 rows of the tile each and issue, per K
// step, four `wgmma.mma_async` m64n128k16 whose operands are both read
// from shared memory through matrix descriptors (K-major, 128-byte
// swizzle), with their 64 x 128 f32 sums in registers; one group of four
// stays in flight while the next stage is awaited. Rows of A or W past M,
// N or K are filled with zeros by the TMA unit, so the main loop has no
// predicate.
// Two blocks fit on an SM (97 KB of shared memory, at most 112 registers),
// so one block's epilogue runs under the other's products. Tried on the
// card and dropped, both slower: one block of a cluster loading a W tile
// for all the row tiles of its column (TMA multicast: the blocks then
// move in step, each stage waiting for the slowest's release), and
// blocks starting their walk over K at different steps (the blocks of a
// launch reading the same tiles at the same time is what keeps them L2
// hits).
//
// The epilogue goes through shared memory: the f32 sums are staged in the
// (now free) ring, and each thread then takes eight neighbouring outputs
// of a row at a time: it reads bias and residual as 16-byte vectors (all
// of a thread's residual reads are issued before the first is used: one at
// a time, their latency was most of a tile's time), applies the Dense
// epilogue and stores 16 bytes.
//
// Split-K: a GEMM of few tiles (few rows, as a decode step has, or a
// narrow N) would leave most of the 132 SMs idle while each block walks
// all of K. Then blockIdx.z takes a slice of K, and the blocks of one tile
// form a thread-block cluster. Each block finishes a share of the tile's
// rows: after a cluster barrier (every ring is free) each block stores
// its f32 sums of a row into the shared memory of the block that finishes
// that row (`st.shared::cluster`: stores to distributed shared memory are
// not waited for, where a block that read the others' sums paid every
// load's latency in turn), into a slot of its own; after a second barrier
// each block adds its rows' slots, slice 0 first and in rank order
// (deterministic, and the rounding is that of one f32 sum, as without the
// split), and applies the epilogue. No workspace and no second launch.
//
// Needs K, lda, ldw, N, ldc, ldr multiples of 8 and 16-byte aligned A, W,
// C, bias and R (checked by the callers' wrappers; `dense` refuses the
// rest).
namespace gemm_bf16 {
constexpr int BN = 128, BK = 64;  // and 64 rows per consumer warpgroup
constexpr int kStages = 3;      // the ring when blocks share an SM
constexpr int kDeepStages = 6;  // and when a block has the SM to itself
constexpr int LDC = BN + 8;  // f32 staging stride: conflict-free float2 rows
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kSMs = 132;
// kWG consumer warpgroups and the producer warp
__host__ __device__ constexpr int threads(int kWG) {
  return (4 * kWG + 1) * 32;
}
// one stage: kWG * 64 rows of A and BN rows of W, BK deep
__host__ __device__ constexpr int stage_bytes(int kWG) {
  return (64 * kWG + BN) * BK * 2;
}
// ring + slack to align it to 1024 bytes + the 2 * stages barriers
__host__ __device__ constexpr int smem_bytes(int kWG, int stages) {
  return stages * stage_bytes(kWG) + 1024 + 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Spin until the barrier's phase differs from `parity`. The loop is the
// three instructions below and no more: a wait with a clock check around
// it measured 5-8% on the layer kernels' time (a later wake-up at every
// stage of every tile).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One 2-D box at (k, row) into shared memory; completes `bar` by bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// The shared-memory matrix descriptor of a K-major operand tile in the
// 128-byte swizzle: rows 128 bytes apart, groups of eight rows 1024 bytes
// apart (the stride byte offset; the leading byte offset is unused in
// this layout). A 16-deep K step inside the 128-byte row advances the
// start address by 32 bytes, 2 in the descriptor's 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (+)= a . b^T: 64 x 128 x 16, both operands from shared memory; with
// `accumulate` 0 the sums start from zero.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      " %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Eight neighbouring outputs of a row: the f32 sums `lo`, `hi`, the bias
// `b8` and the residual `r8` (eight bf16 each) through the Dense epilogue
// into 16 bytes at `dst`.
// Two f32 values rounded to bf16 in one conversion (the unit that converts
// runs at a sixteenth of the rate of the adders: one value at a time, the
// three roundings per output were most of the epilogue), low half first.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float low_f32(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float high_f32(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

template <int kEpi>
__device__ __forceinline__ void store_outputs(bf16* dst, float4 lo, float4 hi,
                                              uint4 b8, uint4 r8) {
  // `epilogue_value` on pairs: every rounding and every `__f*_rn` as there
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t b[4] = {b8.x, b8.y, b8.z, b8.w};
  const uint32_t r[4] = {r8.x, r8.y, r8.z, r8.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t = pack2(v[2 * i], v[2 * i + 1]);  // round(dot)
    t = pack2(__fadd_rn(low_f32(t), low_f32(b[i])),
              __fadd_rn(high_f32(t), high_f32(b[i])));
    if (kEpi == kBiasGeluNew) {
      t = pack2(gelu_new(low_f32(t)), gelu_new(high_f32(t)));
    } else if (kEpi == kBiasQuickGelu) {
      t = pack2(quick_gelu(low_f32(t)), quick_gelu(high_f32(t)));
    } else if (kEpi == kBiasResidual) {
      t = pack2(__fadd_rn(low_f32(r[i]), low_f32(t)),
                __fadd_rn(high_f32(r[i]), high_f32(t)));
    }
    o[i] = t;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

// Grid: x the row tiles of C, y the column tiles, z the K slices of
// `kb_per` K steps each, the slices of a tile being one cluster. One
// instantiation per epilogue, so that the epilogue's loop is straight code.
template <int kEpi, int kWG>
__global__ void __launch_bounds__(threads(kWG), 2)
    kernel(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ C,
           int ldc, const bf16* __restrict__ bias, const bf16* __restrict__ R,
           int ldr, int M, int N, int K, int kb_per, int stages,
           int weights_ahead) {
  namespace cg = cooperative_groups;
  constexpr int BM = 64 * kWG, kThreads = threads(kWG);
  constexpr int kConsumerWarps = 4 * kWG;
  constexpr int kTileBytes = BM * BK * 2, kStageBytes = stage_bytes(kWG);
  constexpr int kGroups = BN / 8, kRowStep = kThreads / kGroups;
  constexpr int kPasses = (BM + kRowStep - 1) / kRowStep;
  static_assert((BM + kMaxSplits + kRowStep) * LDC * 4 <=
                    kStages * kStageBytes,
                "the f32 staging tile (rounded up per slice, and the rows an "
                "unrolled epilogue reads past it) reuses the ring");
  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on address bits: tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStageBytes);
  uint64_t* empty = full + stages;
  float* Cs = reinterpret_cast<float*>(smem);  // [BM, LDC] after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int splits = gridDim.z;
  const int kb0 = blockIdx.z * kb_per;  // this block's K steps
  const int nkb = min(kb_per, (K + BK - 1) / BK - kb0);

  launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
  if (warp == kConsumerWarps) {
    // producer: the whole warp walks the ring, lane 0 issues the copies.
    // With `weights_ahead` (W is a model's weights: no kernel on the stream
    // writes them) the first round's W tiles are asked for before the wait
    // for the kernel before this one, whose output A is.
    const int ahead = weights_ahead ? min(nkb, stages) : 0;
    if (lane == 0) {
      for (int kt = 0; kt < ahead; ++kt) {
        mbar_expect_tx(&full[kt], kStageBytes);
        tma_load(smem + kt * kStageBytes + kTileBytes, &map_w, &full[kt],
                 (kb0 + kt) * BK, n0);
      }
    }
    grid_dependency_wait();
    if (lane == 0) {
      for (int kt = 0; kt < ahead; ++kt)
        tma_load(smem + kt * kStageBytes, &map_a, &full[kt], (kb0 + kt) * BK,
                 m0);
    }
    __syncwarp();
    for (int kt = ahead; kt < nkb; ++kt) {
      const int s = kt % stages;
      mbar_wait(&empty[s], ((kt / stages) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* stage = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(stage, &map_a, &full[s], (kb0 + kt) * BK, m0);
        tma_load(stage + kTileBytes, &map_w, &full[s], (kb0 + kt) * BK, n0);
      }
      __syncwarp();
    }
  } else {
    const int wg = warp >> 2;  // rows [64 wg, 64 wg + 64) of the tile
    grid_dependency_wait();  // before the epilogue's reads of R and stores
    for (int kt = 0; kt < nkb; ++kt) {
      const int s = kt % stages;
      mbar_wait(&full[s], (kt / stages) & 1);
      const uint32_t stage = smem_u32(smem + s * kStageBytes);
      const uint64_t da = wgmma_desc(stage + wg * 64 * BK * 2);
      const uint64_t db = wgmma_desc(stage + kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % stages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
  __syncthreads();  // every product has read its stage: the ring is free

  // This block's share of the tile's rows that lie inside C: with a split,
  // rank z of the cluster finishes rows [z rows_per, (z + 1) rows_per).
  cg::cluster_group cluster = cg::this_cluster();
  const int rows_in = min(BM, M - m0);
  const int rows_per = (rows_in + splits - 1) / splits;
  const int r0 = blockIdx.z * rows_per;
  const int nrows = max(0, min(rows_per, rows_in - r0));
  if (splits > 1) cluster.sync();  // every ring of the cluster is free
  if (warp < kConsumerWarps) {
    // thread t of a warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8)
    // and, per 8-column group j, columns 8 j + 2 (t % 4) (+ 1)
    const int col = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
      if (splits == 1) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(&Cs[row * LDC + j * 8 + col]) =
              make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
      } else if (row < rows_in) {
        // to the block that finishes this row, into its slot for this
        // block's slice: [slice, row of its share, column]
        const int owner = row / rows_per;
        const uint32_t local = smem_u32(
            &Cs[(blockIdx.z * rows_per + row - owner * rows_per) * LDC + col]);
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(local), "r"(owner));
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(
                           remote + j * 32),
                       "f"(acc[j * 4 + 2 * h]), "f"(acc[j * 4 + 2 * h + 1])
                       : "memory");
      }
    }
  }
  if (splits > 1)
    cluster.sync();  // the sums have arrived; no block is written any more
  else
    __syncthreads();

  // Thread t takes the 8-column group t % 16 of rows t / 16, t / 16 +
  // kRowStep, ... of the block's share.
  const int c = (tid % kGroups) * 8, rsub = tid / kGroups;
  const int n = n0 + c;
  if (n < N) {
    const uint4 b8 = *reinterpret_cast<const uint4*>(bias + n);
    const bf16* res = R + (int64_t)(m0 + r0) * ldr + n;
    bf16* dst = C + (int64_t)(m0 + r0) * ldc + n;
    if (splits == 1) {
      // every read (staged sums, residual) is in flight before the first
      // is used; rows past the share read staging memory that is there
      // (the ring is larger) and are dropped
      uint4 r8[kPasses];
      float4 lo[kPasses], hi[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = rsub + p * kRowStep;
        const float4* src =
            reinterpret_cast<const float4*>(&Cs[r * LDC + c]);
        lo[p] = src[0];
        hi[p] = src[1];
        r8[p] = make_uint4(0, 0, 0, 0);
        if (kEpi == kBiasResidual && r < nrows)
          r8[p] = *reinterpret_cast<const uint4*>(res + (int64_t)r * ldr);
      }
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = rsub + p * kRowStep;
        if (r < nrows)
          store_outputs<kEpi>(dst + (int64_t)r * ldc, lo[p], hi[p], b8, r8[p]);
      }
    } else {
      // slice 0's sums first, then the others in rank order
#pragma unroll 1
      for (int r = rsub; r < nrows; r += kRowStep) {
        uint4 r8 = make_uint4(0, 0, 0, 0);
        if (kEpi == kBiasResidual)
          r8 = *reinterpret_cast<const uint4*>(res + (int64_t)r * ldr);
        float4 lo[kMaxSplits], hi[kMaxSplits];
#pragma unroll
        for (int z = 0; z < kMaxSplits; ++z) {
          if (z < splits) {
            const float4* src = reinterpret_cast<const float4*>(
                &Cs[(z * rows_per + r) * LDC + c]);
            lo[z] = src[0];
            hi[z] = src[1];
          }
        }
#pragma unroll
        for (int z = 1; z < kMaxSplits; ++z) {
          if (z < splits) {
            lo[0].x += lo[z].x, lo[0].y += lo[z].y, lo[0].z += lo[z].z;
            lo[0].w += lo[z].w, hi[0].x += hi[z].x, hi[0].y += hi[z].y;
            hi[0].z += hi[z].z, hi[0].w += hi[z].w;
          }
        }
        store_outputs<kEpi>(dst + (int64_t)r * ldc, lo[0], hi[0], b8, r8);
      }
    }
  }
}

// The TMA descriptor of a K-major bf16 matrix [rows, K] with row stride
// ld, for boxes of `box` rows x BK values in the 128-byte swizzle; reads past
// the matrix give zeros. Encoding is a call into libcuda on the host
// (`cuTensorMapEncodeTiled`, fetched through the runtime with
// `cudaGetDriverEntryPoint`, so nothing links against it); a layer loop
// issues the same few dozen matrices every step, so descriptors are kept
// per (address, shape, stride). An
// entry depends on nothing but its key, so a stale one is still right.
// (`static`: each library that includes this header keeps its own cache; a
// plain inline function's static locals would be one object for the whole
// process, whichever library's copy of the code runs.)
struct MapKey {
  const void* ptr;
  int rows, K, ld, box;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && K == o.K && ld == o.ld &&
           box == o.box;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr);
    for (int v : {k.rows, k.K, k.ld, k.box})
      h = h * 0x9E3779B97F4A7C15ull + v;
    return h;
  }
};

static inline cudaError_t tensor_map(CUtensorMap* out, const bf16* ptr,
                                     int rows, int K, int ld, int box) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  const MapKey key{ptr, rows, K, ld, box};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    PORT_TRY(cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                     cudaEnableDefault, &found));
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box_dims[2] = {BK, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
      strides, box_dims, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) {
    fprintf(stderr,
            "port::tensor_map: cuTensorMapEncodeTiled failed (%d) for %p "
            "[%d, %d] ld %d\n",
            (int)res, (const void*)ptr, rows, K, ld);
    return cudaErrorInvalidValue;
  }
  if (cache.size() >= 4096) cache.clear();  // callers with ever-new buffers
  cache.emplace(key, *out);
  return cudaSuccess;
}

// K slices for a GEMM of `tiles` output tiles and `steps` K steps. A split
// costs two cluster barriers and a tile of f32 sums per block through
// distributed shared memory, about as much as a dozen K steps: so a slice
// keeps at least kMinSteps of them (a K of 768 is never split, one of 3072
// up to four times), and no more slices than give every SM a block or than
// a cluster holds.
constexpr int kMinSteps = 12;
inline int splits_for(int tiles, int steps) {
  const int want = (kSMs + tiles - 1) / tiles;
  return std::max(1, std::min({want, steps / kMinSteps, kMaxSplits}));
}
}  // namespace gemm_bf16

// float32 on the CUDA cores (the reference configuration): 64x64 block
// tile, 16-deep K steps in shared memory, 256 threads of 4x4 outputs each.
namespace gemm_f32 {
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    kernel(float* __restrict__ C, int ldc, const float* __restrict__ A,
           int lda, const float* __restrict__ W, int ldw,
           const float* __restrict__ bias, const float* __restrict__ R,
           int ldr, int M, int N, int K, int epi) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, k = e % BK;
      As[k][r] = (m0 + r < M && k0 + k < K)
                     ? A[(int64_t)(m0 + r) * lda + k0 + k]
                     : 0.f;
      Ws[k][r] = (n0 + r < N && k0 + k < K)
                     ? W[(int64_t)(n0 + r) * ldw + k0 + k]
                     : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N)
        C[(int64_t)m * ldc + n] =
            dense_epilogue<float>(acc[i][j], m, n, bias, R, ldr, epi);
    }
}
}  // namespace gemm_f32

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch of kernel<*, kWG>: opts the four epilogues' kernels in to their
// shared memory once per device, picks the split and the ring's depth.
// `static`, as `tensor_map`: the opt-in is per library, as the kernels are.
template <int kWG>
static cudaError_t launch_dense(bf16* C, int ldc, const bf16* A, int lda,
                                const bf16* W, int ldw, const bf16* bias,
                                const bf16* R, int ldr, int M, int N, int K,
                                int epi, bool weights_ahead,
                                cudaStream_t stream) {
  using namespace gemm_bf16;
  constexpr int BM = 64 * kWG;
  static std::once_flag opted_in[64];  // per device
  static cudaError_t opt_in_err[64];
  int device = 0;
  PORT_TRY(cudaGetDevice(&device));
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  std::call_once(opted_in[device], [&] {
    cudaError_t err = cudaSuccess;
    for (auto fn : {kernel<kBias, kWG>, kernel<kBiasGeluNew, kWG>,
                    kernel<kBiasQuickGelu, kWG>, kernel<kBiasResidual, kWG>})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes(kWG, kDeepStages));
    opt_in_err[device] = err;
  });
  PORT_TRY(opt_in_err[device]);
  CUtensorMap map_a, map_w;
  PORT_TRY(tensor_map(&map_a, A, M, K, lda, BM));
  PORT_TRY(tensor_map(&map_w, W, N, K, ldw, BN));

  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int steps = (K + BK - 1) / BK;
  int splits = splits_for(mt * nt, steps);
  const int kb_per = (steps + splits - 1) / splits;
  splits = (steps + kb_per - 1) / kb_per;  // no empty slice
  // a launch of at most one block per SM streams its weights from device
  // memory with nothing else to hide the latency: a deeper ring
  const int stages = mt * nt * splits <= kSMs ? kDeepStages : kStages;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(mt, nt, splits);
  config.blockDim = dim3(threads(kWG));
  config.dynamicSmemBytes = smem_bytes(kWG, stages);
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = splits;
  attrs[1] = dependent_launch_attribute();
  config.attrs = attrs;
  config.numAttrs = 2;
  auto fn = kernel<kBias, kWG>;
  switch (epi) {
    case kBias: break;
    case kBiasGeluNew: fn = kernel<kBiasGeluNew, kWG>; break;
    case kBiasQuickGelu: fn = kernel<kBiasQuickGelu, kWG>; break;
    case kBiasResidual: fn = kernel<kBiasResidual, kWG>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaLaunchKernelEx(&config, fn, map_a, map_w, C, ldc, bias, R, ldr,
                            M, N, K, kb_per, stages, (int)weights_ahead);
}

// What the bf16 GEMM takes; says on stderr what it refuses.
static inline bool dense_operands_ok(const bf16* C, int ldc, const bf16* A,
                                     int lda, const bf16* W, int ldw,
                                     const bf16* bias, const bf16* R, int ldr,
                                     int M, int N, int K, int epi) {
  const bool residual = epi == kBiasResidual;
  if (M >= 1 && N % 8 == 0 && K % 8 == 0 && lda % 8 == 0 && ldw % 8 == 0 &&
      ldc % 8 == 0 && aligned16(A) && aligned16(W) && aligned16(C) &&
      aligned16(bias) && (!residual || (R && ldr % 8 == 0 && aligned16(R))))
    return true;
  fprintf(stderr,
          "port::dense: M=%d N=%d K=%d lda=%d ldw=%d ldc=%d ldr=%d A=%p W=%p "
          "C=%p bias=%p R=%p: needs N, K and the strides multiples of 8 and "
          "16-byte aligned operands\n",
          M, N, K, lda, ldw, ldc, ldr, (const void*)A, (const void*)W,
          (const void*)C, (const void*)bias, (const void*)R);
  return false;
}

// 128-row tiles where they fill the card (many rows: two warpgroups share
// each weight tile they load); where they would not (few rows: a decode
// step, a small batch), 64-row tiles, so that twice as many SMs share the
// products and no row of a 320-row step is padding.
inline bool few_tiles(int M, int N) {
  return ((M + 127) / 128) * ((N + gemm_bf16::BN - 1) / gemm_bf16::BN) <
         gemm_bf16::kSMs;
}

// The bf16 Dense layer: one launch, whatever the split (see gemm_bf16).
// R may be null unless epi is kBiasResidual. `weights_ahead`: W is not
// written by the kernel before this one on the stream (a model's weights),
// so the launch may read it while that kernel still runs.
static inline cudaError_t dense(bf16* C, int ldc, const bf16* A, int lda,
                                const bf16* W, int ldw, const bf16* bias,
                                const bf16* R, int ldr, int M, int N, int K,
                                int epi, bool weights_ahead,
                                cudaStream_t stream) {
  if (!dense_operands_ok(C, ldc, A, lda, W, ldw, bias, R, ldr, M, N, K, epi))
    return cudaErrorInvalidValue;
  if (few_tiles(M, N))
    return launch_dense<1>(C, ldc, A, lda, W, ldw, bias, R, ldr, M, N, K, epi,
                           weights_ahead, stream);
  return launch_dense<2>(C, ldc, A, lda, W, ldw, bias, R, ldr, M, N, K, epi,
                         weights_ahead, stream);
}

// float32 GEMMs (the reference configuration) stay on the CUDA cores.
inline cudaError_t dense(float* C, int ldc, const float* A, int lda,
                         const float* W, int ldw, const float* bias,
                         const float* R, int ldr, int M, int N, int K, int epi,
                         bool, cudaStream_t stream) {
  using namespace gemm_f32;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, 0, stream>>>(C, ldc, A, lda, W, ldw, bias, R, ldr,
                                        M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace port

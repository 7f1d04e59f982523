// Device building blocks shared by the port's layer kernels (sm_90a):
// type conversions, warp reductions, the flax-exact LayerNorm, the
// activations, and a tiled GEMM with the JAX `nn.Dense` epilogue.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>

// Evaluate a launch that returns cudaError_t; return it from the enclosing
// function if it failed.
#define PORT_TRY(expr)                         \
  do {                                         \
    const cudaError_t port_err_ = (expr);      \
    if (port_err_ != cudaSuccess) return port_err_; \
  } while (0)

namespace port {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the value a T tensor would hold.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(T* __restrict__ out, const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, int M, int H,
                      float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (int64_t)row * H;
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < H; k += 32) {
    const float v = to_f32(xr[k]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = __fdiv_rn(s, (float)H);
  const float mu2 = __fdiv_rn(s2, (float)H);
  const float var = fmaxf(0.f, __fsub_rn(mu2, __fmul_rn(mu, mu)));
  const float r = rsqrtf(__fadd_rn(var, eps));
  T* orow = out + (int64_t)row * H;
  for (int k = lane; k < H; k += 32) {
    const float mul = __fmul_rn(r, gamma[k]);
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(to_f32(xr[k]), mu), mul),
                              beta[k]);
    orow[k] = from_f32<T>(y);
  }
}

template <typename T>
cudaError_t layer_norm(T* out, const T* x, const float* gamma,
                       const float* beta, int M, int H, float eps,
                       cudaStream_t stream) {
  const int blocks = (M + kLnWarps - 1) / kLnWarps;
  layer_norm_kernel<T><<<blocks, kLnWarps * 32, 0, stream>>>(
      out, x, gamma, beta, M, H, eps);
  return cudaGetLastError();
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

template <typename T>
__device__ __forceinline__ T dense_epilogue(float acc, int m, int n,
                                            const T* __restrict__ bias,
                                            const T* __restrict__ res, int ldr,
                                            int epi) {
  float v = round_to<T>(__fadd_rn(round_to<T>(acc), to_f32(bias[n])));
  if (epi == kBiasGeluNew) {
    v = gelu_new(v);
  } else if (epi == kBiasQuickGelu) {
    v = quick_gelu(v);
  } else if (epi == kBiasResidual) {
    v = __fadd_rn(to_f32(res[(int64_t)m * ldr + n]), v);
  }
  return from_f32<T>(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 on the tensor cores: 64x64 block tile, 32-deep K steps staged in
// shared memory by cp.async with double buffering; four warps, each a
// 32x32 sub-tile of 2x2 wmma 16x16x16 fragments with f32 accumulators.
// The accumulators go through shared memory for the epilogue, so the
// stores of C are coalesced. Needs K, lda, ldw multiples of 8 and 16-byte
// aligned A and W (checked by the callers' wrappers).
//
// Split-K: a GEMM of few blocks (few rows, as a decode step with a small
// batch has, or a narrow N) would leave most of the 132 SMs idle while
// each block walks all of K, one latency-bound tile at a time. Then
// blockIdx.z takes a slice of `kps` K values and the block writes its f32
// sums to `partial` [splits, M, N]; `reduce_kernel` adds the slices in a
// fixed order (deterministic) and applies the epilogue, so the rounding is
// that of one f32 sum, as without the split.
namespace gemm_bf16 {
constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 8, LDC = BN + 4;
constexpr int kThreads = 128;
constexpr int kTargetBlocks = 2 * 132;  // two blocks for each SM
constexpr int kMinStepsPerSplit = 4;

__global__ void __launch_bounds__(kThreads)
    kernel(bf16* __restrict__ C, int ldc, const bf16* __restrict__ A, int lda,
           const bf16* __restrict__ W, int ldw, const bf16* __restrict__ bias,
           const bf16* __restrict__ R, int ldr, int M, int N, int K,
           int epi, float* __restrict__ partial, int kps) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][BM * LDS];
  __shared__ __align__(128) bf16 Ws[2][BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // this block's K slice [kbeg, kend)
  const int kbeg = blockIdx.z * kps;
  const int kend = min(K, kbeg + kps);
  auto load = [&](int kt, int buf) {
    const int k0 = kbeg + kt * BK;
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), k8 = (c % (BK / 8)) * 8;
      const bool ok = (m0 + r < M) && (k0 + k8 < kend);
      const bf16* src = ok ? A + (int64_t)(m0 + r) * lda + k0 + k8 : A;
      cp_async16(&As[buf][r * LDS + k8], src, ok);
    }
    for (int c = tid; c < BN * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), k8 = (c % (BK / 8)) * 8;
      const bool ok = (n0 + r < N) && (k0 + k8 < kend);
      const bf16* src = ok ? W + (int64_t)(n0 + r) * ldw + k0 + k8 : W;
      cp_async16(&Ws[buf][r * LDS + k8], src, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (kend - kbeg + BK - 1) / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][(wm * 32 + i * 16) * LDS + kk],
                               LDS);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[buf][(wn * 32 + j * 16) * LDS + kk],
                               LDS);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled by the next iteration's load
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* part = partial ? partial + (int64_t)blockIdx.z * M * N : nullptr;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    if (part)
      part[(int64_t)m * N + n] = Cs[r * LDC + c];
    else
      C[(int64_t)m * ldc + n] =
          dense_epilogue<bf16>(Cs[r * LDC + c], m, n, bias, R, ldr, epi);
  }
}

// The split-K sums, slice 0 first, then the epilogue; one thread per
// output.
__global__ void reduce_kernel(bf16* __restrict__ C, int ldc,
                              const float* __restrict__ partial, int splits,
                              const bf16* __restrict__ bias,
                              const bf16* __restrict__ R, int ldr, int M,
                              int N, int epi) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)M * N) return;
  const int m = e / N, n = e % N;
  float acc = partial[e];
  for (int z = 1; z < splits; ++z) acc += partial[(int64_t)z * M * N + e];
  C[(int64_t)m * ldc + n] = dense_epilogue<bf16>(acc, m, n, bias, R, ldr, epi);
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

// The split count for a bf16 GEMM: enough K slices to reach
// kTargetBlocks, each at least kMinStepsPerSplit K steps long, and no more
// than the workspace (ws_floats f32 values) holds.
inline int dense_splits(int M, int N, int K, size_t ws_floats) {
  using namespace gemm_bf16;
  const int blocks = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int steps = (K + BK - 1) / BK;
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  splits = std::min(splits, std::max(1, steps / kMinStepsPerSplit));
  splits = std::min<int64_t>(splits, ws_floats / ((int64_t)M * N));
  return std::max(splits, 1);
}

// ws: an f32 workspace of ws_floats values for split-K partial sums (may
// be null with ws_floats 0: no split).
inline cudaError_t dense(bf16* C, int ldc, const bf16* A, int lda,
                         const bf16* W, int ldw, const bf16* bias,
                         const bf16* R, int ldr, int M, int N, int K, int epi,
                         float* ws, size_t ws_floats, cudaStream_t stream) {
  using namespace gemm_bf16;
  const int steps = (K + BK - 1) / BK;
  int splits = dense_splits(M, N, K, ws_floats);
  const int kps = ((steps + splits - 1) / splits) * BK;
  splits = (K + kps - 1) / kps;  // no empty slice
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, 0, stream>>>(C, ldc, A, lda, W, ldw, bias, R, ldr,
                                        M, N, K, epi,
                                        splits > 1 ? ws : nullptr, kps);
  if (splits == 1) return cudaGetLastError();
  PORT_TRY(cudaGetLastError());
  const int64_t total = (int64_t)M * N;
  reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      C, ldc, ws, splits, bias, R, ldr, M, N, epi);
  return cudaGetLastError();
}

// float32 GEMMs (the reference configuration) are not split: the
// workspace arguments are accepted for a uniform call and ignored.
inline cudaError_t dense(float* C, int ldc, const float* A, int lda,
                         const float* W, int ldw, const float* bias,
                         const float* R, int ldr, int M, int N, int K, int epi,
                         float*, size_t, cudaStream_t stream) {
  using namespace gemm_f32;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, 0, stream>>>(C, ldc, A, lda, W, ldw, bias, R, ldr,
                                        M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace port


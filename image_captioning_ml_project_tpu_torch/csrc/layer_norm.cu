// LayerNorm as one op with its own backward (sm_90a): the forward of every
// `models/layers.LayerNorm` on the card, in eval and in training, and its
// gradient. Wrapper: ops/layer_norm.py.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it into a few passes. In plain PyTorch the same numerics are 14
// launches forward and about 25 under autograd, nearly each a full f32
// pass over the activations, and autograd keeps three f32 copies of them
// for the backward (PERF.md, section 6).
//
// Numerics: flax's `_normalize`, as ops/numerics.layer_norm and
// common.cuh's layer_norm_kernel have them: f32 sum and sum of squares,
// var = max(0, E[x^2] - mu^2), mul = rsqrt(var + eps) * gamma, then
// (x - mu) * mul + beta in f32, rounded once to x's type. gamma and beta
// are f32. The backward is, per row, in f32,
//   dx = rstd * (g dy - mean(g dy) - xhat * mean(g dy xhat)),
// xhat = (x - mu) * rstd, rounded once; where the forward clamped the
// variance (E[x^2] - mu^2 < 0) the last term is dropped, as the clamp's
// zero gradient drops it. dgamma = sum over rows of dy * xhat, dbeta = sum
// of dy, in f32.
//
// Bound: bytes. The forward reads x and writes y, and with a gradient
// 8 bytes a row of statistics (mu, and rstd carrying the clamp in its
// sign); the backward reads x, dy and the statistics and writes dx, plus
// per-block partial sums of dgamma and dbeta. At CLIP's 25,600 x 768 in
// bf16: 79 MB (24 us at 3.35 TB/s) and 118 MB (35 us).
//
// Design: a team of 32 to 256 threads takes a row, the team the smallest
// that holds the row in at most kMaxChunks 16-byte chunks a thread (a warp
// a row up to 1,024 bf16 values, eight rows a block), so x and dy are read
// from device memory once and kept in registers between the row's
// reduction and its output. A width that is not a whole number of chunks,
// or an operand off a 16-byte boundary, takes the same code one value at a
// time. The backward sums each thread's columns of dgamma and dbeta over
// the block's rows in registers, adds the block's teams in shared memory
// in team order and writes one partial row a block; a second launch adds
// the partial rows in block order. No atomics: the sums repeat from run to
// run. Without a gradient the same forward runs, with no statistics to
// write.

#include "common.cuh"

namespace {

using port::bf16;

constexpr int kThreads = 256;   // a block
constexpr int kMaxChunks = 4;   // chunks of a row a thread holds
constexpr int kSplits = 8;      // warps of the partial sums' reduction

// VEC values of T read and written at once: a 16-byte chunk, or one value.
template <typename T, int VEC>
struct Chunk {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float (&v)[VEC]) {
    port::unpack_chunk(r, v);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
    alignas(16) T y[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) y[i] = port::from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(y);
  }
};

template <typename T>
struct Chunk<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void widen(const Raw& r, float (&v)[1]) {
    v[0] = port::to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = port::from_f32<T>(v[0]);
  }
};

// VEC consecutive f32 values (gamma, beta), as float4 where VEC allows.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

// a and b summed over the row's team of `tw` threads: a warp, or tw / 32
// warps that exchange their sums through `red`. Every thread of the block
// calls it at once (it may hold the block's barrier).
__device__ __forceinline__ void team_sum2(float& a, float& b, int tw,
                                          float2* red) {
  a = port::warp_sum(a);
  b = port::warp_sum(b);
  if (tw == 32) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int first = warp & ~(tw / 32 - 1);
  float sa = 0.f, sb = 0.f;
  for (int w = first; w < first + tw / 32; ++w) {
    sa += red[w].x;
    sb += red[w].y;
  }
  __syncthreads();
  a = sa;
  b = sb;
}

// The forward of rows [M, H]; `stats` (mu, signed rstd) a row, or null.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ln_forward_kernel(T* __restrict__ out, float2* __restrict__ stats,
                      const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, int M, int H, int tw,
                      float eps) {
  using C = Chunk<T, VEC>;
  __shared__ float2 red[kThreads / 32];
  const int rows = kThreads / tw;  // a block's rows at once
  const int team = threadIdx.x / tw, t = threadIdx.x % tw;
  const int chunks = H / VEC;
  for (int base = blockIdx.x * rows; base < M; base += gridDim.x * rows) {
    const int row = base + team;
    const bool live = row < M;
    const T* xr = x + (int64_t)row * H;
    typename C::Raw raw[kMaxChunks];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = t + k * tw;
      if (live && c < chunks) {
        raw[k] = C::load(xr + c * VEC);
        float v[VEC];
        C::widen(raw[k], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s += v[i];
          s2 += v[i] * v[i];
        }
      }
    }
    team_sum2(s, s2, tw, red);
    if (!live) continue;
    const float mu = __fdiv_rn(s, (float)H);
    const float var = __fsub_rn(__fdiv_rn(s2, (float)H), __fmul_rn(mu, mu));
    const float r = rsqrtf(__fadd_rn(fmaxf(0.f, var), eps));
    if (stats != nullptr && t == 0)
      stats[row] = make_float2(mu, var < 0.f ? -r : r);
    T* orow = out + (int64_t)row * H;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = t + k * tw;
      if (c < chunks) {
        float v[VEC], g[VEC], b[VEC];
        C::widen(raw[k], v);
        load_f32(gamma + c * VEC, g);
        load_f32(beta + c * VEC, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu), __fmul_rn(r, g[i])),
                           b[i]);
        C::store(orow + c * VEC, v);
      }
    }
  }
}

// dx of rows [M, H], and the block's partial sums of dgamma and dbeta:
// `partial` row blockIdx.x of [gridDim.x, 2, H].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ln_backward_kernel(T* __restrict__ dx, float* __restrict__ partial,
                       const T* __restrict__ dy, const T* __restrict__ x,
                       const float2* __restrict__ stats,
                       const float* __restrict__ gamma, int M, int H,
                       int tw) {
  using C = Chunk<T, VEC>;
  extern __shared__ float sums[];  // [2, H], where a block holds teams
  __shared__ float2 red[kThreads / 32];
  const int rows = kThreads / tw;
  const int team = threadIdx.x / tw, t = threadIdx.x % tw;
  const int chunks = H / VEC;
  float dg[kMaxChunks][VEC], db[kMaxChunks][VEC];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) dg[k][i] = db[k][i] = 0.f;
  for (int base = blockIdx.x * rows; base < M; base += gridDim.x * rows) {
    const int row = base + team;
    const bool live = row < M;
    const int64_t at = (int64_t)row * H;
    const float2 st = live ? stats[row] : make_float2(0.f, 0.f);
    const float mu = st.x, r = fabsf(st.y);
    typename C::Raw xr[kMaxChunks], dr[kMaxChunks];
    float a = 0.f, b = 0.f;  // sums of g dy and g dy xhat
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = t + k * tw;
      if (live && c < chunks) {
        xr[k] = C::load(x + at + c * VEC);
        dr[k] = C::load(dy + at + c * VEC);
        float v[VEC], d[VEC], g[VEC];
        C::widen(xr[k], v);
        C::widen(dr[k], d);
        load_f32(gamma + c * VEC, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(v[i], mu), r);
          const float gd = __fmul_rn(g[i], d[i]);
          a = __fadd_rn(a, gd);
          b = __fadd_rn(b, __fmul_rn(gd, xhat));
          dg[k][i] = __fadd_rn(dg[k][i], __fmul_rn(d[i], xhat));
          db[k][i] = __fadd_rn(db[k][i], d[i]);
        }
      }
    }
    team_sum2(a, b, tw, red);
    if (!live) continue;
    const float ma = __fdiv_rn(a, (float)H);
    const float mb = st.y < 0.f ? 0.f : __fdiv_rn(b, (float)H);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = t + k * tw;
      if (c < chunks) {
        float v[VEC], d[VEC], g[VEC];
        C::widen(xr[k], v);
        C::widen(dr[k], d);
        load_f32(gamma + c * VEC, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(v[i], mu), r);
          const float gd = __fmul_rn(g[i], d[i]);
          v[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(gd, ma),
                                        __fmul_rn(xhat, mb)));
        }
        C::store(dx + at + c * VEC, v);
      }
    }
  }
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  if (rows == 1) {  // one team: each thread's columns are its own
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = t + k * tw;
      if (c < chunks) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          out[c * VEC + i] = dg[k][i];
          out[H + c * VEC + i] = db[k][i];
        }
      }
    }
    return;
  }
  for (int turn = 0; turn < rows; ++turn) {  // the teams in order
    if (team == turn) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int c = t + k * tw;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int j = c * VEC + i;
            sums[j] = turn == 0 ? dg[k][i] : __fadd_rn(sums[j], dg[k][i]);
            sums[H + j] =
                turn == 0 ? db[k][i] : __fadd_rn(sums[H + j], db[k][i]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < 2 * H; j += kThreads) out[j] = sums[j];
}

// out [W] = the partial rows [G, W] added in row order: 32 columns a
// block, each column's rows split over kSplits warps and their sums added
// in warp order.
__global__ void __launch_bounds__(32 * kSplits)
    ln_param_grads_kernel(float* __restrict__ out,
                          const float* __restrict__ partial, int G, int W) {
  __shared__ float part[kSplits][33];
  const int lane = threadIdx.x & 31, split = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < W)
    for (int g = split; g < G; g += kSplits)
      s = __fadd_rn(s, partial[(size_t)g * W + col]);
  part[split][lane] = s;
  __syncthreads();
  if (split == 0 && col < W) {
    float total = 0.f;
    for (int w = 0; w < kSplits; ++w) total = __fadd_rn(total, part[w][lane]);
    out[col] = total;
  }
}

// The row's team for width H: the smallest power of two from 32 to
// kThreads whose threads hold the row in kMaxChunks chunks each, or 0.
int team_threads(int H, int vec) {
  const int chunks = H / vec;
  for (int tw = 32; tw <= kThreads; tw *= 2)
    if (chunks <= tw * kMaxChunks) return tw;
  return 0;
}

template <typename T, int VEC>
cudaError_t forward(T* out, float2* stats, const T* x, const float* gamma,
                    const float* beta, int M, int H, float eps,
                    cudaStream_t s) {
  const int tw = team_threads(H, VEC);
  if (tw == 0) return cudaErrorInvalidValue;
  const int rows = kThreads / tw;
  ln_forward_kernel<T, VEC><<<(M + rows - 1) / rows, kThreads, 0, s>>>(
      out, stats, x, gamma, beta, M, H, tw, eps);
  return cudaGetLastError();
}

// The backward's blocks for M rows: as many as the card holds at once, or
// fewer where the rows run out (each block writes one partial row).
template <typename T, int VEC>
int backward_blocks(int device, int M, int H) {
  const int tw = team_threads(H, VEC);
  if (tw == 0) return -1;
  const int rows = kThreads / tw;
  const size_t smem = rows > 1 ? 2 * H * sizeof(float) : 0;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_backward_kernel<T, VEC>, kThreads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  return std::max(1, std::min((M + rows - 1) / rows, per_sm * sms));
}

template <typename T, int VEC>
cudaError_t backward(T* dx, float* partial, float* grads, const T* dy,
                     const T* x, const float2* stats, const float* gamma,
                     int M, int H, int G, cudaStream_t s) {
  const int tw = team_threads(H, VEC);
  if (tw == 0) return cudaErrorInvalidValue;
  const size_t smem = kThreads / tw > 1 ? 2 * H * sizeof(float) : 0;
  ln_backward_kernel<T, VEC><<<G, kThreads, smem, s>>>(
      dx, partial, dy, x, stats, gamma, M, H, tw);
  PORT_TRY(cudaGetLastError());
  ln_param_grads_kernel<<<(2 * H + 31) / 32, 32 * kSplits, 0, s>>>(
      grads, partial, G, 2 * H);
  return cudaGetLastError();
}

}  // namespace

// y [M, H] = LayerNorm(x); with `stats` non-null also each row's (mu,
// signed rstd) [M, 2] f32, for the backward. `vec`: H a whole number of
// 16-byte chunks and every operand on a 16-byte boundary (the wrapper
// checks). Returns a cudaError_t; cudaErrorInvalidValue for a width no
// team holds.
extern "C" int layer_norm_forward(int dtype, int device, void* out,
                                  void* stats, const void* x,
                                  const void* gamma, const void* beta, int M,
                                  int H, float eps, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float2* st = static_cast<float2*>(stats);
  if (dtype == 1) {
    using T = bf16;
    T* y = static_cast<T*>(out);
    const T* xx = static_cast<const T*>(x);
    err = vec ? forward<T, 8>(y, st, xx, g, b, M, H, eps, s)
              : forward<T, 1>(y, st, xx, g, b, M, H, eps, s);
  } else if (dtype == 0) {
    using T = float;
    T* y = static_cast<T*>(out);
    const T* xx = static_cast<const T*>(x);
    err = vec ? forward<T, 4>(y, st, xx, g, b, M, H, eps, s)
              : forward<T, 1>(y, st, xx, g, b, M, H, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// How many blocks (partial rows) the backward of M rows of width H runs;
// -1 for a width no team holds.
extern "C" int layer_norm_backward_blocks(int dtype, int device, int M,
                                          int H, int vec) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (dtype == 1)
    return vec ? backward_blocks<bf16, 8>(device, M, H)
               : backward_blocks<bf16, 1>(device, M, H);
  if (dtype == 0)
    return vec ? backward_blocks<float, 4>(device, M, H)
               : backward_blocks<float, 1>(device, M, H);
  return -1;
}

// dx [M, H] and grads [2, H] (dgamma, dbeta; f32) from dy, x, the
// forward's stats and gamma, over `partial` [G, 2, H] f32 scratch, G from
// layer_norm_backward_blocks. Two launches.
extern "C" int layer_norm_backward(int dtype, int device, void* dx,
                                   void* partial, void* grads,
                                   const void* dy, const void* x,
                                   const void* stats, const void* gamma,
                                   int M, int H, int G, int vec,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  const float2* st = static_cast<const float2*>(stats);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 1) {
    using T = bf16;
    T* d = static_cast<T*>(dx);
    const T* e = static_cast<const T*>(dy);
    const T* xx = static_cast<const T*>(x);
    err = vec ? backward<T, 8>(d, p, gr, e, xx, st, g, M, H, G, s)
              : backward<T, 1>(d, p, gr, e, xx, st, g, M, H, G, s);
  } else if (dtype == 0) {
    using T = float;
    T* d = static_cast<T*>(dx);
    const T* e = static_cast<const T*>(dy);
    const T* xx = static_cast<const T*>(x);
    err = vec ? backward<T, 4>(d, p, gr, e, xx, st, g, M, H, G, s)
              : backward<T, 1>(d, p, gr, e, xx, st, g, M, H, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

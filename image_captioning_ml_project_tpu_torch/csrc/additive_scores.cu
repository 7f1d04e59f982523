// Additive (Bahdanau) attention scores of the soft cross-attention variant,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_additive_scores`
// (image_captioning_ml_project_tpu/ops/pallas_attention.py, body
// `_additive_kernel`). For query row r of image b = r / K (K beams per
// image), query position i and key j:
//   t[h] = round_T(tanh(round_T(q[r, i, h] + k[b, j, h])))   in T, as there
//   s    = (sum_h t[h] * w[h]) / temperature                  f32 sum
//   s    = -1e9 where mask[b, j] != 0
//   s    = s + round_T(bias / temperature)                    f32 add
// Each division is a product with the float32 reciprocal of the
// temperature, as PyTorch divides a CUDA tensor by a Python number.
// The energy bias, which the JAX function adds outside its kernel (divided
// by the temperature in its own dtype), is added here, to every score,
// masked ones included: the function returns what it returned with the
// bias added by a separate launch.
//
// What holds it back on the card: the tanh. At the LSTM's served step (64
// images x 5 beams, 49 feature rows, width 512, bf16) the inputs are 3.6
// MB, read in 1.1 us at 3.35 TB/s, against 8 M tanh evaluations. This
// kernel evaluates the accurate `tanhf` of the plain version, which the
// rounding to bf16 has to reproduce to the bit (tanh.approx.f32 would move
// a bf16 rounding once in about 2^15 elements): two special-function-unit
// operations and about fifteen instructions an element. (A table of the
// 65,536 bf16 inputs' rounded tanh would need none; not tried.) The
// [rows, Q, S, H] broadcast sum never reaches device memory. The design:
// - One warp per (image, key, a group of the image's query rows), the
//   lanes across the width: lane l takes 16-byte chunks l and l + 32, so
//   that each warp-wide load reads 512 contiguous bytes of the key, the
//   query or the energy vector.
// - Each lane holds its chunks of the key row in registers and reuses them
//   for every query row of its group (the image's beams and positions);
//   the query rows and the energy vector come through L1, shared by the
//   warps of a block. At most 64 registers, so that 32 warps stay resident
//   on an SM.
// - bf16: `q + k` for two values at once (`add.rn.bf16x2`, the correctly
//   rounded sum that the plain version's f32 add and bf16 rounding give,
//   since an f32 sum of two bf16 values rounds to bf16 without a second
//   rounding that could differ), the tanh in f32 by `tanhf`, rounded two at
//   a time (`cvt.rn.bf16x2.f32`), widened by a shift or a mask, products
//   summed in f32.
// - A score's partial sums meet in five shuffles, once per (row, key).
// - Query rows are split over more warps only where the grid would
//   otherwise be short of warps to spread over the SMs (the served step at
//   batch 64: all 5 rows a warp, 3,136 warps; at batch 1: a row a warp).
// No shared memory: any width that is a whole number of 16-byte chunks
// runs; the wrapper raises on the others.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kChunks = 2;         // a lane's chunks of a key in registers
constexpr int kMinWarps = 16 * 132;  // four warps a scheduler on an H100
constexpr float kMasked = -1e9f;

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// The two bf16 values of a word, widened (a shift and a mask).
__device__ __forceinline__ float2 widen2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// acc += sum over the chunk's values of round_T(tanh(round_T(q + k))) * w.
__device__ __forceinline__ float chunk_dot(const uint4& q, const uint4& k,
                                           const uint4& w, float acc,
                                           float /*tag*/) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = tanhf(__fadd_rn(__uint_as_float(word(q, i)),
                                    __uint_as_float(word(k, i))));
    acc = fmaf(t, __uint_as_float(word(w, i)), acc);
  }
  return acc;
}
__device__ __forceinline__ float chunk_dot(const uint4& q, const uint4& k,
                                           const uint4& w, float acc,
                                           port::bf16 /*tag*/) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t qi = word(q, i), ki = word(k, i);
    const __nv_bfloat162 sum =
        __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&qi),
                *reinterpret_cast<const __nv_bfloat162*>(&ki));
    const float2 a = widen2(*reinterpret_cast<const uint32_t*>(&sum));
    const __nv_bfloat162 t = __floats2bfloat162_rn(tanhf(a.x), tanhf(a.y));
    const float2 tf = widen2(*reinterpret_cast<const uint32_t*>(&t));
    const float2 wf = widen2(word(w, i));
    acc = fmaf(tf.x, wf.x, acc);
    acc = fmaf(tf.y, wf.y, acc);
  }
  return acc;
}

// Warp `item` = (image b, key j, row group g), g fastest.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 8) additive_scores_kernel(
    float* __restrict__ out, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ w,
    const T* __restrict__ bias, const uint8_t* __restrict__ mask, int B,
    int KQ, int S, int H, int groups, int rows_per_group, float temperature) {
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<int64_t>(B) * S * groups) return;
  const int g = static_cast<int>(item % groups);
  const int64_t bj = item / groups;  // b * S + j
  const int j = static_cast<int>(bj % S), b = static_cast<int>(bj / S);
  const int nchunk = H * static_cast<int>(sizeof(T)) / 16;
  const int npass = (nchunk + 32 * kChunks - 1) / (32 * kChunks);
  const uint4* kr = reinterpret_cast<const uint4*>(k + bj * H);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const float inv_t = __frcp_rn(temperature);
  const float add =
      port::round_to<T>(__fmul_rn(port::to_f32(bias[0]), inv_t));
  const bool masked = mask != nullptr && mask[bj] != 0;

  uint4 kc[kChunks];
  auto load_key = [&](int pass) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = (pass * kChunks + i) * 32 + lane;
      kc[i] = c < nchunk ? __ldg(kr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (npass == 1) load_key(0);
  const int r0 = g * rows_per_group;
  const int r1 = min(r0 + rows_per_group, KQ);
  for (int rr = r0; rr < r1; ++rr) {
    const int64_t row = static_cast<int64_t>(b) * KQ + rr;
    const uint4* qr = reinterpret_cast<const uint4*>(q + row * H);
    float acc = 0.f;
    for (int pass = 0; pass < npass; ++pass) {
      if (npass > 1) load_key(pass);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = (pass * kChunks + i) * 32 + lane;
        if (c < nchunk) acc = chunk_dot(__ldg(qr + c), kc[i], __ldg(wr + c),
                                        acc, T());
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      out[row * S + j] =
          __fadd_rn(masked ? kMasked : __fmul_rn(acc, inv_t), add);
  }
}

template <typename T>
cudaError_t launch(float* out, const void* q, const void* k, const void* w,
                   const void* bias, const void* mask, int B, int K, int Q,
                   int S, int H, float temperature, cudaStream_t stream) {
  if ((static_cast<int64_t>(H) * sizeof(T)) % 16) return cudaErrorInvalidValue;
  const int KQ = K * Q;
  const int64_t base = static_cast<int64_t>(B) * S;
  // as many rows a warp as keeps at least kMinWarps warps
  int rows_per_group = static_cast<int>(
      std::min<int64_t>(KQ, std::max<int64_t>(1, base * KQ / kMinWarps)));
  const int groups = (KQ + rows_per_group - 1) / rows_per_group;
  const int64_t blocks = (base * groups + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  additive_scores_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                              stream>>>(
      out, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const uint8_t*>(mask), B, KQ, S, H, groups, rows_per_group,
      temperature);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q_proj is [B*K, Q, H], k_proj [B, S, H], energy_w [H], energy_b [1],
// out [B*K, Q, S] f32; q_proj, k_proj and energy_w start on 16-byte
// boundaries; mask is a [B, S] byte array (nonzero = masked) or null.
// Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue (1) where a row of H values is not a whole number
// of 16-byte chunks.
extern "C" int additive_scores(int dtype, int device, void* out,
                               const void* q_proj, const void* k_proj,
                               const void* energy_w, const void* energy_b,
                               const void* mask, int B, int K, int Q, int S,
                               int H, float temperature, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(o, q_proj, k_proj, energy_w, energy_b, mask,
                                B, K, Q, S, H, temperature, s);
  } else if (dtype == 0) {
    err = launch<float>(o, q_proj, k_proj, energy_w, energy_b, mask, B, K, Q,
                        S, H, temperature, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

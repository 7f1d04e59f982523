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
// The energy bias is added outside, by the wrapper, as the JAX function
// adds it outside its kernel.
//
// What bounds it on the card: device memory. The projected keys belong to
// the image, not the beam: at 64 images x 5 beams, 49 feature rows and
// width 512 in bf16 they are 3.2 MB, read once in 1 us at 3.35 TB/s,
// against 8 M tanh evaluations, whose instructions (an accurate tanhf is
// about twenty) are the larger cost once the bytes are read. The point of
// the fusion is the [rows, Q, S, H] broadcast sum, 16 MB at those shapes,
// which never reaches device memory: each warp forms its (row, key) pair's
// H values in registers and reduces them against the energy vector at
// once. One block per query row (beam row and position) and group of 8
// keys holds the row's query and the energy vector in shared memory as f32,
// one warp per key, the lanes across the width: 7 blocks per row at 49
// keys, so that enough warps are in flight to hide the loads. The K beams
// of an image read the same key rows, which all but the first find in L2.
// The Pallas kernel's paddings (query rows to 8, keys and width to 128
// lanes) are not carried over.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e9f;

template <typename T>
__global__ void __launch_bounds__(kThreads) additive_scores_kernel(
    float* __restrict__ out, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ w,
    const uint8_t* __restrict__ mask, int K, int Q, int S, int H,
    float temperature) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [H]
  float* ws = qs + H;                          // [H]
  const int row = blockIdx.x;                  // (beam row, position)
  const int b = row / (K * Q);                 // image
  const int j = blockIdx.y * kWarps + (threadIdx.x >> 5);  // key
  const int tid = threadIdx.x, lane = tid & 31;
  for (int h = tid; h < H; h += kThreads) {
    qs[h] = port::to_f32(q[(int64_t)row * H + h]);
    ws[h] = port::to_f32(w[h]);
  }
  __syncthreads();
  if (j >= S) return;

  const T* kj = k + ((int64_t)b * S + j) * H;
  float acc = 0.f;
  for (int h = lane; h < H; h += 32) {
    const float a = port::round_to<T>(__fadd_rn(qs[h], port::to_f32(kj[h])));
    acc += port::round_to<T>(tanhf(a)) * ws[h];
  }
  acc = port::warp_sum(acc);
  if (lane == 0) {
    const bool masked = mask != nullptr && mask[(int64_t)b * S + j] != 0;
    out[(int64_t)row * S + j] = masked ? kMasked : __fdiv_rn(acc, temperature);
  }
}

template <typename T>
cudaError_t launch(float* out, const void* q, const void* k, const void* w,
                   const void* mask, int B, int K, int Q, int S, int H,
                   float temperature, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * H;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(B * K * Q, (S + kWarps - 1) / kWarps);
  additive_scores_kernel<T><<<grid, kThreads, smem, stream>>>(
      out, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(w), static_cast<const uint8_t*>(mask), K, Q, S, H,
      temperature);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q_proj is [B*K, Q, H], k_proj [B, S, H], energy_w [H], out [B*K, Q, S]
// f32; mask is a [B, S] byte array (nonzero = masked) or null. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue (1) where
// the width needs more than 48 KB of shared memory.
extern "C" int additive_scores(int dtype, int device, void* out,
                               const void* q_proj, const void* k_proj,
                               const void* energy_w, const void* mask, int B,
                               int K, int Q, int S, int H, float temperature,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(o, q_proj, k_proj, energy_w, mask, B, K, Q, S,
                                H, temperature, s);
  } else if (dtype == 0) {
    err = launch<float>(o, q_proj, k_proj, energy_w, mask, B, K, Q, S, H,
                        temperature, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

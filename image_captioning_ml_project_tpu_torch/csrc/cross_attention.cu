// Cross-attention decode step: the K beam rows of each image against that
// image's memory, one Transformer-decoder layer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_cross_attention`
// (image_captioning_ml_project_tpu/ops/pallas_cross.py, body `_kernel`).
// For image b, beam k and head n (row r = b * K + k, lanes c = n * hd):
//   s[j] = (sum_d q[r, c + d] * kt[b, c + d, j]) * scale     f32 products
//   s[j] = -1e9 where mask[b, j] != 0
//   w    = round_T(softmax_f32(s))                           weights in T
//   out[r, c + d] = round_T(sum_j w[j] * v[b, j, c + d])    f32 mix
// The keys are stored pre-transposed, kt [B, H, Sm], as the JAX decoder's
// `init_memory_cache` stores them; v is [B, Sm, H].
//
// What bounds it on the card: device memory. The memory K/V belong to the
// image, not to the beam: 2 * Sm * H values per image (38.5 MB per
// layer-step at B = 64, Sm = 196, H = 768 in bf16) against about
// 4 * K * Sm * H flops (0.2 GFLOP), so reading them once takes 11.5 us at
// 3.35 TB/s and the arithmetic a fraction of that on the CUDA cores. The
// Pallas kernel expands the queries with a 0/1 lane mask so that one dense
// [K*NH, H] x [H, Sm] dot per image feeds the TPU's 128x128 matrix unit;
// that multiplies the arithmetic by NH and exists only for the MXU, so it is
// not carried over. Here one block per (head, image) stages that head's key
// slice [hd, Sm] (one contiguous run of kt) and value slice [Sm, hd] in
// shared memory with cp.async, the value copy landing while the scores are
// taken, and serves all K beam rows of the image from them: each memory
// byte crosses device memory once per image, not once per beam. Scores and
// the softmax stay in shared memory (one warp per beam row for the
// softmax); in the mix each thread owns one (beam, head dim) output. No
// memory row is padded: the Sm rows are the encoder's own.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e9f;

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Dynamic shared memory of one block: the key and value slices in T, then
// the K queries and the K x Sm scores in f32.
template <typename T>
size_t cross_smem(int K, int Sm, int hd) {
  return 2 * round16(sizeof(T) * hd * Sm) + sizeof(float) * K * (hd + Sm);
}

// Copy `count` contiguous values from global to shared memory: cp.async in
// 16-byte chunks when the source and the length allow it, else value by
// value.
template <typename T>
__device__ void stage_run(T* dst, const T* src, int count) {
  const size_t bytes = sizeof(T) * count;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && bytes % 16 == 0) {
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads)
      port::cp_async16(d + 16 * i, s + 16 * i, true);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
}

// Sm rows of hd values, row stride H in global memory, packed in shared.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int hd, int H) {
  const size_t row_bytes = sizeof(T) * hd;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row_bytes % 16 == 0 &&
      (sizeof(T) * H) % 16 == 0) {
    const int chunks = static_cast<int>(row_bytes / 16);
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int j = i / chunks, c = i % chunks;
      port::cp_async16(reinterpret_cast<char*>(dst + (size_t)j * hd) + 16 * c,
                       reinterpret_cast<const char*>(src + (int64_t)j * H) +
                           16 * c,
                       true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += kThreads)
      dst[i] = src[(int64_t)(i / hd) * H + i % hd];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cross_attention_kernel(
    T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ kt,
    const T* __restrict__ v, const uint8_t* __restrict__ mask, int K, int Sm,
    int H, int NH, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = H / NH;
  const int n = blockIdx.x;  // head
  const int b = blockIdx.y;  // image
  const int col = n * hd;
  const size_t slice = round16(sizeof(T) * hd * Sm);
  T* ks = reinterpret_cast<T*>(smem);                       // [hd, Sm]
  T* vs = reinterpret_cast<T*>(smem + slice);               // [Sm, hd]
  float* qs = reinterpret_cast<float*>(smem + 2 * slice);   // [K, hd]
  float* ws = qs + K * hd;                                  // [K, Sm]
  const int tid = threadIdx.x;

  // the head's keys are hd consecutive rows of kt[b]: one contiguous run
  stage_run(ks, kt + ((int64_t)b * H + col) * Sm, hd * Sm);
  port::cp_async_commit();
  stage_rows(vs, v + (int64_t)b * Sm * H + col, Sm, hd, H);
  port::cp_async_commit();
  for (int p = tid; p < K * hd; p += kThreads)
    qs[p] = port::to_f32(q[((int64_t)b * K + p / hd) * H + col + p % hd]);
  port::cp_async_wait<1>();  // this thread's key copies have landed
  __syncthreads();

  // scores: one (beam, memory position) per thread and pass
  for (int p = tid; p < K * Sm; p += kThreads) {
    const int k = p / Sm, j = p % Sm;
    const float* qk = qs + k * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += qk[d] * port::to_f32(ks[d * Sm + j]);
    const bool masked = mask != nullptr && mask[(int64_t)b * Sm + j] != 0;
    ws[p] = masked ? kMasked : acc * scale;
  }
  __syncthreads();

  // f32 softmax over the memory axis, one warp per beam row; the weights
  // are rounded to the value type
  const int lane = tid & 31;
  for (int k = tid >> 5; k < K; k += kWarps) {
    float* row = ws + k * Sm;
    float m = -CUDART_INF_F;
    for (int j = lane; j < Sm; j += 32) m = fmaxf(m, row[j]);
    m = port::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Sm; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = port::warp_sum(sum);
    for (int j = lane; j < Sm; j += 32)
      row[j] = port::round_to<T>(row[j] / sum);
  }
  port::cp_async_wait<0>();  // this thread's value copies have landed
  __syncthreads();

  // f32 mix of V: one (beam, head dim) output per thread and pass
  for (int p = tid; p < K * hd; p += kThreads) {
    const int k = p / hd, d = p % hd;
    const float* w = ws + k * Sm;
    float acc = 0.f;
    for (int j = 0; j < Sm; ++j) acc += w[j] * port::to_f32(vs[j * hd + d]);
    out[((int64_t)b * K + k) * H + col + d] = port::from_f32<T>(acc);
  }
}

constexpr int kMaxDevices = 64;

// Opt the kernel in to `smem` bytes of dynamic shared memory on `device`,
// once for each larger size: a decode step launches it once per layer, and
// the attribute call is a driver round trip. Fails (cudaErrorInvalidValue)
// where the block needs more than the card offers.
template <typename T>
cudaError_t opt_in_smem(int device, size_t smem) {
  static size_t opted[kMaxDevices] = {};  // bytes already allowed, per device
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= opted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  opted[device] = smem;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int device, void* out, const void* q, const void* kt,
                   const void* v, const void* mask, int B, int K, int Sm,
                   int H, int NH, float scale, cudaStream_t stream) {
  const size_t smem = cross_smem<T>(K, Sm, H / NH);
  PORT_TRY(opt_in_smem<T>(device, smem));
  cross_attention_kernel<T><<<dim3(NH, B), kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(kt), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), K, Sm, H, NH, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q and out are [B*K, H], mem_kt [B, H, Sm], mem_v [B, Sm, H]; mask is a
// [B, Sm] byte array (nonzero = masked) or null. Returns the cudaError_t of
// the launch (0 = success); cudaErrorInvalidValue (1) where one block
// would need more shared memory than the card offers.
extern "C" int cross_attention(int dtype, int device, void* out,
                               const void* q, const void* mem_kt,
                               const void* mem_v, const void* mask, int B,
                               int K, int Sm, int H, int NH, float scale,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(device, out, q, mem_kt, mem_v, mask, B, K,
                                Sm, H, NH, scale, s);
  } else if (dtype == 0) {
    err = launch<float>(device, out, q, mem_kt, mem_v, mask, B, K, Sm, H, NH,
                        scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Masked scaled-dot-product attention of the multi-head cross-attention
// variant, returning the context and the f32 weights, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_sdpa`
// (image_captioning_ml_project_tpu/ops/pallas_attention.py, body
// `_sdpa_kernel`). For query row r of image b = r / K (K beams per image),
// head n and query position i:
//   s[j] = (sum_d q[r, n, i, d] * k[b, n, j, d]) * scale       f32 products
//   s[j] = -1e9 where mask[b, j] != 0
//   w    = softmax_f32(s)                                    written in f32
//   ctx[r, i, n, :] = round_T(sum_j round_T(w[j]) * v[b, n, j, :])  f32 mix
// q, k and v are read through their strides (the head dimension of each is
// contiguous), so the heads-transposed views of the projections need no
// copy; the context is written [rows, Q, NH, hd], the layout the output
// projection reads.
//
// What bounds it on the card: device memory, and at the served shapes the
// launch itself. The keys and values belong to the image, not the beam: at
// 64 images x 5 beams, 49 feature rows, 8 heads of 64 in bf16 they are
// 6.4 MB, read once in 1.9 us at 3.35 TB/s, against 8 MFLOP. The Pallas
// kernel pads the query rows to 8 and the keys and head width to 128 lanes
// for the TPU's tiles; none of that is carried over. Here one block per
// (head, image, chunk of up to 32 query rows) stages the head's key and
// value rows [S, hd] in shared memory and serves all the image's query
// rows (its K beams x Q positions) from them: each key byte crosses device
// memory once per image. The rows are staged with cp.async in 16-byte
// chunks, all in flight at once, the values landing while the scores are
// taken (value by value where a row is not 16-byte whole). Scores are one
// warp per (row, key) pair, the lanes across the head dimension; the
// softmax one warp per row; in the mix each thread owns one (row, head
// dim) output. The S key rows are the encoder's own: none is padded.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // query rows per block
constexpr float kMasked = -1e9f;

// Dynamic shared memory of one block: the key and value rows in T, then
// kRows queries and kRows x S weights in f32.
template <typename T>
size_t sdpa_smem(int S, int hd) {
  return 2 * port::round16(sizeof(T) * S * hd) +
         sizeof(float) * kRows * (hd + S);
}

// S rows of hd values, `stride` values apart in global memory, packed in
// shared memory: cp.async in 16-byte chunks where the source, the row and
// the stride allow it, else value by value.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int hd,
                           int64_t stride) {
  const size_t row_bytes = sizeof(T) * hd;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && row_bytes % 16 == 0 &&
      (sizeof(T) * stride) % 16 == 0) {
    const int chunks = static_cast<int>(row_bytes / 16);
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int j = i / chunks, c = i % chunks;
      port::cp_async16(reinterpret_cast<char*>(dst + (size_t)j * hd) + 16 * c,
                       reinterpret_cast<const char*>(src + j * stride) +
                           16 * c,
                       true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += kThreads)
      dst[i] = src[(i / hd) * stride + i % hd];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sdpa_kernel(
    T* __restrict__ ctx, float* __restrict__ weights, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, int K, int Q, int S, int NH, int hd,
    int64_t sqb, int64_t sqh, int64_t sqq, int64_t skb, int64_t skh,
    int64_t sks, int64_t svb, int64_t svh, int64_t svs, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x;  // head
  const int b = blockIdx.y;  // image
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, K * Q - row0);
  const size_t slice = port::round16(sizeof(T) * S * hd);
  T* ks = reinterpret_cast<T*>(smem);                      // [S, hd]
  T* vs = reinterpret_cast<T*>(smem + slice);              // [S, hd]
  float* qs = reinterpret_cast<float*>(smem + 2 * slice);  // [kRows, hd]
  float* ws = qs + kRows * hd;                             // [kRows, S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_rows(ks, k + b * skb + n * skh, S, hd, sks);
  port::cp_async_commit();
  stage_rows(vs, v + b * svb + n * svh, S, hd, svs);
  port::cp_async_commit();
  // row t of the chunk is beam (row0 + t) / Q of the image, position
  // (row0 + t) % Q
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int t = row0 + i / hd, d = i % hd;
    const int64_t r = (int64_t)b * K + t / Q;
    qs[i] = port::to_f32(q[r * sqb + n * sqh + (t % Q) * sqq + d]);
  }
  port::cp_async_wait<1>();  // this thread's key copies have landed
  __syncthreads();

  // scores: one warp per (row, key), lanes across the head dimension
  for (int p = warp; p < rows * S; p += kWarps) {
    const int t = p / S, j = p % S;
    const float* qt = qs + t * hd;
    const T* kj = ks + j * hd;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += qt[d] * port::to_f32(kj[d]);
    acc = port::warp_sum(acc);
    if (lane == 0) {
      const bool masked = mask != nullptr && mask[(int64_t)b * S + j] != 0;
      ws[p] = masked ? kMasked : __fmul_rn(acc, scale);
    }
  }
  __syncthreads();

  // f32 softmax over the keys, one warp per row: the f32 weights are
  // written out, and kept rounded to T for the mix
  for (int t = warp; t < rows; t += kWarps) {
    float* row = ws + t * S;
    float m = -CUDART_INF_F;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = port::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(__fsub_rn(row[j], m));
      row[j] = e;
      sum += e;
    }
    sum = port::warp_sum(sum);
    const int tt = row0 + t;
    const int64_t r = (int64_t)b * K + tt / Q;
    float* wout = weights + ((r * NH + n) * Q + tt % Q) * S;
    for (int j = lane; j < S; j += 32) {
      const float w = __fdiv_rn(row[j], sum);
      wout[j] = w;
      row[j] = port::round_to<T>(w);
    }
  }
  port::cp_async_wait<0>();  // this thread's value copies have landed
  __syncthreads();

  // f32 mix of V: one (row, head dim) output per thread and pass
  const int H = NH * hd;
  for (int p = tid; p < rows * hd; p += kThreads) {
    const int t = p / hd, d = p % hd;
    const float* w = ws + t * S;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc += w[j] * port::to_f32(vs[j * hd + d]);
    const int tt = row0 + t;
    const int64_t r = (int64_t)b * K + tt / Q;
    ctx[(r * Q + tt % Q) * H + n * hd + d] = port::from_f32<T>(acc);
  }
}

constexpr int kMaxDevices = 64;

// Opt the kernel in to `smem` bytes of dynamic shared memory on `device`,
// once for each larger size (the attribute call is a driver round trip).
// Fails (cudaErrorInvalidValue) where the block needs more than the card
// offers.
template <typename T>
cudaError_t opt_in_smem(int device, size_t smem) {
  static size_t opted[kMaxDevices] = {};  // bytes already allowed, per device
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= opted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  opted[device] = smem;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int device, void* ctx, float* weights, const void* q,
                   const void* k, const void* v, const void* mask, int B,
                   int K, int Q, int S, int NH, int hd, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const size_t smem = sdpa_smem<T>(S, hd);
  PORT_TRY(opt_in_smem<T>(device, smem));
  const dim3 grid(NH, B, (K * Q + kRows - 1) / kRows);
  sdpa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(ctx), weights, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), K, Q, S, NH, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q holds B*K rows of [NH, Q, hd], k and v B images of [NH, S, hd], each
// read through `strides` (in elements: q's row, head and position strides,
// then k's and v's image, head and key-row strides; the head dimension is
// contiguous). ctx is [B*K, Q, NH, hd], weights [B*K, NH, Q, S] f32; mask
// is a [B, S] byte array (nonzero = masked) or null. Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue (1) where
// one block would need more shared memory than the card offers.
extern "C" int sdpa(int dtype, int device, void* ctx, void* weights,
                    const void* q, const void* k, const void* v,
                    const void* mask, int B, int K, int Q, int S, int NH,
                    int hd, const int64_t* strides, float scale,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(weights);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(device, ctx, w, q, k, v, mask, B, K, Q, S,
                                NH, hd, strides, scale, s);
  } else if (dtype == 0) {
    err = launch<float>(device, ctx, w, q, k, v, mask, B, K, Q, S, NH, hd,
                        strides, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

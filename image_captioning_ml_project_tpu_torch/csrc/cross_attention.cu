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
// What bounds it on the card: device memory, and the round trips to it.
// The memory K/V belong to the image, not to the beam: 2 * Sm * H values
// per image (38.5 MB per layer-step at B = 64, Sm = 196, H = 768 in bf16)
// against about 4 * K * Sm * H flops (0.2 GFLOP), so reading them once
// takes 11.5 us at 3.35 TB/s. The Pallas kernel expands the queries with a
// 0/1 lane mask so that one dense [K*NH, H] x [H, Sm] dot per image feeds
// the TPU's 128x128 matrix unit; that multiplies the arithmetic by NH and
// exists only for the MXU, so it is not carried over. Here one block per
// (head, image) serves all K beam rows of the image, so each memory byte
// crosses device memory once per image.
//
// bf16 (the served path; `tc` below): the products run on the tensor cores
// (mma.sync m16n8k16, f32 sums), the K beams as the rows of one 16-row
// tile: the scores as [K, hd] x [hd, Sm] straight from the pre-transposed
// key slice (ldmatrix.trans), the mix as [K, Sm] x [Sm, hd] with the
// weights already rounded to bf16, so every product is exact in f32. A
// thread's dot of 64 terms, each a shared-memory load and a conversion,
// was what held the first version (and a CUDA-core version with a thread
// per memory row: 8.5 us of scores and 12 us of mix in one block at B = 1).
// Each round trip to device memory costs microseconds, so the key slice
// arrives in one round of copies, and the value slice is asked into L2 at
// the block's start and copied, after the scores, into the same 30 KB of
// shared memory: a block takes 35 KB, and all 768 blocks of a served step
// are resident at once. The softmax is one warp per beam row; its bf16
// weights overwrite the f32 scores in place.
//
// float32 (the reference configuration) and any shape the tensor-core
// path cannot take (a head width not a multiple of 16, a memory length not
// a multiple of 4, a block above the card's shared memory) run on the CUDA
// cores, in the first version's kernel: the head's key and value slices
// staged whole with cp.async, the value copy landing while the scores are
// taken, a thread per (beam, position) score and per (beam, head dim)
// output. Memory rows are not padded: the Sm rows are the encoder's own.

#include <type_traits>

#include "common.cuh"

namespace {

// The CUDA-core path: one (beam, position) score and one (beam, head dim)
// output per thread and pass.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e9f;
constexpr int kSMs = 132;
constexpr size_t kMaxSmem = 232448;  // what one block may opt in to

using port::round16;

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the served path): mma.sync m16n8k16, f32 sums.
// The K beams of an image are the rows of one 16-row tile (padding rows
// read row 0 and are never stored). Scores: A = the queries [K, hd], B =
// the key slice [hd, Sm] as staged (positions contiguous; ldmatrix.trans
// turns its 8 x 8 blocks). Mix: A = the weights [K, Sm] (already rounded
// to bf16, so every product is exact in f32), B = the value slice [Sm, hd]
// (ldmatrix.trans again). The key slice lands in one cp.async round; the
// value slice is asked into L2 at the start and copied, after the scores,
// into the same shared memory.
// ---------------------------------------------------------------------------
namespace tc {

// 256 threads where the grid leaves SMs without a block (batch 1 and 8:
// more warps share a block's copies and softmax), else 128 (every block of
// a served batch of 64 resident at once)
constexpr int kMaxThreads = 256;
inline int threads_for(int blocks) { return blocks < kSMs ? 256 : 128; }

using port::ldmatrix_x2_trans;
using port::ldmatrix_x4;
using port::smem_addr;

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// Row strides (elements) and offsets (bytes) of the block's shared memory.
// A row stride of 16 mod 128 bytes keeps ldmatrix free of bank conflicts.
struct Layout {
  int skt;    // key slice row: >= Sm, padded
  int smk;    // memory rows rounded up to the k-steps of the mix (16)
  int sv;     // value slice row: hd + 8
  int sw;     // score row (bytes): f32 scores, then their bf16 weights
  size_t q, w, m, smem;
};

inline int pad_stride(int elems, int item) {
  int bytes = (elems * item + 15) / 16 * 16;
  while (bytes % 128 != 16) bytes += 16;
  return bytes / item;
}

inline Layout layout(int K, int Sm, int hd) {
  Layout l;
  l.skt = pad_stride(Sm, 2);
  l.smk = (Sm + 15) / 16 * 16;
  l.sv = hd + 8;
  l.sw = pad_stride(std::max(4 * Sm, 2 * l.smk), 1);
  const size_t slice = std::max((size_t)hd * l.skt, (size_t)l.smk * l.sv);
  l.q = port::round16(2 * slice);
  l.w = l.q + port::round16((size_t)2 * K * l.sv);
  l.m = l.w + port::round16((size_t)K * l.sw);
  l.smem = l.m + port::round16(Sm);
  return l;
}

// The key slice can be copied 8 bytes at a time (each row of kt starts on
// 8 bytes), the value rows and queries 16 bytes at a time.
inline bool copies_fit(const void* kt, const void* v,
                                           const void* q, int Sm, int H) {
  return reinterpret_cast<uintptr_t>(kt) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && Sm % 4 == 0 &&
         H % 8 == 0;
}

__global__ void __launch_bounds__(kMaxThreads) cross_attention_mma_kernel(
    port::bf16* __restrict__ out, const port::bf16* __restrict__ q,
    const port::bf16* __restrict__ kt, const port::bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, int K, int Sm, int H, int NH,
    float scale, Layout l) {
  using port::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = H / NH;
  const int col = blockIdx.x * hd;  // head
  const int b = blockIdx.y;         // image
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  bf16* slice = reinterpret_cast<bf16*>(smem);         // keys, then values
  bf16* q_s = reinterpret_cast<bf16*>(smem + l.q);     // [K][sv]
  unsigned char* w_s = smem + l.w;                     // K rows of sw bytes
  uint8_t* m_s = smem + l.m;                           // [Sm]
  const bf16* ks = kt + ((int64_t)b * H + col) * Sm;
  const bf16* vs = v + (int64_t)b * Sm * H + col;

  // the key slice, hd rows of Sm, in one round of 8-byte copies; the
  // queries; the value slice into L2 for later; the mask
  const int kchunks = Sm / 4;
  for (int i = tid; i < hd * kchunks; i += nthreads) {
    const int d = i / kchunks, c = i % kchunks;
    cp_async8(slice + d * l.skt + 4 * c, ks + (int64_t)d * Sm + 4 * c);
  }
  port::cp_async_commit();
  for (int i = tid; i < K * hd / 8; i += nthreads) {
    const int k = i / (hd / 8), c = i % (hd / 8);
    *reinterpret_cast<uint4*>(q_s + k * l.sv + 8 * c) =
        *reinterpret_cast<const uint4*>(q + ((int64_t)b * K + k) * H + col +
                                        8 * c);
  }
  for (int i = tid; i < Sm * ((hd + 63) / 64); i += nthreads)
    port::prefetch_l2(vs + (int64_t)(i % Sm) * H + 64 * (i / Sm));
  for (int j = tid; j < Sm; j += nthreads)
    m_s[j] = mask != nullptr && mask[(int64_t)b * Sm + j] != 0;
  port::cp_async_wait<0>();
  __syncthreads();

  // scores: warp w takes the 8-position tiles w, w + warps, ...; lane l gives
  // ldmatrix the address of A's row l % 16 (k-half l / 16) and B's row l
  const int mtiles = (K + 15) / 16, ntiles = (Sm + 7) / 8;
  for (int mt = 0; mt < mtiles; ++mt) {
    const int ar = mt * 16 + (lane & 15);
    const bf16* arow = q_s + (ar < K ? ar : 0) * l.sv + 8 * (lane >> 4);
    for (int nt = warp; nt < ntiles; nt += nwarps) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < hd; k0 += 16) {
        uint32_t a[4], bb[2];
        ldmatrix_x4(a, arow + k0);
        ldmatrix_x2_trans(bb, slice + (k0 + (lane & 15)) * l.skt + 8 * nt);
        port::mma_16816(c, a, bb[0], bb[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * (lane & 3) + e;
          if (k < K && j < Sm)
            reinterpret_cast<float*>(w_s + k * l.sw)[j] =
                m_s[j] ? kMasked : c[2 * h + e] * scale;
        }
      }
    }
  }
  __syncthreads();  // the key slice is read: the values take its place

  for (int i = tid; i < Sm * (hd / 8); i += nthreads) {
    const int j = i / (hd / 8), c = i % (hd / 8);
    port::cp_async16(slice + j * l.sv + 8 * c, vs + (int64_t)j * H + 8 * c,
                     true);
  }
  port::cp_async_commit();
  for (int i = tid; i < (l.smk - Sm) * l.sv; i += nthreads)
    slice[Sm * l.sv + i] = __float2bfloat16_rn(0.f);  // the k-step's pad

  // f32 softmax over the memory axis, one warp per beam row; the weights,
  // rounded to bf16, overwrite the row's start (each lane reads its f32
  // values of a pass before any lane writes), zeros past Sm
  for (int k = warp; k < K; k += nwarps) {
    float* row = reinterpret_cast<float*>(w_s + k * l.sw);
    bf16* wrow = reinterpret_cast<bf16*>(w_s + k * l.sw);
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
    for (int j0 = 0; j0 < l.smk; j0 += 32) {
      const int j = j0 + lane;
      const float e = j < Sm ? row[j] : 0.f;
      __syncwarp();
      if (j < l.smk) wrow[j] = __float2bfloat16_rn(j < Sm ? e / sum : 0.f);
      __syncwarp();
    }
  }
  port::cp_async_wait<0>();
  __syncthreads();

  // the mix: warp w takes the 8-dim tiles w, w + warps, ... of the head
  for (int mt = 0; mt < mtiles; ++mt) {
    const int ar = mt * 16 + (lane & 15);
    const bf16* arow = reinterpret_cast<const bf16*>(
                           w_s + (ar < K ? ar : 0) * l.sw) +
                       8 * (lane >> 4);
    for (int nt = warp; nt < hd / 8; nt += nwarps) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < l.smk; k0 += 16) {
        uint32_t a[4], bb[2];
        ldmatrix_x4(a, arow + k0);
        ldmatrix_x2_trans(bb, slice + (k0 + (lane & 15)) * l.sv + 8 * nt);
        port::mma_16816(c, a, bb[0], bb[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = mt * 16 + (lane >> 2) + 8 * h;
        if (k < K) {
          const __nv_bfloat162 o = __floats2bfloat162_rn(c[2 * h],
                                                         c[2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((int64_t)b * K + k) * H + col + 8 * nt +
              2 * (lane & 3)) = o;
        }
      }
    }
  }
}

}  // namespace tc

constexpr int kMaxDevices = 64;

// Opt `kernel` in to `smem` bytes of dynamic shared memory on `device`,
// once for each larger size: a decode step launches it once per layer, and
// the attribute call is a driver round trip. Fails (cudaErrorInvalidValue)
// where the block needs more than the card offers. One record per kernel.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int device, size_t smem) {
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> opted[kMaxDevices];
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  size_t& done = opted[device][reinterpret_cast<const void*>(kernel)];
  if (smem <= done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return err;
  }
  done = smem;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int device, void* out, const void* q, const void* kt,
                   const void* v, const void* mask, int B, int K, int Sm,
                   int H, int NH, float scale, cudaStream_t stream) {
  const int hd = H / NH;
  if constexpr (std::is_same<T, port::bf16>::value) {
    const tc::Layout l = tc::layout(K, Sm, hd);
    if (hd % 16 == 0 && l.smem <= kMaxSmem &&
        tc::copies_fit(kt, v, q, Sm, H)) {
      PORT_TRY(opt_in_smem(tc::cross_attention_mma_kernel, device, l.smem));
      tc::cross_attention_mma_kernel<<<dim3(NH, B), tc::threads_for(B * NH),
                                       l.smem, stream>>>(
          static_cast<port::bf16*>(out), static_cast<const port::bf16*>(q),
          static_cast<const port::bf16*>(kt),
          static_cast<const port::bf16*>(v),
          static_cast<const uint8_t*>(mask), K, Sm, H, NH, scale, l);
      return cudaGetLastError();
    }
  }
  const size_t smem = cross_smem<T>(K, Sm, hd);
  PORT_TRY(opt_in_smem(cross_attention_kernel<T>, device, smem));
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

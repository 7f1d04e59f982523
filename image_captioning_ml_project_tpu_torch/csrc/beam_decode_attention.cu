// Beam-decode attention: one GPT-2 layer's attention for one decode step
// over Bk = B * K beam rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_beam_decode_attention`
// (image_captioning_ml_project_tpu/ops/pallas_decode.py, body `_kernel`).
// Row r (image b = r / K) attends, per head, over
//   * the suffix cache at positions t < pos, read from the image-local beam
//     row b*K + anc[r, t] (lazy beam ancestry: the cache is never permuted);
//   * the image's shared prefix K/V [B, P, H] (absent when P == 0, the
//     prefix-free mode);
//   * this step's own key and value.
// Score products are taken in f32 (bf16 * bf16 is exact in f32), the
// softmax is f32, each weight is rounded to the value dtype before the f32
// mix of V, and the mix is rounded to the output dtype. Row r's new K/V row
// is then written into the caches at `pos`, in place.
//
// What bounds it on the card: device memory. Per layer and step the rows
// read up to 2 * Bk * pos * H cache values (20 MB at Bk=320, pos=19, H=768
// in bf16) plus the prefix, and do about two flops per value read. The
// design makes one pass over those bytes and keeps every intermediate out
// of device memory: one block per (row, head) stages the head's query in
// shared memory; each warp scores whole positions, its lanes striding the
// head's contiguous dims (coalesced reads); scores stay in shared memory
// through the softmax; the threads then mix V with one head dim each. The K
// beams of an image read the same cache rows through their ancestry; those
// repeats are served by L2 (a layer's cache is 20 MB against 50 MB of L2).
//
// The in-place append needs no grid-wide order: a block writes only its own
// row's head slice at position `pos`, and every block reads cache positions
// t < pos only, so no block reads what another block writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Block-wide max or sum; `red` holds kWarps floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // every thread has finished reading `red` from last use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The key or value row that score position j reads: suffix positions
// j < pos through the selected beam row, then the P prefix rows, then the
// step's own row. `col` is the head's first lane.
template <typename T>
__device__ __forceinline__ const T* kv_row(int j, int pos, int P,
                                           const int* sel, const T* cache,
                                           const T* prefix, const T* fresh,
                                           int S, int H, int b, int r,
                                           int col) {
  if (j < pos) return cache + ((int64_t)sel[j] * S + j) * H + col;
  if (j < pos + P) return prefix + ((int64_t)b * P + (j - pos)) * H + col;
  return fresh + (int64_t)r * H + col;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) beam_decode_attention_kernel(
    T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_cache, T* v_cache,
    const T* __restrict__ prefix_k, const T* __restrict__ prefix_v,
    const int32_t* __restrict__ anc, int K, int S, int P, int H, int NH,
    int pos, float scale) {
  extern __shared__ float smem[];
  const int hd = H / NH;
  float* q_s = smem;                                 // [hd]
  float* w_s = q_s + hd;                             // [S + P + 1]
  float* red = w_s + (S + P + 1);                    // [kWarps]
  int* sel = reinterpret_cast<int*>(red + kWarps);  // [S]

  const int r = blockIdx.x;   // beam row
  const int n = blockIdx.y;   // head
  const int b = r / K;        // image
  const int col = n * hd;
  const int ntok = pos + P + 1;  // suffix positions < pos, prefix, self
  const int tid = threadIdx.x;

  for (int d = tid; d < hd; d += kThreads)
    q_s[d] = to_f32(q[(int64_t)r * H + col + d]);
  for (int j = tid; j < pos; j += kThreads) {
    int c = anc ? anc[(int64_t)r * S + j] : 0;
    // out-of-range ancestry is a caller bug; clamp so it stays in-bounds
    c = min(max(c, 0), K - 1);
    sel[j] = b * K + c;
  }
  __syncthreads();

  // scores: one warp per position, lanes over the head's dims
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = warp; j < ntok; j += kWarps) {
    const T* krow =
        kv_row(j, pos, P, sel, k_cache, prefix_k, k_new, S, H, b, r, col);
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += q_s[d] * to_f32(krow[d]);
    acc = warp_sum(acc);
    if (lane == 0) w_s[j] = acc * scale;
  }
  __syncthreads();

  // f32 softmax over [suffix; prefix; self]
  float m = -CUDART_INF_F;
  for (int j = tid; j < ntok; j += kThreads) m = fmaxf(m, w_s[j]);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = tid; j < ntok; j += kThreads) {
    const float e = expf(w_s[j] - m);
    w_s[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j < ntok; j += kThreads)
    w_s[j] = to_f32(from_f32<T>(w_s[j] / sum));  // weights in value dtype
  __syncthreads();

  // f32 mix of V, one head dim per thread
  for (int d = tid; d < hd; d += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < ntok; ++j) {
      const T* vrow =
          kv_row(j, pos, P, sel, v_cache, prefix_v, v_new, S, H, b, r, col);
      acc += w_s[j] * to_f32(vrow[d]);
    }
    out[(int64_t)r * H + col + d] = from_f32<T>(acc);
  }

  // append this step's K/V at `pos` (see the note at the top of the file)
  for (int d = tid; d < hd; d += kThreads) {
    const int64_t dst = ((int64_t)r * S + pos) * H + col + d;
    k_cache[dst] = k_new[(int64_t)r * H + col + d];
    v_cache[dst] = v_new[(int64_t)r * H + col + d];
  }
}

template <typename T>
cudaError_t launch(void* out, const void* q, const void* k_new,
                   const void* v_new, void* k_cache, void* v_cache,
                   const void* prefix_k, const void* prefix_v,
                   const void* anc, int Bk, int K, int S, int P, int H,
                   int NH, int pos, float scale, cudaStream_t stream) {
  const int hd = H / NH;
  const size_t smem =
      sizeof(float) * (hd + S + P + 1 + kWarps) + sizeof(int) * S;
  const dim3 grid(Bk, NH);
  beam_decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<const T*>(prefix_k), static_cast<const T*>(prefix_v),
      static_cast<const int32_t*>(anc), K, S, P, H, NH, pos, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// prefix_k/prefix_v may be null when P == 0; anc may be null (all zeros).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int beam_decode_attention(
    int dtype, int device, void* out, const void* q, const void* k_new,
    const void* v_new, void* k_cache, void* v_cache, const void* prefix_k,
    const void* prefix_v, const void* anc, int Bk, int K, int S, int P, int H,
    int NH, int pos, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, q, k_new, v_new, k_cache, v_cache,
                                prefix_k, prefix_v, anc, Bk, K, S, P, H, NH,
                                pos, scale, s);
  } else if (dtype == 0) {
    err = launch<float>(out, q, k_new, v_new, k_cache, v_cache, prefix_k,
                        prefix_v, anc, Bk, K, S, P, H, NH, pos, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

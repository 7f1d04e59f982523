// Whole-stack CLIP vision encoder: all L pre-LN encoder layers over a
// batch of token sequences x [B, T, H], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_encoder_stack`
// (image_captioning_ml_project_tpu/ops/pallas_encoder.py, body
// `_encoder_kernel`). For each layer l, on the residual stream x:
//   qkv = round(LN1(x) . Wqkv[l]) + bqkv[l]      nn.Dense rounding
//   att = per image and head, softmax(q k^T * scale) v over all T tokens:
//         f32 scores, f32 softmax, weights rounded to the working type,
//         f32 mix rounded to the working type
//   x1  = x + (round(att . Wo[l]) + bo[l])
//   u   = quick_gelu(round(LN2(x1) . Wfc[l]) + bfc[l])   sigmoid in f32
//   x   = x1 + (round(u . Wpj[l]) + bpj[l])
// Inference only: there is no backward, as the Pallas kernel has no VJP.
//
// What bounds it on the card: the GEMMs. 64 images of T = 50 tokens are
// 3,200 rows through 85 M weights per encode, about 540 GFLOP, against
// 0.5 GFLOP of attention (T x T = 50 x 50 per head). The Pallas kernel
// pads T to 64 so its head-tiled masked dots fit the MXU, and walks a
// sequential (layer, image-block) grid carrying the residual in VMEM. Here
// nothing is padded in device memory: the GEMMs take M = B * T rows
// directly (25 x 18 tiles of 128 x 128 for the QKV GEMM on the tensor
// cores, `wgmma` fed by TMA, two blocks to an SM; 64-row tiles where a
// small batch gives too few of those; common.cuh), and the attention is one
// block per (image, head): in bf16 with heads of 64 and at most 64 tokens
// it runs both products on the tensor cores (`mma.sync`, the token axis
// padded to 64 inside shared memory only; see the note at its kernel),
// else it stages q, k, v as f32 in shared memory and keeps the T x T
// scores there. No padded key gets a weight and no padded row is returned.
// Seven launches per layer from one host call (LN1, QKV GEMM, attention,
// output GEMM + residual, LN2, fc1 GEMM + quick_gelu, fc2 GEMM +
// residual), all programmatic dependent launches (common.cuh); the
// intermediates live in a scratch buffer of 6 H + F values per row, which
// the wrapper keeps from call to call.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One block per (image b, head n) over qkv [B*T, 3H]; writes the head's
// columns of att [B*T, H]. Any type, any token count and head width that
// fit shared memory; the products run on the CUDA cores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_kernel(T* __restrict__ att, const T* __restrict__ qkv,
                             int T_, int H, int NH, float scale) {
  extern __shared__ float smem[];
  port::launch_dependents();
  port::grid_dependency_wait();  // qkv is the GEMM before's output
  const int hd = H / NH;
  const int ld = hd + 1;  // padded rows: no bank conflicts across tokens
  float* qs = smem;                 // [T, hd + 1]
  float* ks = qs + T_ * ld;         // [T, hd + 1]
  float* vs = ks + T_ * ld;         // [T, hd + 1]
  float* sc = vs + T_ * ld;         // [T, T]
  const int b = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)b * T_;
  for (int e = tid; e < T_ * hd; e += kThreads) {
    const int t = e / hd, d = e % hd;
    const T* src = qkv + (row0 + t) * 3 * H + n * hd + d;
    qs[t * ld + d] = port::to_f32(src[0]);
    ks[t * ld + d] = port::to_f32(src[H]);
    vs[t * ld + d] = port::to_f32(src[2 * H]);
  }
  __syncthreads();
  for (int e = tid; e < T_ * T_; e += kThreads) {
    const int i = e / T_, j = e % T_;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc += qs[i * ld + d] * ks[j * ld + d];
    sc[e] = acc * scale;
  }
  __syncthreads();
  // f32 softmax per query row, one warp per row
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < T_; i += kWarps) {
    float* row = sc + i * T_;
    float m = -CUDART_INF_F;
    for (int j = lane; j < T_; j += 32) m = fmaxf(m, row[j]);
    m = port::warp_max(m);
    float s = 0.f;
    for (int j = lane; j < T_; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = port::warp_sum(s);
    for (int j = lane; j < T_; j += 32)
      row[j] = port::round_to<T>(row[j] / s);
  }
  __syncthreads();
  for (int e = tid; e < T_ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    float acc = 0.f;
    for (int j = 0; j < T_; ++j) acc += sc[i * T_ + j] * vs[j * ld + d];
    att[(row0 + i) * H + n * hd + d] = port::from_f32<T>(acc);
  }
}

size_t attention_smem(int T_, int H, int NH) {
  return sizeof(float) * (3 * T_ * (H / NH + 1) + T_ * T_);
}

// bf16 with at most 64 tokens and heads of 64 (CLIP ViT-B/32: 50 tokens):
// the same attention on the tensor cores. One block per (image, head), four
// warps of 16 query rows each. q, k, v (T x 64) are staged as bf16 by
// cp.async into shared memory, the token axis padded to 64 there and only
// there (rows past T are zero). Each warp takes S = q k^T with
// `mma.sync` m16n8k16 (f32 sums of exact bf16 products) into registers,
// scales it in f32, gives the keys past T a score of -inf so that they get
// a weight of exactly 0, runs the f32 softmax on its two rows per thread
// (quad shuffles), rounds the weights to bf16, which makes them the A
// operand of the second product as they lie, and mixes V (read transposed
// by `ldmatrix.trans`) in f32, rounded once. Nothing of T x T touches
// shared memory.
constexpr int kMmaT = 64, kMmaHd = 64;
constexpr int kMmaLd = kMmaHd + 8;  // 144-byte rows: ldmatrix without conflicts

using port::ldmatrix_x4;
using port::ldmatrix_x4_trans;
using port::mma_16816;
using port::pack_bf16;

__global__ void __launch_bounds__(kThreads)
    encoder_attention_mma_kernel(port::bf16* __restrict__ att,
                                 const port::bf16* __restrict__ qkv, int T_,
                                 int H, float scale) {
  using port::bf16;
  __shared__ __align__(16) bf16 tiles[3][kMmaT * kMmaLd];  // q, k, v
  port::launch_dependents();
  port::grid_dependency_wait();  // qkv is the GEMM before's output
  const int b = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)b * T_;
  // 16-byte chunks: 3 matrices x 64 rows x 8 chunks; rows past T are zeros
  for (int e = tid; e < 3 * kMmaT * (kMmaHd / 8); e += kThreads) {
    const int which = e / (kMmaT * (kMmaHd / 8));
    const int t = (e / (kMmaHd / 8)) % kMmaT, c = (e % (kMmaHd / 8)) * 8;
    const bool ok = t < T_;
    const bf16* src =
        qkv + (row0 + (ok ? t : 0)) * 3 * H + which * H + n * kMmaHd + c;
    port::cp_async16(&tiles[which][t * kMmaLd + c], src, ok);
  }
  port::cp_async_commit();
  port::cp_async_wait<0>();
  __syncthreads();
  const bf16* qs = tiles[0];
  const bf16* ks = tiles[1];
  const bf16* vs = tiles[2];

  // S = q k^T for this warp's 16 rows: 8 key tiles of 8, 4 depth steps of 16
  const int q0 = warp * 16;
  float s[kMmaT / 8][4];
#pragma unroll
  for (int j = 0; j < kMmaT / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kMmaHd; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, &qs[(q0 + (lane & 15)) * kMmaLd + k0 + (lane >> 4) * 8]);
#pragma unroll
    for (int j = 0; j < kMmaT / 8; j += 2) {
      uint32_t kb[4];  // key tiles j and j + 1: (b0, b1) each
      ldmatrix_x4(kb, &ks[(j * 8 + (lane & 7) + ((lane >> 4) << 3)) * kMmaLd +
                          k0 + ((lane >> 3) & 1) * 8]);
      mma_16816(s[j], a, kb[0], kb[1]);
      mma_16816(s[j + 1], a, kb[2], kb[3]);
    }
  }

  // f32 softmax over the T keys; this thread holds rows lane / 4 (values
  // 0, 1 of each tile) and lane / 4 + 8 (values 2, 3), columns
  // 8 j + 2 (lane % 4) (+ 1)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kMmaT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = key < T_ ? s[j][e] * scale : -CUDART_INF_F;
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int j = 0; j < kMmaT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);  // exp(-inf) = 0 past T
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // out = round(P) v: 4 key steps of 16, 8 depth tiles of 8
  float o[kMmaHd / 8][4];
#pragma unroll
  for (int d = 0; d < kMmaHd / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMmaT / 16; ++kk) {
    uint32_t a[4];  // the weights, rounded to bf16 (pack_bf16 rounds)
    a[0] = pack_bf16(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
    a[1] = pack_bf16(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
    a[2] = pack_bf16(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
    a[3] = pack_bf16(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
#pragma unroll
    for (int d = 0; d < kMmaHd / 8; d += 2) {
      uint32_t vb[4];  // depth tiles d and d + 1
      ldmatrix_x4_trans(
          vb, &vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMmaLd +
                  d * 8 + (lane >> 4) * 8]);
      mma_16816(o[d], a, vb[0], vb[1]);
      mma_16816(o[d + 1], a, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + (lane >> 2) + 8 * h;
    if (t >= T_) continue;
    bf16* dst = att + (row0 + t) * H + n * kMmaHd + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < kMmaHd / 8; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          pack_bf16(o[d][2 * h], o[d][2 * h + 1]);
  }
}

// Both kernels wait for the kernel before them themselves (see
// `grid_dependency_wait` in device.cuh) and are launched to match.
template <typename T>
cudaError_t encoder_attention(T* att, const T* qkv, int B, int T_, int H,
                              int NH, float scale, cudaStream_t stream) {
  cudaLaunchAttribute attr = port::dependent_launch_attribute();
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B, NH);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if constexpr (std::is_same<T, port::bf16>::value) {
    if (T_ <= kMmaT && H == NH * kMmaHd)
      return cudaLaunchKernelEx(&config, encoder_attention_mma_kernel, att,
                                qkv, T_, H, scale);
  }
  const size_t smem = attention_smem(T_, H, NH);
  if (smem > 48 * 1024) {
    PORT_TRY(cudaFuncSetAttribute(encoder_attention_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
  }
  config.dynamicSmemBytes = smem;
  return cudaLaunchKernelEx(&config, encoder_attention_kernel<T>, att, qkv,
                            T_, H, NH, scale);
}

template <typename T>
cudaError_t launch(void* out_p, void* scratch, const void* x_p,
                   const void* wqkv_p, const void* bqkv_p, const void* wo_p,
                   const void* bo_p, const float* g1,
                   const float* b1, const float* g2, const float* b2,
                   const void* wfc_p, const void* bfc_p, const void* wpj_p,
                   const void* bpj_p,
                   int L, int B, int T_, int H, int NH, int F, float scale,
                   float eps, cudaStream_t stream) {
  const int M = B * T_;
  const int64_t H2 = (int64_t)H * H, HF = (int64_t)H * F;
  const T* x_in = static_cast<const T*>(x_p);
  T* out = static_cast<T*>(out_p);
  T* h = static_cast<T*>(scratch);     // [M, H]
  T* qkv = h + (int64_t)M * H;         // [M, 3H]
  T* att = qkv + (int64_t)M * 3 * H;   // [M, H]
  T* x1 = att + (int64_t)M * H;        // [M, H]
  T* u = x1 + (int64_t)M * H;          // [M, F]
  const T* wqkv = static_cast<const T*>(wqkv_p);
  const T* bqkv = static_cast<const T*>(bqkv_p);
  const T* wo = static_cast<const T*>(wo_p);
  const T* bo = static_cast<const T*>(bo_p);
  const T* wfc = static_cast<const T*>(wfc_p);
  const T* bfc = static_cast<const T*>(bfc_p);
  const T* wpj = static_cast<const T*>(wpj_p);
  const T* bpj = static_cast<const T*>(bpj_p);

  const T* x = x_in;  // then `out`, rewritten by each layer's last GEMM
  for (int l = 0; l < L; ++l) {
    PORT_TRY(port::layer_norm(h, x, g1 + (int64_t)l * H, b1 + (int64_t)l * H,
                              M, H, eps, stream));
    PORT_TRY(port::dense(qkv, 3 * H, h, H, wqkv + l * 3 * H2, H,
                         bqkv + (int64_t)l * 3 * H, (const T*)nullptr, 0, M,
                         3 * H, H, port::kBias, true, stream));
    PORT_TRY(encoder_attention<T>(att, qkv, B, T_, H, NH, scale, stream));
    PORT_TRY(port::dense(x1, H, att, H, wo + l * H2, H, bo + (int64_t)l * H,
                         x, H, M, H, H, port::kBiasResidual, true, stream));
    PORT_TRY(port::layer_norm(h, x1, g2 + (int64_t)l * H, b2 + (int64_t)l * H,
                              M, H, eps, stream));
    PORT_TRY(port::dense(u, F, h, H, wfc + l * HF, H, bfc + (int64_t)l * F,
                         (const T*)nullptr, 0, M, F, H, port::kBiasQuickGelu,
                         true, stream));
    PORT_TRY(port::dense(out, H, u, F, wpj + l * HF, F, bpj + (int64_t)l * H,
                         x1, H, M, H, F, port::kBiasResidual, true, stream));
    x = out;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16
// (of x, out, scratch and the Dense weights and biases; the LayerNorm
// gamma/beta [L, H] are float32 always). Weights are stacked over layers in
// the nn.Linear layout: wqkv [L, 3H, H], wo [L, H, H], wfc [L, F, H],
// wpj [L, H, F]. scratch holds B * T * (6 H + F) values of the working
// type.
// Returns the first cudaError_t of the launches (0 = success).
extern "C" int encoder_stack(int dtype, int device, void* out, void* scratch,
                             const void* x,
                             const void* wqkv, const void* bqkv,
                             const void* wo, const void* bo, const void* g1,
                             const void* b1, const void* g2, const void* b2,
                             const void* wfc, const void* bfc,
                             const void* wpj, const void* bpj, int L, int B,
                             int T, int H, int NH, int F, float scale,
                             float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(g1);
  const float* c1 = static_cast<const float*>(b1);
  const float* f2 = static_cast<const float*>(g2);
  const float* c2 = static_cast<const float*>(b2);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, scratch, x, wqkv, bqkv, wo, bo, f1, c1,
                                f2, c2, wfc, bfc, wpj, bpj, L,
                                B, T, H, NH, F, scale, eps, s);
  } else if (dtype == 0) {
    err = launch<float>(out, scratch, x, wqkv, bqkv, wo, bo,
                        f1, c1, f2, c2, wfc, bfc, wpj, bpj, L, B, T, H, NH, F,
                        scale, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// One Dense layer by itself, for holding the GEMM of common.cuh against
// its plain version (not a kernel of any model path): C [M, N] =
// epi(round(A . W^T), bias, R) with A [M, K] (row stride lda), W [N, K]
// (ldw), C (ldc), R (ldr; may be null unless epi is kBiasResidual), epi an
// `Epilogue` of common.cuh. dtype as above. Returns the launch's
// cudaError_t.
extern "C" int dense_layer(int dtype, int device, void* c, int ldc,
                           const void* a, int lda, const void* w, int ldw,
                           const void* bias, const void* r, int ldr, int M,
                           int N, int K, int epi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi < port::kBias || epi > port::kBiasResidual) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = port::dense(static_cast<T*>(c), ldc, static_cast<const T*>(a), lda,
                      static_cast<const T*>(w), ldw,
                      static_cast<const T*>(bias), static_cast<const T*>(r),
                      ldr, M, N, K, epi, false, s);
  } else if (dtype == 0) {
    err = port::dense(static_cast<float*>(c), ldc,
                      static_cast<const float*>(a), lda,
                      static_cast<const float*>(w), ldw,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(r), ldr, M, N, K, epi,
                      false, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
// nothing is padded: the GEMMs take M = B * T rows directly (50 x 36
// blocks for the QKV GEMM on the tensor cores; split over K only when a
// small batch gives too few blocks; common.cuh), and the
// attention is one block per (image, head) that stages that head's
// q, k, v (T x 64 each) in shared memory and keeps the T x T scores there,
// so no padded key exists and no padded row is returned. Seven launches
// per layer from one host call (LN1, QKV GEMM, attention, output GEMM +
// residual, LN2, fc1 GEMM + quick_gelu, fc2 GEMM + residual); the
// intermediates live in a scratch buffer of 6 H + F values per row.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One block per (image b, head n) over qkv [B*T, 3H]; writes the head's
// columns of att [B*T, H].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    encoder_attention_kernel(T* __restrict__ att, const T* __restrict__ qkv,
                             int T_, int H, int NH, float scale) {
  extern __shared__ float smem[];
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

template <typename T>
cudaError_t encoder_attention(T* att, const T* qkv, int B, int T_, int H,
                              int NH, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem(T_, H, NH);
  if (smem > 48 * 1024) {
    PORT_TRY(cudaFuncSetAttribute(encoder_attention_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
  }
  encoder_attention_kernel<T><<<dim3(B, NH), kThreads, smem, stream>>>(
      att, qkv, T_, H, NH, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* out_p, void* scratch, float* ws, int64_t ws_floats,
                   const void* x_p, const void* wqkv_p, const void* bqkv_p,
                   const void* wo_p, const void* bo_p, const float* g1,
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
                         3 * H, H, port::kBias, ws, ws_floats, stream));
    PORT_TRY(encoder_attention<T>(att, qkv, B, T_, H, NH, scale, stream));
    PORT_TRY(port::dense(x1, H, att, H, wo + l * H2, H, bo + (int64_t)l * H,
                         x, H, M, H, H, port::kBiasResidual, ws, ws_floats,
                         stream));
    PORT_TRY(port::layer_norm(h, x1, g2 + (int64_t)l * H, b2 + (int64_t)l * H,
                              M, H, eps, stream));
    PORT_TRY(port::dense(u, F, h, H, wfc + l * HF, H, bfc + (int64_t)l * F,
                         (const T*)nullptr, 0, M, F, H, port::kBiasQuickGelu,
                         ws, ws_floats, stream));
    PORT_TRY(port::dense(out, H, u, F, wpj + l * HF, F, bpj + (int64_t)l * H,
                         x1, H, M, H, F, port::kBiasResidual, ws, ws_floats,
                         stream));
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
// type, ws an f32 workspace of ws_floats values for split-K partial sums.
// Returns the first cudaError_t of the launches (0 = success).
extern "C" int encoder_stack(int dtype, int device, void* out, void* scratch,
                             void* ws, int64_t ws_floats, const void* x,
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
  float* wsf = static_cast<float*>(ws);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, scratch, wsf, ws_floats, x, wqkv, bqkv,
                                wo, bo, f1, c1, f2, c2, wfc, bfc, wpj, bpj, L,
                                B, T, H, NH, F, scale, eps, s);
  } else if (dtype == 0) {
    err = launch<float>(out, scratch, wsf, ws_floats, x, wqkv, bqkv, wo, bo,
                        f1, c1, f2, c2, wfc, bfc, wpj, bpj, L, B, T, H, NH, F,
                        scale, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

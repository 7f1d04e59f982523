// Whole-stack GPT-2 decode step: all L decoder layers of one beam-decode
// step over Bk = B * K rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_beam_decode_stack`
// (image_captioning_ml_project_tpu/ops/pallas_decode.py; body
// `_stack_kernel`, launch `_stack_exec`). For each layer l, on the
// residual stream x [Bk, H]:
//   h   = LN1(x)                          flax LayerNorm, f32 gamma/beta
//   qkv = round(h . Wqkv[l]) + bqkv[l]    nn.Dense rounding
//   att = beam attention (prefix[l] + lazy suffix cache[l] + self),
//         appending k/v at `pos` of caches[l] in place
//   x1  = x + (round(att . Wo[l]) + bo[l])
//   u   = gelu_new(round(LN2(x1) . Wfc[l]) + bfc[l])
//   x   = x1 + (round(u . Wpj[l]) + bpj[l])
// and returns the last layer's x (before ln_f). Caches are [L, Bk, S, H];
// the prefix K/V [L, B, P, H].
//
// What bounds it on the card: at Bk = 320 one step multiplies 320 rows
// through 85 M weights (54 GFLOP on 170 MB of bf16 weights: tensor-core
// work, about 320 flops per weight byte), plus the attention's cache reads.
// The Pallas kernel walks a sequential (layer, row-block) grid on one core
// and carries the residual in VMEM. Rows are independent within a step (a
// row reads only cache positions < pos, its image's prefix and its own new
// K/V), so one block could carry a row tile through all L layers, but with
// 320 rows that is 5 blocks of 64 rows on 132 SMs, each re-reading all
// 170 MB of weights. The design instead issues, from one host call, seven
// launches per layer, each sized for occupancy: LN1, the QKV GEMM, the
// attention (a block per image and head; beam_attention.cuh), the output
// GEMM with the residual in its epilogue, LN2, the c_fc GEMM with gelu_new
// in its epilogue, the c_proj GEMM with the residual. GEMMs run on the
// tensor cores (`wgmma` fed by TMA, f32 sums; common.cuh): 320 rows are
// five 64-row tiles with no padding row, whose blocks run at the same time
// and share each weight tile through L2, so a weight byte leaves device
// memory once a step; the three GEMMs over K = 768 are not split, c_proj
// (K = 3072, 30 tiles) is split four ways inside one launch (a cluster per
// tile). So 84 launches a step at L = 12, at any batch, against some 670
// PyTorch operations for the same step on the split path, and one Python
// call. The two LayerNorms
// stay launches of their own (about 3.5 us each on an H100). Inside the
// GEMM that reads them (its 64 rows of A resident in shared memory,
// normalised in place by the consumer warpgroup before the first product)
// they measured slower: 14.9 and 17.8 us a GEMM against 7.0 and 9.3 us
// plus the LayerNorm's 3.6, because no product can start before all of A
// has arrived and four warps have walked sixteen rows each, and every one
// of the 18 to 24 column tiles repeats that. The LayerNorm and GEMM
// launches are programmatic dependent launches (common.cuh): each starts
// under the tail of the one before, sets up and asks for its first weight
// tiles, and only then waits for that kernel's output; the attention too,
// which stages its cache and prefix rows before that wait (see
// beam_attention.cuh for why that is safe). The intermediates live in a
// scratch buffer of 10 H values per row (6 MB at the served shapes), which
// the wrapper keeps from call to call (the GEMM's TMA descriptors are kept
// per operand address); it stays in L2.

#include "beam_attention.cuh"

namespace {

template <typename T>
cudaError_t launch(void* out_p, void* scratch, const void* x_p,
                   const void* wqkv_p, const void* bqkv_p, const void* wo_p,
                   const void* bo_p, const float* g1,
                   const float* b1, const float* g2, const float* b2,
                   const void* wfc_p, const void* bfc_p, const void* wpj_p,
                   const void* bpj_p,
                   void* k_caches, void* v_caches, const void* prefix_k,
                   const void* prefix_v, const void* anc_p, void* anc_err,
                   int L, int Bk, int K, int S, int P, int H, int NH, int pos,
                   float scale, float eps, cudaStream_t stream) {
  const int64_t H2 = (int64_t)H * H;
  const T* x_in = static_cast<const T*>(x_p);
  T* out = static_cast<T*>(out_p);
  T* h = static_cast<T*>(scratch);       // [Bk, H]   LN output
  T* qkv = h + (int64_t)Bk * H;          // [Bk, 3H]
  T* att = qkv + (int64_t)Bk * 3 * H;    // [Bk, H]
  T* x1 = att + (int64_t)Bk * H;         // [Bk, H]   mid-layer residual
  T* u = x1 + (int64_t)Bk * H;           // [Bk, 4H]  MLP hidden
  const T* wqkv = static_cast<const T*>(wqkv_p);
  const T* bqkv = static_cast<const T*>(bqkv_p);
  const T* wo = static_cast<const T*>(wo_p);
  const T* bo = static_cast<const T*>(bo_p);
  const T* wfc = static_cast<const T*>(wfc_p);
  const T* bfc = static_cast<const T*>(bfc_p);
  const T* wpj = static_cast<const T*>(wpj_p);
  const T* bpj = static_cast<const T*>(bpj_p);
  const int32_t* anc = static_cast<const int32_t*>(anc_p);
  const int B = Bk / K;

  // the residual stream: the input for layer 0, then `out`, rewritten by
  // every layer's last GEMM (which reads x1, never `out`)
  const T* x = x_in;
  for (int l = 0; l < L; ++l) {
    const int64_t cache_off = (int64_t)l * Bk * S * H;
    const int64_t pre_off = (int64_t)l * B * P * H;
    PORT_TRY(port::layer_norm(h, x, g1 + (int64_t)l * H, b1 + (int64_t)l * H,
                              Bk, H, eps, stream));
    PORT_TRY(port::dense(qkv, 3 * H, h, H, wqkv + l * 3 * H2, H,
                         bqkv + (int64_t)l * 3 * H, (const T*)nullptr, 0, Bk,
                         3 * H, H, port::kBias, true, stream));
    PORT_TRY(port::beam_attention<T>(
        att, qkv, qkv + H, qkv + 2 * H, 3 * H,
        static_cast<T*>(k_caches) + cache_off,
        static_cast<T*>(v_caches) + cache_off,
        P ? static_cast<const T*>(prefix_k) + pre_off : nullptr,
        P ? static_cast<const T*>(prefix_v) + pre_off : nullptr, anc,
        static_cast<int*>(anc_err), Bk, K, S, P, H, NH, pos, scale, stream));
    PORT_TRY(port::dense(x1, H, att, H, wo + l * H2, H, bo + (int64_t)l * H,
                         x, H, Bk, H, H, port::kBiasResidual, true, stream));
    PORT_TRY(port::layer_norm(h, x1, g2 + (int64_t)l * H, b2 + (int64_t)l * H,
                              Bk, H, eps, stream));
    PORT_TRY(port::dense(u, 4 * H, h, H, wfc + l * 4 * H2, H,
                         bfc + (int64_t)l * 4 * H, (const T*)nullptr, 0, Bk,
                         4 * H, H, port::kBiasGeluNew, true, stream));
    PORT_TRY(port::dense(out, H, u, 4 * H, wpj + l * 4 * H2, 4 * H,
                         bpj + (int64_t)l * H, x1, H, Bk, H, 4 * H,
                         port::kBiasResidual, true, stream));
    x = out;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16
// (of x, the Dense weights and biases, the caches and the prefix; the
// LayerNorm gamma/beta g1, b1, g2, b2 [L, H] are float32 always). scratch
// holds Bk * 10 * H values of the working type. prefix_k/prefix_v may be null
// when P == 0; anc may be null (all zeros); anc_err is the device int that an
// ancestry entry outside [0, K) sets. Returns the first cudaError_t of the
// step's launches (0 = success); cudaErrorInvalidValue (1) where the
// attention's block would need more shared memory than the card offers (the
// caches and `out` are then untouched: only layer 0's LayerNorm and QKV
// GEMM, into scratch, were launched).
extern "C" int beam_decode_stack(
    int dtype, int device, void* out, void* scratch, const void* x,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* g1, const void* b1, const void* g2, const void* b2,
    const void* wfc, const void* bfc, const void* wpj, const void* bpj,
    void* k_caches, void* v_caches, const void* prefix_k,
    const void* prefix_v, const void* anc, void* anc_err, int L, int Bk, int K,
    int S, int P, int H, int NH, int pos, float scale, float eps,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(g1);
  const float* c1 = static_cast<const float*>(b1);
  const float* f2 = static_cast<const float*>(g2);
  const float* c2 = static_cast<const float*>(b2);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, scratch, x, wqkv, bqkv, wo, bo, f1, c1,
                                f2, c2, wfc, bfc, wpj, bpj,
                                k_caches, v_caches, prefix_k, prefix_v, anc,
                                anc_err, L, Bk, K, S, P, H, NH, pos, scale,
                                eps, s);
  } else if (dtype == 0) {
    err = launch<float>(out, scratch, x, wqkv, bqkv, wo, bo,
                        f1, c1, f2, c2, wfc, bfc, wpj, bpj, k_caches,
                        v_caches, prefix_k, prefix_v, anc, anc_err, L, Bk,
                        K, S, P, H, NH, pos, scale, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

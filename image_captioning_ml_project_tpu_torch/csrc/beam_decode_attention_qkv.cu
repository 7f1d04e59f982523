// Folded-QKV beam-decode attention: one GPT-2 layer's attention block for
// one decode step over Bk = B * K beam rows, QKV projection and output
// projection included, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_beam_decode_attention_qkv`
// (image_captioning_ml_project_tpu/ops/pallas_decode.py; launch
// `_folded_exec`, body `_kernel(folded=True)`):
//   qkv = round(x . Wqkv) + bqkv               [Bk, 3H]   (nn.Dense rounding)
//   att = beam attention of (q, k, v) over prefix + lazy suffix + self
//   out = round(att . Wo) + bo                 [Bk, H]
// and appends the step's K/V at `pos` of the [Bk, S, H] caches in place.
//
// What bounds it on the card: at Bk = 320 the two projections are 1.5
// GFLOP on 4.7 MB of bf16 weights (about 320 flops per weight byte, at the
// tensor cores' balance point), and the attention is bound by its cache
// reads (see beam_attention.cuh). The Pallas kernel does all three in one
// grid cell because its grid runs in order on one core; on Hopper one
// block per 64 rows would leave most of the 132 SMs idle. So the design is
// a few launches on the caller's stream, each sized for its own work: the
// QKV GEMM (5 x 18 tiles of 64 x 128 outputs on the tensor cores, `wgmma`
// fed by TMA with f32 sums; see common.cuh), the attention of
// beam_attention.cuh reading q/k/v in place from the GEMM's output (row
// stride 3H, no split copies), and the output GEMM; all three are
// programmatic dependent launches (common.cuh). The intermediates
// (qkv, att) are scratch buffers the wrapper allocates; they stay in L2
// between the launches.

#include "beam_attention.cuh"

namespace {

template <typename T>
cudaError_t launch(void* out, void* qkv_s, void* att_s, const void* x,
                   const void* wqkv, const void* bqkv, const void* wo,
                   const void* bo, void* k_cache, void* v_cache,
                   const void* prefix_k, const void* prefix_v,
                   const void* anc, void* anc_err, int Bk, int K, int S,
                   int P, int H, int NH, int pos, float scale,
                   cudaStream_t stream) {
  T* qkv = static_cast<T*>(qkv_s);
  T* att = static_cast<T*>(att_s);
  PORT_TRY(port::dense(qkv, 3 * H, static_cast<const T*>(x), H,
                       static_cast<const T*>(wqkv), H,
                       static_cast<const T*>(bqkv), (const T*)nullptr, 0, Bk,
                       3 * H, H, port::kBias, true, stream));
  PORT_TRY(port::beam_attention<T>(
      att, qkv, qkv + H, qkv + 2 * H, 3 * H, static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<const T*>(prefix_k),
      static_cast<const T*>(prefix_v), static_cast<const int32_t*>(anc),
      static_cast<int*>(anc_err), Bk, K, S, P, H, NH, pos, scale, stream));
  return port::dense(static_cast<T*>(out), H, att, H,
                     static_cast<const T*>(wo), H, static_cast<const T*>(bo),
                     (const T*)nullptr, 0, Bk, H, H, port::kBias, true, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// qkv_s [Bk, 3H] and att_s [Bk, H] are scratch; prefix_k/prefix_v may be null
// when P == 0; anc may be null (all zeros); anc_err is the device int that an
// ancestry entry outside [0, K) sets. Returns the first cudaError_t of the
// launches (0 = success); cudaErrorInvalidValue (1) where the attention's
// block would need more shared memory than the card offers (the caches are
// then untouched: only the QKV GEMM, into scratch, was launched).
extern "C" int beam_decode_attention_qkv(
    int dtype, int device, void* out, void* qkv_s, void* att_s, const void* x,
    const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, void* k_cache, void* v_cache,
    const void* prefix_k, const void* prefix_v, const void* anc,
    void* anc_err, int Bk, int K, int S, int P, int H, int NH, int pos,
    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, qkv_s, att_s, x, wqkv, bqkv, wo, bo,
                                k_cache, v_cache, prefix_k,
                                prefix_v, anc, anc_err, Bk, K, S, P, H, NH,
                                pos, scale, s);
  } else if (dtype == 0) {
    err = launch<float>(out, qkv_s, att_s, x, wqkv, bqkv, wo, bo, k_cache,
                        v_cache, prefix_k, prefix_v, anc, anc_err, Bk, K,
                        S, P, H, NH, pos, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Beam-decode attention, split form: one GPT-2 layer's decode-step
// attention for Bk = B * K beam rows, with the QKV and output projections
// outside the kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_beam_decode_attention`
// (image_captioning_ml_project_tpu/ops/pallas_decode.py, body `_kernel`).
// The device code, and the note on what bounds it on the card and how the
// design answers, are in beam_attention.cuh, which the folded-QKV and
// whole-stack kernels share.

#include "beam_attention.cuh"

namespace {

template <typename T>
cudaError_t launch(void* out, const void* q, const void* k_new,
                   const void* v_new, void* k_cache, void* v_cache,
                   const void* prefix_k, const void* prefix_v,
                   const void* anc, void* err, int Bk, int K, int S, int P,
                   int H, int NH, int pos, float scale, cudaStream_t stream) {
  return port::beam_attention<T>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), H,
      static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<const T*>(prefix_k), static_cast<const T*>(prefix_v),
      static_cast<const int32_t*>(anc), static_cast<int*>(err), Bk, K, S, P,
      H, NH, pos, scale, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// prefix_k/prefix_v may be null when P == 0; anc may be null (all zeros);
// err is the device int that an ancestry entry outside [0, K) sets.
// Returns the cudaError_t of the launch (0 = success); cudaErrorInvalidValue
// (1), with nothing launched, where one block would need more shared memory
// than the card offers.
extern "C" int beam_decode_attention(
    int dtype, int device, void* out, const void* q, const void* k_new,
    const void* v_new, void* k_cache, void* v_cache, const void* prefix_k,
    const void* prefix_v, const void* anc, void* anc_err, int Bk, int K,
    int S, int P, int H, int NH, int pos, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(out, q, k_new, v_new, k_cache, v_cache,
                                prefix_k, prefix_v, anc, anc_err, Bk, K, S, P,
                                H, NH, pos, scale, s);
  } else if (dtype == 0) {
    err = launch<float>(out, q, k_new, v_new, k_cache, v_cache, prefix_k,
                        prefix_v, anc, anc_err, Bk, K, S, P, H, NH, pos, scale,
                        s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
// projection reads. The keys and values belong to the image, not the beam:
// all the image's K x Q query rows are served from one staging of them.
//
// What bounds it on the card: device memory in principle (64 images x 5
// beams, 49 keys, 8 heads of 64 in bf16 read 6.4 MB of keys and values,
// 1.9 us at 3.35 TB/s, against 8 MFLOP), and in practice a chain of
// dependent steps: at the served shapes every block is resident in one
// wave, so the time is one block's path from its first load to its last
// store, and every instruction on that path counts. The first version
// (kept below as the CUDA-core path) ran it through three block-wide
// barriers, a warp reduction of five dependent shuffles per (row, key)
// score and a 49-term chain of shared-memory FMAs per output.
//
// bf16 (the served path; `tc` below) runs on the tensor cores, one warp per
// (image, head), a block each:
// - One round of loads. The first 16 query rows go straight into
//   registers as the A fragments of the scores (4-byte loads) and the mask
//   row into two bytes a lane; then the head's key and value rows land in
//   the warp's shared memory by 16-byte cp.async (keys and values in two
//   groups, the values awaited only before the mix), padded there and only
//   there to whole 16-key steps with zero rows, so that no stale NaN meets
//   a zero weight. Nothing waits for a load until all are asked for.
// - Scores [16, hd] x [hd, 16 KS] by `mma.sync` m16n8k16 (f32 sums of exact
//   bf16 products), the key rows as staged being the col-major B operand
//   (`ldmatrix`). The K x Q query rows are the rows of 16-row tiles.
// - The softmax on the accumulators: a lane holds two rows' values; the
//   row max and sum are over the quad of lanes that share a row (two
//   shuffles each). Padded key columns take no part in the max or the sum
//   and get weight 0: an image whose keys are all masked gets weights 1/S
//   over its real keys, as the plain version does (the Pallas kernel pads
//   the keys to 128 lanes as masked keys, and its weights there sum to
//   S / 128). The order is the plain version's: `__fmul_rn` by the scale,
//   the mask, `expf` of the max-subtracted score, the quotient by the sum
//   (a correctly rounded reciprocal and one fma correction step: within an
//   ulp of `__fdiv_rn`, without its branch per quotient).
// - The f32 weights are stored from registers, and the same registers,
//   rounded to bf16, are the A fragments of the mix [16, 16 KS] x [16 KS,
//   hd], the value rows read by `ldmatrix.trans`. No score touches shared
//   memory and no barrier wider than the warp separates the phases.
// The kernel is compiled for each head width and count of 16-key steps, so
// that its loops have fixed counts and its softmax no branch (the padded
// columns are left out by selects): a version with a branch per key tile
// and per quotient spent most of its path on the exps and the divisions.
// Tried on the card and dropped, as no faster or slower: two, four and
// eight warps (heads of one image) a block; a programmatic dependent
// launch; a TMA bulk copy per key and value row (slow to issue at 128
// bytes a copy); the query rows by cp.async and ldmatrix in place of the
// 4-byte loads into registers.
//
// float32 (the reference configuration) and shapes the tensor-core path
// does not take (a head width not a multiple of 16 or above 128, more than
// 64 keys, more than 64 query rows per image) run on the CUDA cores in the
// first version's kernel. The C entry chooses from the dtype and the shape
// alone and reports the route it launched.

#include <mutex>
#include <unordered_map>

#include "device.cuh"

namespace {

constexpr float kMasked = -1e9f;
constexpr int kMaxDevices = 64;

// Opt `kernel` in to `smem` bytes of dynamic shared memory on `device`,
// once for each larger size (the attribute call is a driver round trip).
// Fails (cudaErrorInvalidValue) where the block needs more than the card
// offers. One record per kernel.
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

// ---------------------------------------------------------------------------
// The CUDA-core path (the first version): one block per (head, image, chunk
// of up to 32 query rows) stages the head's key and value rows [S, hd] in
// shared memory with cp.async in 16-byte chunks (value by value where a row
// is not 16-byte whole), the values landing while the scores are taken.
// Scores are one warp per (row, key) pair, the lanes across the head
// dimension; the softmax one warp per row; in the mix each thread owns one
// (row, head dim) output.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // query rows per block

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

template <typename T>
cudaError_t launch(int device, void* ctx, float* weights, const void* q,
                   const void* k, const void* v, const void* mask, int B,
                   int K, int Q, int S, int NH, int hd, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const size_t smem = sdpa_smem<T>(S, hd);
  PORT_TRY(opt_in_smem(sdpa_kernel<T>, device, smem));
  const dim3 grid(NH, B, (K * Q + kRows - 1) / kRows);
  sdpa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(ctx), weights, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), K, Q, S, NH, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the served path): one warp per (image, head),
// a block each. A lane holds rows g = lane / 4 and g + 8 of a 16-row tile,
// columns 2 (lane % 4) and 2 (lane % 4) + 1 of each 8-column tile: the
// accumulator layout of m16n8k16, which for two adjacent column tiles is
// the A layout of the next product. The kernel is compiled for each head
// width HD and each count KS of 16-key steps, so that every loop has a
// fixed count and no branch: the keys past S are padded columns, left out
// of the softmax by selects.
// ---------------------------------------------------------------------------
namespace tc {

using port::bf16;

constexpr int kMaxKeys = 64;       // four 16-key steps
constexpr int kMaxRows = 64;       // query rows of an image: 4 row tiles
constexpr int kMaxHeadDim = 128;   // 8 depth steps of 16

struct Args {
  bf16* ctx;
  float* weights;
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;
  int K, Q, S, NH;
  int64_t sq[3], sk[3], sv[3];  // (row, head, position) / (image, head, key)
  float scale;
  bool kv16;  // k and v rows (and their strides) are 16-byte whole
  bool q4;    // q's values pair up in aligned 4-byte words
};

// Shared memory of one warp: 16 KS key rows, then as many value rows, of
// HD + 8 values (16 mod 128 bytes: ldmatrix without bank conflicts).
inline size_t warp_smem(int HD, int KS) {
  return sizeof(bf16) * (size_t)2 * 16 * KS * (HD + 8);
}

// Rows [0, S) of a head's keys or values into shared memory and rows
// [S, 16 KS) zero, so that no stale NaN meets a zero weight: 16-byte
// cp.async where the rows and their stride are 16-byte whole, else value by
// value.
template <int HD, int KS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      int64_t stride, int S, int lane,
                                      bool v16) {
  constexpr int LD = HD + 8, C = HD / 8;
  if (v16) {
#pragma unroll
    for (int it = 0; it < 16 * KS * C / 32; ++it) {
      const int i = lane + 32 * it, j = i / C, c = i % C;
      bf16* d = dst + j * LD + 8 * c;
      if (j < S)
        port::cp_async16(d, src + j * stride + 8 * c, true);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = lane; i < 16 * KS * HD; i += 32) {
      const int j = i / HD, d = i % HD;
      dst[j * LD + d] = j < S ? src[j * stride + d] : __float2bfloat16_rn(0.f);
    }
  }
}

// The A fragments of row tile `mt` of the image's queries, every depth
// step, straight from device memory into registers (a lane's values pair up
// in 4-byte words); `real[h]` says whether the lane's row g + 8 h is one of
// the image's K x Q. The other rows read the image's first row, so that no
// load sits behind a branch, and are zeroed by `zero_padding_rows` once
// every load of the kernel's first round has been asked for.
template <int HD>
__device__ __forceinline__ void load_queries(uint32_t (&qa)[HD / 16][4],
                                             bool (&real)[2], const Args& a,
                                             int b, int n, int mt, int lane) {
  const bf16* row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 16 * mt + (lane >> 2) + 8 * h;
    real[h] = t < a.K * a.Q;
    const int tt = real[h] ? t : 0;
    row[h] = a.q + ((int64_t)b * a.K + tt / a.Q) * a.sq[0] + n * a.sq[1] +
             (tt % a.Q) * a.sq[2] + 2 * (lane & 3);
  }
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bf16* p = row[r & 1] + 16 * ks + 8 * (r >> 1);
      if (a.q4) {
        qa[ks][r] = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
        qa[ks][r] = static_cast<uint32_t>(__ldg(h)) |
                    static_cast<uint32_t>(__ldg(h + 1)) << 16;
      }
    }
  }
}

template <int HD>
__device__ __forceinline__ void zero_padding_rows(uint32_t (&qa)[HD / 16][4],
                                                  const bool (&real)[2]) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) qa[ks][r] = real[r & 1] ? qa[ks][r] : 0u;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, int KS>
__global__ void __launch_bounds__(32) sdpa_mma_kernel(Args a) {
  constexpr int LD = HD + 8, NT = 2 * KS;  // NT 8-key column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x / a.NH, n = blockIdx.x % a.NH;
  const int S = a.S, rows = a.K * a.Q;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + 16 * KS * LD;

  // One round of loads: the first row tile's queries (into registers) and
  // the mask row, then the keys and the values (their own cp.async group);
  // nothing waits for any of them until all are asked for.
  uint32_t qa[HD / 16][4];
  bool real_row[2];
  load_queries<HD>(qa, real_row, a, b, n, 0, lane);
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * S : nullptr;
  const uint8_t m_lo = mrow != nullptr && lane < S ? mrow[lane] : 0;
  const uint8_t m_hi = mrow != nullptr && lane + 32 < S ? mrow[lane + 32] : 0;
  stage<HD, KS>(ks, a.k + b * a.sk[0] + n * a.sk[1], a.sk[2], S, lane,
                a.kv16);
  port::cp_async_commit();
  stage<HD, KS>(vs, a.v + b * a.sv[0] + n * a.sv[1], a.sv[2], S, lane,
                a.kv16);
  port::cp_async_commit();
  zero_padding_rows<HD>(qa, real_row);
  // bit j of `masked`: key j is masked; of `real`: key j exists. Shifted
  // to this lane's first column, c0, bit 8 nt + e is column 8 nt + c0 + e.
  const int c0 = 2 * (lane & 3);
  const uint64_t masked =
      (__ballot_sync(0xffffffffu, m_lo != 0) |
       static_cast<uint64_t>(__ballot_sync(0xffffffffu, m_hi != 0)) << 32) >>
      c0;
  const uint64_t real = (S >= 64 ? ~0ull : (1ull << S) - 1) >> c0;
  port::cp_async_wait<1>();  // this lane's key copies have landed
  __syncwarp();              // and every lane's, and the padding rows

  for (int mt = 0;;) {
    // scores: depth steps outer (the A fragments by constant index), key
    // tiles in pairs by one ldmatrix.x4
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kb[4];
        port::ldmatrix_x4(kb, ks + (8 * nt + (lane & 7) + 8 * (lane >> 4)) *
                                       LD +
                                   16 * kk + 8 * ((lane >> 3) & 1));
        port::mma_16816(s[nt], qa[kk], kb[0], kb[1]);
        port::mma_16816(s[nt + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // the f32 softmax of rows g (values 0, 1) and g + 8 (values 2, 3) over
    // the S real keys, by selects: the padded columns take no part in the
    // max or the sum and get weight 0
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 8 * nt + (e & 1);
        const float x = (masked >> bit) & 1 ? kMasked
                                            : __fmul_rn(s[nt][e], a.scale);
        s[nt][e] = x;
        mx[e >> 1] = (real >> bit) & 1 ? fmaxf(mx[e >> 1], x) : mx[e >> 1];
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(__fsub_rn(s[nt][e], mx[e >> 1]));
        s[nt][e] = (real >> (8 * nt + (e & 1))) & 1 ? x : 0.f;
        sum[e >> 1] += s[nt][e];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    // w = e / sum: the correctly rounded reciprocal of the row's sum (in
    // [1, S]), then each quotient refined by one step on its exact fma
    // residual, without the per-quotient branch of a division
    const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e], d = sum[e >> 1], r = inv[e >> 1];
        const float q0 = __fmul_rn(x, r);
        s[nt][e] = __fmaf_rn(__fmaf_rn(-d, q0, x), r, q0);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * mt + (lane >> 2) + 8 * h;
      if (t >= rows) continue;
      const int64_t r = (int64_t)b * a.K + t / a.Q;
      float* wrow = a.weights + ((r * a.NH + n) * a.Q + t % a.Q) * S + c0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if ((real >> (8 * nt + e)) & 1) wrow[8 * nt + e] = s[nt][2 * h + e];
    }

    // the mix: the weights, rounded to bf16, as A; value rows by
    // ldmatrix.trans, two depth tiles at a time
    port::cp_async_wait<0>();  // this lane's value copies have landed
    __syncwarp();
    float o[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t pa[4] = {
          port::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          port::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          port::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          port::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t vb[4];
        port::ldmatrix_x4_trans(
            vb, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * d + 8 * (lane >> 4));
        port::mma_16816(o[d], pa, vb[0], vb[1]);
        port::mma_16816(o[d + 1], pa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * mt + (lane >> 2) + 8 * h;
      if (t >= rows) continue;
      const int64_t r = (int64_t)b * a.K + t / a.Q;
      bf16* dst = a.ctx + ((r * a.Q + t % a.Q) * a.NH + n) * HD + c0;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(dst + 8 * d) =
            port::pack_bf16(o[d][2 * h], o[d][2 * h + 1]);
    }
    if (++mt * 16 >= rows) break;
    load_queries<HD>(qa, real_row, a, b, n, mt, lane);
    zero_padding_rows<HD>(qa, real_row);
  }
}

// The shapes this path takes: bf16, a head width a multiple of 16 up to
// 128, at most 64 keys and 64 query rows an image.
inline bool takes(int dtype, int K, int Q, int S, int hd) {
  return dtype == 1 && hd % 16 == 0 && hd <= kMaxHeadDim && S <= kMaxKeys &&
         K * Q <= kMaxRows;
}

// A block's shared memory is at most 2 x 64 rows of 136 values (34 KB),
// inside the 48 KB a launch may take without opting in.
template <int HD, int KS>
cudaError_t launch_shape(const Args& a, int B, cudaStream_t stream) {
  sdpa_mma_kernel<HD, KS><<<B * a.NH, 32, warp_smem(HD, KS), stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int B, cudaStream_t stream) {
  switch ((a.S + 15) / 16) {
    case 1: return launch_shape<HD, 1>(a, B, stream);
    case 2: return launch_shape<HD, 2>(a, B, stream);
    case 3: return launch_shape<HD, 3>(a, B, stream);
    case 4: return launch_shape<HD, 4>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch(void* ctx, float* weights, const void* q, const void* k,
                   const void* v, const void* mask, int B, int K, int Q,
                   int S, int NH, int hd, const int64_t* st, float scale,
                   cudaStream_t stream) {
  Args a;
  a.ctx = static_cast<bf16*>(ctx);
  a.weights = weights;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.K = K;
  a.Q = Q;
  a.S = S;
  a.NH = NH;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i];
    a.sk[i] = st[3 + i];
    a.sv[i] = st[6 + i];
  }
  a.scale = scale;
  auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  a.kv16 = aligned(k, 16) && aligned(v, 16);
  for (int i = 0; i < 3; ++i)
    a.kv16 = a.kv16 && (2 * a.sk[i]) % 16 == 0 && (2 * a.sv[i]) % 16 == 0;
  a.q4 = aligned(q, 4) && a.sq[0] % 2 == 0 && a.sq[1] % 2 == 0 &&
         a.sq[2] % 2 == 0;
  switch (hd / 16) {
    case 1: return launch_hd<16>(a, B, stream);
    case 2: return launch_hd<32>(a, B, stream);
    case 3: return launch_hd<48>(a, B, stream);
    case 4: return launch_hd<64>(a, B, stream);
    case 5: return launch_hd<80>(a, B, stream);
    case 6: return launch_hd<96>(a, B, stream);
    case 7: return launch_hd<112>(a, B, stream);
    case 8: return launch_hd<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// The route codes of `sdpa`'s `route` argument.
enum SdpaRoute { kCudaCores = 0, kTensorCores = 1 };

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q holds B*K rows of [NH, Q, hd], k and v B images of [NH, S, hd], each
// read through `strides` (in elements: q's row, head and position strides,
// then k's and v's image, head and key-row strides; the head dimension is
// contiguous). ctx is [B*K, Q, NH, hd], weights [B*K, NH, Q, S] f32; mask
// is a [B, S] byte array (nonzero = masked) or null. The route is chosen
// from the dtype and the shape alone: bf16 with hd a multiple of 16 up to
// 128, S <= 64 and K*Q <= 64 on the tensor cores, the rest on the CUDA
// cores; `route` (if not null) receives the one launched (SdpaRoute).
// Returns the cudaError_t of the launch (0 = success); cudaErrorInvalidValue
// (1) where one block would need more shared memory than the card offers.
extern "C" int sdpa(int dtype, int device, void* ctx, void* weights,
                    const void* q, const void* k, const void* v,
                    const void* mask, int B, int K, int Q, int S, int NH,
                    int hd, const int64_t* strides, float scale,
                    void* stream, int* route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(weights);
  const bool tensor = tc::takes(dtype, K, Q, S, hd);
  if (route != nullptr) *route = tensor ? kTensorCores : kCudaCores;
  if (tensor) {
    err = tc::launch(ctx, w, q, k, v, mask, B, K, Q, S, NH, hd, strides,
                     scale, s);
  } else if (dtype == 1) {
    err = simt::launch<__nv_bfloat16>(device, ctx, w, q, k, v, mask, B, K, Q,
                                      S, NH, hd, strides, scale, s);
  } else if (dtype == 0) {
    err = simt::launch<float>(device, ctx, w, q, k, v, mask, B, K, Q, S, NH,
                              hd, strides, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

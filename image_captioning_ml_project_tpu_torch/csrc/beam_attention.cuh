// Beam-decode attention: one GPT-2 or Transformer-decoder layer's attention
// for one decode step over Bk = B * K beam rows. Device code shared by the
// split kernel (beam_decode_attention.cu), the folded-QKV kernel
// (beam_decode_attention_qkv.cu) and the whole-stack kernel
// (beam_decode_stack.cu); it replaces the body `_kernel` of the Pallas TPU
// kernels in image_captioning_ml_project_tpu/ops/pallas_decode.py.
//
// Row r (image b = r / K) attends, per head, over
//   * the suffix cache at positions t < pos, read from the image-local beam
//     row b*K + anc[r, t] (lazy beam ancestry: the cache is never permuted);
//   * the image's shared prefix K/V [B, P, H] (absent when P == 0, the
//     prefix-free mode);
//   * this step's own key and value.
// Score products are taken in f32 (bf16 * bf16 is exact in f32), the
// softmax is f32, each weight is rounded to the value dtype before the f32
// mix of V, and the mix is rounded to the output dtype. Row r's new K/V row
// is then written into the caches at `pos`, in place. An ancestry entry
// outside [0, K) is a caller's fault: it sets the error word `err` and its
// position is left out of that row's attention; nothing outside the
// image's K rows is read.
//
// What bounds it on the card: device memory, and the latency of a short
// launch. At B = 64, K = 5, 12 heads of 64, pos 19 and a 10-row prefix a
// layer reads the distinct cache rows that the ancestry selects (the K
// beams of an image mostly share ancestors), the prefix once per image and
// the step's rows: about 18 MB in bf16, 5.3 us at 3.35 TB/s; the
// arithmetic is 4 flops per head dim of each (row, position), 29 MFLOP,
// nothing for the CUDA cores. So the design moves each byte once and keeps
// every SM busy:
//   * One block per (image, head) serves all K beam rows of the image
//     (768 blocks at B = 64, not one per row: 3,840 blocks that each
//     re-read their image's prefix and shared ancestor rows through L2).
//     Where that grid is small (B = 1 gives 12 blocks), an image's beams
//     are split over up to K blocks (`plan_beam_attention`).
//   * Each (position, source row) pair that the block's beams select is
//     staged into shared memory once, by the first beam that selects it;
//     the others read that copy. Keys, then values, stream through in
//     chunks of positions with 16-byte cp.async into a double buffer, so
//     the copy of the next chunk lands while the current one is scored or
//     mixed, and shared memory stays bounded whatever S and P are.
//   * Every thread works in every phase: scores as (beam, position) dots
//     of eight lanes each, 16-byte reads; the softmax one warp per beam;
//     the mix as (beam, 16-byte column pack, position subset) outputs whose
//     partial sums are added in a fixed order (deterministic).
//   * The launch is a programmatic dependent launch (common.cuh). Before
//     `grid_dependency_wait` a block reads only what no launch of the
//     current host call writes: the ancestry, the prefix and cache
//     positions < pos. For #1 (split) and #2 (folded QKV) the host call
//     launches this kernel once per layer, after PyTorch operations (which
//     never release a dependent launch early) or after the call's own QKV
//     GEMM, which writes only its qkv scratch. For #3 (whole stack) the
//     kernels of the call before this one write only scratch and the other
//     layers' caches (each at `pos`); the ancestry, the prefix and cache
//     positions < pos were written by earlier host calls, between which
//     PyTorch operations ran in plain stream order. q / k_new / v_new (the
//     QKV GEMM's output under #2 and #3) are read only after the wait.
//
// The in-place append needs no grid-wide order: a block writes only its own
// rows' head slice at position `pos`, and every block reads cache positions
// t < pos only, so no block reads what another block writes.

#pragma once

#include "common.cuh"

namespace port {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnTeam = 8;    // lanes per score dot
constexpr int kAttnChunk = 32;  // positions per staged chunk, at most
constexpr int kAttnMaxSplit = 8;  // position subsets per mix output, at most
// Below this many (image, head) blocks an image's beams are split over
// several blocks (about two blocks per SM).
constexpr int kAttnMinBlocks = 264;
constexpr size_t kAttnMaxSmem = 232448;  // what one block may opt in to

// The values of one load: a 16-byte pack (kVec) or one value.
template <typename T, bool kVec>
struct AttnPack {
  static constexpr int W = kVec ? 16 / sizeof(T) : 1;
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_pack(
    const T* p, float (&v)[AttnPack<T, kVec>::W]) {
  if constexpr (kVec) {
    unpack_chunk(*reinterpret_cast<const uint4*>(p), v);
  } else {
    v[0] = to_f32(*p);
  }
}

// Sum over the kAttnTeam lanes of a team (all 32 lanes take part).
__device__ __forceinline__ float team_sum(float v) {
  for (int o = kAttnTeam / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How a launch is cut: G beams per block, C positions per staged chunk, JS
// position subsets per mix output, and the block's dynamic shared memory,
// laid out as the offsets below (T first, then f32 and int).
struct AttnPlan {
  int G, C, JS;
  size_t rows, w, acc, slot, anc, smem;
};

inline AttnPlan attn_layout(int G, int C, int JS, int hd, int ntok,
                            size_t item) {
  AttnPlan p;
  p.G = G, p.C = C, p.JS = JS;
  p.rows = round16(2 * (size_t)C * G * hd * item);  // T [2][C][G][hd] stages
  p.w = p.rows + round16(3 * (size_t)G * hd * item);  // T [3][G][hd] q, k, v
  p.acc = p.w + round16(sizeof(float) * G * ntok);    // f32 [G][ntok] weights
  p.slot = p.acc + round16(sizeof(float) * JS * G * hd);  // [JS][G][hd] mix
  p.anc = p.slot + round16(sizeof(int) * G * (ntok - 1));  // [ntok-1][G]
  p.smem = p.anc + round16(sizeof(int) * G * (ntok - 1));  // [G][ntok-1]
  return p;
}

// The beams per block, the chunk and the mix split for one launch: all K
// beams of an image in one block where the grid fills the card, else the
// beams split over up to K blocks. The chunk is halved until every block
// of the grid is resident at once (an SM holds 228 KB of shared memory,
// 1 KB of it reserved per block), or to one position; then the beams are
// made fewer until a block fits at all. G = 0: it does not.
inline AttnPlan plan_beam_attention(int B, int K, int P, int hd, int NH,
                                    int pos, size_t item, bool vec) {
  const int ntok = pos + P + 1;
  const int npk = vec ? hd / (int)(16 / item) : hd;
  int groups = 1;
  while (groups < K && (int64_t)B * NH * groups < kAttnMinBlocks) ++groups;
  int G = (K + groups - 1) / groups;
  const int64_t blocks = (int64_t)B * NH * ((K + G - 1) / G);
  const int64_t per_sm = (blocks + gemm_bf16::kSMs - 1) / gemm_bf16::kSMs;
  const size_t resident =
      per_sm > 1 ? (size_t)(233472 / per_sm - 1024) : kAttnMaxSmem;
  int C = std::max(1, std::min(kAttnChunk, ntok - 1));
  for (;;) {
    const int JS =
        std::max(1, std::min(kAttnMaxSplit, kAttnThreads / (G * npk)));
    const AttnPlan p = attn_layout(G, C, JS, hd, ntok, item);
    if (p.smem <= std::min(resident, kAttnMaxSmem)) return p;
    if (C > 1) {
      C = (C + 1) / 2;
    } else if (p.smem <= kAttnMaxSmem) {
      return p;
    } else if (G > 1) {
      --G;
    } else {
      AttnPlan none = p;
      none.G = 0;
      return none;
    }
  }
}

// Copy one pack of T values (16 bytes, or one value).
template <typename T, bool kVec>
__device__ __forceinline__ void copy_pack(T* dst, const T* src) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    *dst = *src;
  }
}

// q/k_new/v_new are [Bk, *] with row stride ldn (H for separate tensors,
// 3H for the three column blocks of a QKV projection); out is [Bk, H].
// Grid: x = image * (blocks per image) + beam group, y = head.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kAttnThreads) beam_attention_kernel(
    T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, int ldn, T* k_cache, T* v_cache,
    const T* __restrict__ prefix_k, const T* __restrict__ prefix_v,
    const int32_t* __restrict__ anc, int* __restrict__ err, int K, int S,
    int P, int H, int NH, int pos, float scale, AttnPlan plan) {
  constexpr int W = AttnPack<T, kVec>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = plan.G, C = plan.C, JS = plan.JS;
  const int hd = H / NH;
  const int npk = hd / W;          // packs per head row
  const int ntok = pos + P + 1;    // suffix positions < pos, prefix, self
  const int nst = ntok - 1;        // the staged ones: suffix and prefix
  const int nchunks = (nst + C - 1) / C;
  const int groups = (K + G - 1) / G;
  const int b = blockIdx.x / groups;             // image
  const int k0 = (blockIdx.x % groups) * G;      // first beam of the block
  const int nb = min(G, K - k0);                 // beams of the block
  const int r0 = b * K + k0;                     // their first row
  const int col = blockIdx.y * hd;               // the head's first lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = lane / kAttnTeam, tl = lane % kAttnTeam;
  constexpr int kTeams = kAttnThreads / kAttnTeam;

  T* buf = reinterpret_cast<T*>(smem);
  T* rows_s = reinterpret_cast<T*>(smem + plan.rows);  // q, k_new, v_new
  float* w_s = reinterpret_cast<float*>(smem + plan.w);
  float* acc_s = reinterpret_cast<float*>(smem + plan.acc);
  // per (staged position, beam): >= 0 the beam stages the row of that
  // image-local source beam; -1 the position is left out (bad ancestry);
  // <= -2 the beam reads the row staged by beam -v - 2
  int* slot_s = reinterpret_cast<int*>(smem + plan.slot);
  int* anc_s = reinterpret_cast<int*>(smem + plan.anc);  // [G][nst]

  launch_dependents();
  // the block's ancestry rows: every load in flight at once
  for (int p = tid; p < nb * pos; p += kAttnThreads)
    anc_s[(p / pos) * nst + p % pos] =
        anc ? anc[(int64_t)(r0 + p / pos) * S + p % pos] : 0;
  for (int p = tid; p < JS * G * hd; p += kAttnThreads) acc_s[p] = 0.f;
  __syncthreads();
  for (int p = tid; p < nst * nb; p += kAttnThreads) {
    const int g = p / nst, j = p % nst;
    int v;
    if (j >= pos) {
      v = g == 0 ? 0 : -2;  // prefix: beam 0 stages it for all
    } else {
      const int c = anc_s[g * nst + j];
      if (c < 0 || c >= K) {
        atomicOr(err, 1);
        v = -1;
      } else {
        v = c;
        for (int h = 0; h < g; ++h) {
          if (anc_s[h * nst + j] == c) {
            v = -2 - h;
            break;
          }
        }
      }
    }
    slot_s[j * G + g] = v;
  }
  __syncthreads();

  // Stage s: the keys of chunk s (s < nchunks), then the values of chunk
  // s - nchunks, into buffer s % 2; each thread commits its copies as one
  // cp.async group (empty past the last stage).
  auto stage = [&](int s) {
    if (s < 2 * nchunks) {
      const bool values = s >= nchunks;
      const T* cache = values ? v_cache : k_cache;
      const T* prefix = values ? prefix_v : prefix_k;
      const int j0 = (values ? s - nchunks : s) * C;
      const int nj = min(C, nst - j0);
      T* dst = buf + (size_t)(s & 1) * C * G * hd;
      for (int p = tid; p < nj * nb * npk; p += kAttnThreads) {
        const int e = p % npk, slot = p / npk;
        const int jl = slot / nb, g = slot % nb, j = j0 + jl;
        const int v = slot_s[j * G + g];
        if (v < 0) continue;
        const T* src =
            j < pos ? cache + ((int64_t)(b * K + v) * S + j) * H + col
                    : prefix + ((int64_t)b * P + (j - pos)) * H + col;
        T* d = dst + ((size_t)jl * G + g) * hd + e * W;
        if constexpr (kVec) {
          cp_async16(d, src + e * W, true);
        } else {
          *d = src[e];
        }
      }
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);

  // q, k_new, v_new: the kernel before's output (#2, #3), read after the
  // wait; one pack per thread, every load in flight at once
  grid_dependency_wait();
  for (int p = tid; p < 3 * nb * npk; p += kAttnThreads) {
    const int which = p / (nb * npk), g = p / npk % nb, e = p % npk;
    const T* src = which == 0 ? q : which == 1 ? k_new : v_new;
    copy_pack<T, kVec>(rows_s + ((size_t)which * G + g) * hd + e * W,
                       src + (int64_t)(r0 + g) * ldn + col + e * W);
  }
  __syncthreads();

  // scores: a team of eight lanes per (beam, position), 16-byte reads
  auto dot = [&](const T* qr, const T* kr) {
    float acc = 0.f;
    for (int e = tl; e < npk; e += kAttnTeam) {
      float qv[W], kv[W];
      load_pack<T, kVec>(qr + e * W, qv);
      load_pack<T, kVec>(kr + e * W, kv);
#pragma unroll
      for (int i = 0; i < W; ++i) acc += qv[i] * kv[i];
    }
    return team_sum(acc);
  };
  int s = 0;
  for (int c = 0; c < nchunks; ++c, ++s) {
    cp_async_wait<1>();  // this thread's copies of stage s have landed
    __syncthreads();
    const T* cur = buf + (size_t)(s & 1) * C * G * hd;
    const int j0 = c * C, npairs = min(C, nst - j0) * nb;
    for (int base = warp * (32 / kAttnTeam); base < npairs; base += kTeams) {
      const int p = base + team;
      const int g = p % nb, jl = p / nb;
      const int v = p < npairs ? slot_s[(j0 + jl) * G + g] : -1;
      const float acc =
          dot(rows_s + (size_t)g * hd,
              v == -1 ? rows_s
                      : cur + ((size_t)jl * G + (v >= 0 ? g : -v - 2)) * hd);
      if (p < npairs && tl == 0)
        w_s[g * ntok + j0 + jl] = v == -1 ? -CUDART_INF_F : acc * scale;
    }
    __syncthreads();  // buffer s % 2 is free
    stage(s + 2);
  }
  // the step's own key
  for (int base = warp * (32 / kAttnTeam); base < nb; base += kTeams) {
    const int g = min(base + team, nb - 1);
    const float acc = dot(rows_s + (size_t)g * hd,
                          rows_s + ((size_t)G + g) * hd);
    if (base + team < nb && tl == 0) w_s[g * ntok + nst] = acc * scale;
  }
  __syncthreads();

  // f32 softmax over [suffix; prefix; self], one warp per beam; weights in
  // the value dtype
  for (int g = warp; g < nb; g += kAttnWarps) {
    float* row = w_s + g * ntok;
    float m = -CUDART_INF_F;
    for (int j = lane; j < ntok; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < ntok; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < ntok; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
  __syncthreads();

  // f32 mix of V: thread task (subset js, beam g, pack e) sums positions
  // js, js + JS, ... of each chunk into its own slot of acc_s
  for (int c = 0; c < nchunks; ++c, ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const T* cur = buf + (size_t)(s & 1) * C * G * hd;
    const int j0 = c * C, nj = min(C, nst - j0);
    for (int t = tid; t < JS * nb * npk; t += kAttnThreads) {
      const int e = t % npk, g = (t / npk) % nb, js = t / (npk * nb);
      float a[W] = {};
#pragma unroll 2
      for (int jl = js; jl < nj; jl += JS) {
        const int v = slot_s[(j0 + jl) * G + g];
        if (v == -1) continue;
        const float w = w_s[g * ntok + j0 + jl];
        float vv[W];
        load_pack<T, kVec>(
            cur + ((size_t)jl * G + (v >= 0 ? g : -v - 2)) * hd + e * W, vv);
#pragma unroll
        for (int i = 0; i < W; ++i) a[i] += w * vv[i];
      }
      float* dst = acc_s + ((size_t)js * G + g) * hd + e * W;
#pragma unroll
      for (int i = 0; i < W; ++i) dst[i] += a[i];
    }
    __syncthreads();
    stage(s + 2);
  }
  cp_async_wait<0>();

  // the subsets in order, then the step's own value; the append at `pos`
  for (int t = tid; t < nb * npk; t += kAttnThreads) {
    const int g = t / npk, e = t % npk;
    const int64_t r = r0 + g;
    const T* kn = rows_s + ((size_t)G + g) * hd + e * W;
    const T* vn = rows_s + ((size_t)2 * G + g) * hd + e * W;
    float a[W] = {}, vv[W];
    for (int js = 0; js < JS; ++js) {
      const float* src = acc_s + ((size_t)js * G + g) * hd + e * W;
#pragma unroll
      for (int i = 0; i < W; ++i) a[i] += src[i];
    }
    load_pack<T, kVec>(vn, vv);
    const float w = w_s[g * ntok + nst];
    alignas(16) T o[W];
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = from_f32<T>(a[i] + w * vv[i]);
    copy_pack<T, kVec>(out + r * H + col + e * W, o);
    const int64_t dst = (r * S + pos) * H + col + e * W;
    copy_pack<T, kVec>(k_cache + dst, kn);
    copy_pack<T, kVec>(v_cache + dst, vn);
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device, once for each larger size (`static`: each library that includes
// this header opts its own copy of the kernel in).
template <typename T, bool kVec>
static cudaError_t attn_opt_in(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t opted[kMaxDevices] = {};
  static std::mutex mu;
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  PORT_TRY(cudaGetDevice(&device));
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= opted[device]) return cudaSuccess;
  const auto kernel = beam_attention_kernel<T, kVec>;
  PORT_TRY(cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem)));
  opted[device] = smem;
  return cudaSuccess;
}

template <typename T, bool kVec>
static cudaError_t launch_beam_attention(
    const AttnPlan& plan, int B, T* out, const T* q, const T* k_new,
    const T* v_new, int ldn, T* k_cache, T* v_cache, const T* prefix_k,
    const T* prefix_v, const int32_t* anc, int* err, int K, int S, int P,
    int H, int NH, int pos, float scale, cudaStream_t stream) {
  const cudaError_t opted = attn_opt_in<T, kVec>(plan.smem);
  if (opted != cudaSuccess) return opted;
  cudaLaunchAttribute attr = dependent_launch_attribute();
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * ((K + plan.G - 1) / plan.G), NH);
  config.blockDim = dim3(kAttnThreads);
  config.dynamicSmemBytes = plan.smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, beam_attention_kernel<T, kVec>, out, q,
                            k_new, v_new, ldn, k_cache, v_cache, prefix_k,
                            prefix_v, anc, err, K, S, P, H, NH, pos, scale,
                            plan);
}

// One layer's decode-step attention; `err` is the device word that an
// out-of-range ancestry entry sets. 16-byte packs wherever the head width
// and every row start allow them, else one value at a time. Returns
// cudaErrorInvalidValue, and launches nothing, where no block of the plan
// fits the card's shared memory.
template <typename T>
cudaError_t beam_attention(T* out, const T* q, const T* k_new, const T* v_new,
                           int ldn, T* k_cache, T* v_cache, const T* prefix_k,
                           const T* prefix_v, const int32_t* anc, int* err,
                           int Bk, int K, int S, int P, int H, int NH, int pos,
                           float scale, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int hd = H / NH;
  const bool vec = hd % W == 0 && ldn % W == 0 && aligned16(out) &&
                   aligned16(q) && aligned16(k_new) && aligned16(v_new) &&
                   aligned16(k_cache) && aligned16(v_cache) &&
                   (P == 0 || (aligned16(prefix_k) && aligned16(prefix_v)));
  const int B = Bk / K;
  const AttnPlan plan =
      plan_beam_attention(B, K, P, hd, NH, pos, sizeof(T), vec);
  if (plan.G == 0) return cudaErrorInvalidValue;
  if (vec)
    return launch_beam_attention<T, true>(plan, B, out, q, k_new, v_new, ldn,
                                          k_cache, v_cache, prefix_k,
                                          prefix_v, anc, err, K, S, P, H, NH,
                                          pos, scale, stream);
  return launch_beam_attention<T, false>(plan, B, out, q, k_new, v_new, ldn,
                                         k_cache, v_cache, prefix_k, prefix_v,
                                         anc, err, K, S, P, H, NH, pos, scale,
                                         stream);
}

}  // namespace port

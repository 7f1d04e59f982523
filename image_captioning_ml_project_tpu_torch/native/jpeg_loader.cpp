// Native host-side JPEG decode + transform for the port's input pipeline:
// a copy of the JAX package's native/jpeg_loader.cpp (same algorithm, so
// both libraries give byte-identical images), built by native/loader.py
// into the port's own _build/ directory.
//
// libjpeg(-turbo) decode with DCT-domain scaling ("draft" mode), a
// PIL-semantics antialiased separable bilinear resize, and a batch API that
// fans work across std::thread workers inside ONE process (no fork, no
// pickling, GIL released for the whole batch). The Python side binds via
// ctypes (native/loader.py) and falls back to PIL when the toolchain is
// absent.
//
// Transforms mirror data/coco.py exactly:
//   * eval:   resize shorter side -> `size` (antialiased bilinear,
//             PIL BILINEAR semantics) + center crop  (center_crop_resize)
//   * train:  crop box (x,y,w,h) -> resize (size,size) + optional flip
//             (random_resized_crop; the box itself is drawn in Python so
//             the seeded-RNG sample sequence is unchanged)
//   * square: DCT-scaled decode-only onto a fixed canvas (the JAX
//             package's device-resident resize path; not yet used by the
//             port)
//
// Error handling: every entry point returns >= 0 on success and a negative
// errno-style code on failure; batch APIs record per-item status so one
// corrupt JPEG cannot take down an epoch.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------------
// libjpeg decode (with optional DCT-domain scaling)
// ---------------------------------------------------------------------------

struct JLErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jl_error_exit(j_common_ptr cinfo) {
  JLErr* err = reinterpret_cast<JLErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jl_emit_message(j_common_ptr, int) {}  // silence warnings

struct Decoded {
  std::vector<uint8_t> pix;  // RGB, h*w*3
  int w = 0, h = 0;
};

// Decode `buf` to RGB. If target > 0, use libjpeg scale_num/scale_denom to
// decode at the largest 1/2^k scale whose shorter side is still >= target
// (identical pixel result to PIL's Image.draft("RGB", (target, target))).
int decode_rgb(const uint8_t* buf, size_t len, int target, Decoded* out) {
  jpeg_decompress_struct cinfo;
  JLErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jl_error_exit;
  jerr.mgr.emit_message = jl_emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  if (target > 0) {
    const int shorter = std::min<int>(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && (shorter + (2 * denom) - 1) / (2 * denom) >= target)
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  cinfo.dct_method = JDCT_ISLOW;  // what PIL uses by default
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->pix.resize(static_cast<size_t>(out->w) * out->h * 3);
  const size_t stride = static_cast<size_t>(out->w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->pix.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// PIL-semantics antialiased bilinear resize (separable triangle filter)
// ---------------------------------------------------------------------------
//
// PIL's BILINEAR resampling uses a triangle filter whose support scales
// with the downscale factor (antialiasing), taps clipped to the source
// range and renormalized — the same formulation as ops/resize.py on the
// device side. Accumulation here is f32 with round-half-away like PIL's
// fixed-point rounding; agreement with PIL is within ~1 LSB
// (tests/test_native_loader.py).

struct Taps {
  std::vector<float> w;    // [out, max_taps]
  std::vector<int> first;  // [out]
  std::vector<int> count;  // [out] — valid taps (bounds the source reads)
  int ntaps = 0;
};

Taps make_taps(int src, int dst, int src_off) {
  Taps t;
  const double scale = static_cast<double>(src) / dst;
  const double support = std::max(scale, 1.0);
  t.ntaps = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.w.assign(static_cast<size_t>(dst) * t.ntaps, 0.0f);
  t.first.assign(dst, 0);
  t.count.assign(dst, 0);
  for (int o = 0; o < dst; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::ceil(center + support - 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, src - 1);
    t.first[o] = lo + src_off;
    t.count[o] = std::min(hi - lo + 1, t.ntaps);
    double sum = 0.0;
    std::vector<double> raw(hi - lo + 1);
    for (int i = lo; i <= hi; ++i) {
      const double x = std::abs((i + 0.5 - center) / support);
      raw[i - lo] = std::max(0.0, 1.0 - x);
      sum += raw[i - lo];
    }
    if (sum <= 0.0) sum = 1.0;
    for (int i = lo; i <= hi && i - lo < t.ntaps; ++i)
      t.w[static_cast<size_t>(o) * t.ntaps + (i - lo)] =
          static_cast<float>(raw[i - lo] / sum);
  }
  return t;
}

// Resize the (sx, sy, sw, sh) sub-rectangle of src (w x h RGB) to
// dw x dh into dst. Horizontal pass first (into f32), then a vertical pass
// written as row-wise saxpy over contiguous dw*3 floats (vectorizes).
void resize_rect(const uint8_t* src, int w, int /*h*/, int sx, int sy, int sw,
                 int sh, uint8_t* dst, int dw, int dh) {
  const Taps tx = make_taps(sw, dw, sx);
  const Taps ty = make_taps(sh, dh, sy);
  // horizontal: [sh, dw, 3] f32 (rows still source rows sy..sy+sh)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int r = 0; r < sh; ++r) {
    const uint8_t* row = src + (static_cast<size_t>(sy + r) * w) * 3;
    float* trow = tmp.data() + static_cast<size_t>(r) * dw * 3;
    for (int o = 0; o < dw; ++o) {
      const float* wv = tx.w.data() + static_cast<size_t>(o) * tx.ntaps;
      const uint8_t* p = row + static_cast<size_t>(tx.first[o]) * 3;
      const int nk = tx.count[o];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      for (int k = 0; k < nk; ++k, p += 3) {
        const float wk = wv[k];
        acc0 += wk * p[0];
        acc1 += wk * p[1];
        acc2 += wk * p[2];
      }
      trow[o * 3 + 0] = acc0;
      trow[o * 3 + 1] = acc1;
      trow[o * 3 + 2] = acc2;
    }
  }
  // vertical: accumulate whole output rows (saxpy), then round+clamp once
  const int rowf = dw * 3;
  std::vector<float> accrow(rowf);
  for (int o = 0; o < dh; ++o) {
    const float* wv = ty.w.data() + static_cast<size_t>(o) * ty.ntaps;
    const int f = ty.first[o] - sy;  // tmp rows are sy-relative
    std::memset(accrow.data(), 0, sizeof(float) * rowf);
    const int nk = ty.count[o];
    for (int k = 0; k < nk; ++k) {
      const float wk = wv[k];
      const float* trow = tmp.data() + static_cast<size_t>(f + k) * rowf;
      float* acc = accrow.data();
      for (int c = 0; c < rowf; ++c) acc[c] += wk * trow[c];
    }
    uint8_t* drow = dst + static_cast<size_t>(o) * rowf;
    for (int c = 0; c < rowf; ++c) {
      const int v = static_cast<int>(accrow[c] + 0.5f);
      drow[c] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
    }
  }
}

// ---------------------------------------------------------------------------
// Transforms (mirror data/coco.py)
// ---------------------------------------------------------------------------

// eval: resize shorter side to `size` + center crop (center_crop_resize,
// data/coco.py:76-87). `draft_target > 0` enables DCT-scaled decode with
// the decoded shorter side guaranteed >= draft_target; callers pass `size`
// for maximum speed (the DCT scaling is itself a proper resampling filter,
// so antialias quality holds) or larger for more resize headroom, or 0 for
// the PIL-parity full decode.
int eval_one(const uint8_t* buf, size_t len, int size, int draft_target,
             uint8_t* out) {
  Decoded d;
  const int rc = decode_rgb(buf, len, draft_target, &d);
  if (rc != 0) return rc;
  if (d.w <= 0 || d.h <= 0) return -3;
  const double scale = static_cast<double>(size) / std::min(d.w, d.h);
  // nearbyint under the default FE_TONEAREST mode rounds half-to-even,
  // matching Python round() in the PIL path (center_crop_resize) — lround
  // would round 248.5 up and shift the center crop by a column
  const int rw = std::max(size, static_cast<int>(std::nearbyint(d.w * scale)));
  const int rh = std::max(size, static_cast<int>(std::nearbyint(d.h * scale)));
  std::vector<uint8_t> resized(static_cast<size_t>(rw) * rh * 3);
  resize_rect(d.pix.data(), d.w, d.h, 0, 0, d.w, d.h, resized.data(), rw, rh);
  const int top = (rh - size) / 2, left = (rw - size) / 2;
  for (int r = 0; r < size; ++r)
    std::memcpy(out + static_cast<size_t>(r) * size * 3,
                resized.data() + (static_cast<size_t>(top + r) * rw + left) * 3,
                static_cast<size_t>(size) * 3);
  return 0;
}

// train: crop (x,y,w,h) -> resize (size,size) -> optional horizontal flip
// (random_resized_crop, data/coco.py:57-73; the box is drawn in Python).
int train_one(const uint8_t* buf, size_t len, int x, int y, int w, int h,
              int size, int flip, uint8_t* out) {
  Decoded d;
  const int rc = decode_rgb(buf, len, 0, &d);
  if (rc != 0) return rc;
  if (x < 0 || y < 0 || w <= 0 || h <= 0 || x + w > d.w || y + h > d.h)
    return -4;
  resize_rect(d.pix.data(), d.w, d.h, x, y, w, h, out, size, size);
  if (flip) {
    for (int r = 0; r < size; ++r) {
      uint8_t* row = out + static_cast<size_t>(r) * size * 3;
      for (int a = 0, b = size - 1; a < b; ++a, --b)
        for (int c = 0; c < 3; ++c) std::swap(row[a * 3 + c], row[b * 3 + c]);
    }
  }
  return 0;
}

// square: DCT-scaled decode-only + center-square crop onto a fixed canvas
// (load_image_square, data/coco.py:103-133). Returns the square side.
int square_one(const uint8_t* buf, size_t len, int target, int canvas,
               uint8_t* out) {
  Decoded d;
  const int rc = decode_rgb(buf, len, target, &d);
  if (rc != 0) return rc;
  int side = std::min(d.w, d.h);
  const int top = (d.h - side) / 2, left = (d.w - side) / 2;
  std::memset(out, 0, static_cast<size_t>(canvas) * canvas * 3);
  if (side > canvas) {
    // extreme input (decode floor is 1/8): host downscale to the canvas
    resize_rect(d.pix.data(), d.w, d.h, left, top, side, side, out, canvas,
                canvas);
    return canvas;
  }
  for (int r = 0; r < side; ++r)
    std::memcpy(out + static_cast<size_t>(r) * canvas * 3,
                d.pix.data() + (static_cast<size_t>(top + r) * d.w + left) * 3,
                static_cast<size_t>(side) * 3);
  return side;
}

// ---------------------------------------------------------------------------
// Batch driver: N items over a transient std::thread pool (atomic cursor)
// ---------------------------------------------------------------------------

// Exception fence: a hostile header can declare e.g. 65500x65500 and make
// the pixel vectors throw bad_alloc/length_error. Uncaught, that would
// std::terminate inside a worker thread (or unwind through the extern "C"
// boundary) and kill the process — the per-item status contract above
// promises a negative code instead.
template <typename Fn>
int guarded(Fn&& fn) noexcept {
  try {
    return fn();
  } catch (...) {
    return -5;  // allocation/driver failure for this item only
  }
}

template <typename Fn>
void run_batch(int n, int n_threads, Fn&& fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> cursor(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t)
    pool.emplace_back([&] {
      for (int i = cursor.fetch_add(1); i < n; i = cursor.fetch_add(1)) fn(i);
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int icl_version() { return 1; }

// Probe: decode header only; returns 0 and fills w/h on success.
int icl_probe(const uint8_t* buf, size_t len, int* w, int* h) {
  Decoded d;  // decode at max scale-down just to validate cheaply
  jpeg_decompress_struct cinfo;
  JLErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jl_error_exit;
  jerr.mgr.emit_message = jl_emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  (void)d;
  return 0;
}

// Batch eval transform: out is [n, size, size, 3] uint8; status[i] = 0 ok.
// draft_target: 0 = full decode (PIL parity); > 0 = DCT-scaled decode with
// shorter side kept >= draft_target.
void icl_eval_batch(const uint8_t** bufs, const size_t* lens, int n, int size,
                    int draft_target, uint8_t* out, int* status,
                    int n_threads) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  run_batch(n, n_threads, [&](int i) {
    status[i] = guarded([&] {
      return eval_one(bufs[i], lens[i], size, draft_target, out + item * i);
    });
  });
}

// Batch train transform: boxes is [n, 4] (x, y, w, h), flips is [n].
void icl_train_batch(const uint8_t** bufs, const size_t* lens, int n,
                     const int* boxes, const int* flips, int size,
                     uint8_t* out, int* status, int n_threads) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  run_batch(n, n_threads, [&](int i) {
    status[i] = guarded([&] {
      return train_one(bufs[i], lens[i], boxes[i * 4 + 0], boxes[i * 4 + 1],
                       boxes[i * 4 + 2], boxes[i * 4 + 3], size, flips[i],
                       out + item * i);
    });
  });
}

// Batch square (device_resize) path: out is [n, canvas, canvas, 3];
// sides[i] = decoded square side (>0) or a negative error code.
void icl_square_batch(const uint8_t** bufs, const size_t* lens, int n,
                      int target, int canvas, uint8_t* out, int* sides,
                      int n_threads) {
  const size_t item = static_cast<size_t>(canvas) * canvas * 3;
  run_batch(n, n_threads, [&](int i) {
    sides[i] = guarded([&] {
      return square_one(bufs[i], lens[i], target, canvas, out + item * i);
    });
  });
}

}  // extern "C"

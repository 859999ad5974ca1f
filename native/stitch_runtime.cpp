// stitch_runtime: native host-side runtime for imagestitch_tpu.
//
// Counterpart of the reference's native layer.  The reference used
// C++/CUDA for feature math and a numpy<->cv::Mat bridge (reference:
// appendix/myGpuFeatures.cpp, appendix/conversion.cpp); here the feature
// math lives in XLA, so the native layer's job moves to the host runtime:
// a multithreaded JPEG decode/prefetch pipeline feeding contiguous uint8
// batches (the device-transfer boundary), and memcpy-grade
// canvas composition primitives.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: make -C native   ->  native/libstitch_runtime.so (the loader,
// io/native_loader.py, builds into native/build/<key>/ itself)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#ifndef ISR_NO_JPEG
#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg), error-resumable.  Built with -DISR_NO_JPEG where
// libjpeg's headers are missing: every decode then fails (rc 2) and the
// Python side decodes instead; the composition kernels are unaffected.
// ---------------------------------------------------------------------------
#ifdef ISR_NO_JPEG
int decode_jpeg_file(const char*, int, uint8_t*, int, int, int*, int*) {
  return 2;
}
#else
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file.  color: 0 = grayscale, 1 = BGR.
// Returns 0 on success; fills rows into out (stride = w * channels).
// When expect_h/expect_w are nonzero the decoded dims must match.
int decode_jpeg_file(const char* path, int color, uint8_t* out, int expect_h,
                     int expect_w, int* got_h, int* got_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = color ? JCS_EXT_BGR : JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int ch = cinfo.output_components;
  if (got_h) *got_h = h;
  if (got_w) *got_w = w;
  if ((expect_h && h != expect_h) || (expect_w && w != expect_w)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  if (out != nullptr) {
    const size_t stride = static_cast<size_t>(w) * ch;
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + stride * cinfo.output_scanline;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
  } else {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}
#endif  // ISR_NO_JPEG

}  // namespace

extern "C" {

// 1 when built with libjpeg (isr_probe / isr_load_batch can decode).
int isr_has_jpeg() {
#ifdef ISR_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

// Probe image dimensions without decoding pixel data.
int isr_probe(const char* path, int* h, int* w) {
  return decode_jpeg_file(path, 0, nullptr, 0, 0, h, w);
}

// Decode a batch of same-sized JPEGs into a contiguous (n, h, w[, 3]) uint8
// buffer with `threads` worker threads.  color: 0 gray, 1 BGR.
// Returns 0 on success, else the 1-based index of the first failing file.
int isr_load_batch(const char** paths, int n, int color, uint8_t* out, int h,
                   int w, int threads) {
  const size_t frame = static_cast<size_t>(h) * w * (color ? 3 : 1);
  std::atomic<int> failed{0};
  std::atomic<int> next{0};
  if (threads < 1) threads = 1;
  {
    ThreadPool pool(threads);
    std::atomic<int> done{0};
    std::mutex mu;
    std::condition_variable cv;
    for (int t = 0; t < threads; ++t) {
      pool.submit([&] {
        for (;;) {
          int i = next.fetch_add(1);
          if (i >= n || failed.load() != 0) break;
          int rc = decode_jpeg_file(paths[i], color, out + frame * i, h, w,
                                    nullptr, nullptr);
          if (rc != 0) {
            int expected = 0;
            failed.compare_exchange_strong(expected, i + 1);
          }
        }
        {
          std::lock_guard<std::mutex> lk(mu);
          done.fetch_add(1);
        }
        cv.notify_one();
      });
    }
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return done.load() == threads; });
  }
  return failed.load();
}

// BGR (h, w, 3) -> grayscale (h, w) with OpenCV's integer-rounding weights.
void isr_bgr_to_gray(const uint8_t* bgr, uint8_t* gray, int h, int w) {
  const size_t n = static_cast<size_t>(h) * w;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
    // fixed-point 0.114/0.587/0.299 (cv2's CCIR 601), round-half-up
    gray[i] = static_cast<uint8_t>(
        (1868u * b + 9617u * g + 4899u * r + 8192u) >> 14);
  }
}

// Paste img (h, w, c) into canvas (H, W, c) at (r0, c0): row-wise memcpy.
void isr_paste(uint8_t* canvas, int H, int W, int c, const uint8_t* img,
               int h, int w, int r0, int c0) {
  const size_t row_bytes = static_cast<size_t>(w) * c;
  const size_t canvas_stride = static_cast<size_t>(W) * c;
  for (int r = 0; r < h; ++r) {
    std::memcpy(canvas + (static_cast<size_t>(r0 + r)) * canvas_stride +
                    static_cast<size_t>(c0) * c,
                img + static_cast<size_t>(r) * row_bytes, row_bytes);
  }
}

// Blend a fusion rect in double precision — the reference's arithmetic
// (ImageFusion.py:241-243 promotes through float64).  Weight matrices are
// separable products of per-row / per-col factor vectors:
//   mode 0: wa = war[i]*wac[j],      wb = wbr[i]*wbc[j]   (plain fade)
//   mode 1: wb = wbr[i]*wbc[j],      wa = 1 - wb          (corner fade)
//   mode 2: base = war[i]*wac[j],    wa = sin^2(base*pi/2), wb = 1-wa
//   mode 3: base = 1 - wbr[i]*wbc[j], wa = sin^2(base*pi/2), wb = 1-wa
// a = canvas rect BEFORE the paste (int16, -1 sentinels), b = after the
// paste; out = uint8 fused rect.  A's invalid pixels take B's value before
// blending (Stitcher.py:498/ImageFusion.py:240); result = clip + truncate.
void isr_blend_rect(const int16_t* a, const int16_t* b, uint8_t* out,
                    int h, int w, int c,
                    const double* war, const double* wac,
                    const double* wbr, const double* wbc,
                    int mode, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  auto run_rows = [=](int r0, int r1) {
    const double half_pi = 1.5707963267948966;  // pi/2
    for (int i = r0; i < r1; ++i) {
      const int16_t* ar = a + static_cast<size_t>(i) * w * c;
      const int16_t* br = b + static_cast<size_t>(i) * w * c;
      uint8_t* orow = out + static_cast<size_t>(i) * w * c;
      for (int j = 0; j < w; ++j) {
        double wa, wb;
        switch (mode) {
          case 0:
            wa = war[i] * wac[j];
            wb = wbr[i] * wbc[j];
            break;
          case 1:
            wb = wbr[i] * wbc[j];
            wa = 1.0 - wb;
            break;
          case 2: {
            double s = std::sin(war[i] * wac[j] * half_pi);
            wa = s * s;
            wb = 1.0 - wa;
            break;
          }
          default: {
            double s = std::sin((1.0 - wbr[i] * wbc[j]) * half_pi);
            wa = s * s;
            wb = 1.0 - wa;
            break;
          }
        }
        for (int k = 0; k < c; ++k) {
          double av = ar[j * c + k];
          double bv = br[j * c + k];
          if (av < 0) av = bv;
          double res = wa * av + wb * bv;
          if (res < 0) res = 0;
          if (res > 255) res = 255;
          orow[j * c + k] = static_cast<uint8_t>(res);
        }
      }
    }
  };
  if (n_threads == 1 || h < 64) {
    run_rows(0, h);
    return;
  }
  std::vector<std::thread> ts;
  int per = (h + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int r0 = t * per, r1 = std::min(h, r0 + per);
    if (r0 >= r1) break;
    ts.emplace_back(run_rows, r0, r1);
  }
  for (auto& t : ts) t.join();
}

// Paste a uint8 frame into an int16 canvas (widening copy).
void isr_paste16(int16_t* canvas, int H, int W, int c, const uint8_t* img,
                 int h, int w, int r0, int c0, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  auto run_rows = [=](int a, int b) {
    const size_t row_elems = static_cast<size_t>(w) * c;
    const size_t canvas_stride = static_cast<size_t>(W) * c;
    for (int r = a; r < b; ++r) {
      int16_t* dst = canvas + (static_cast<size_t>(r0 + r)) * canvas_stride +
                     static_cast<size_t>(c0) * c;
      const uint8_t* src = img + static_cast<size_t>(r) * row_elems;
      for (size_t k = 0; k < row_elems; ++k) dst[k] = src[k];
    }
  };
  if (n_threads == 1 || h < 256) {
    run_rows(0, h);
    return;
  }
  std::vector<std::thread> ts;
  int per = (h + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int a = t * per, b = std::min(h, a + per);
    if (a >= b) break;
    ts.emplace_back(run_rows, a, b);
  }
  for (auto& t : ts) t.join();
}

// One-pass fusion-rect statistics over the PRE-PASTE canvas content:
//   quad_pos[4]  — elements > 0 per quadrant (ul, ll, lr, ur order of
//                  ImageFusion.py:56-62's cmp list)
//   first_v/last_v[rw] — per-column first/last row with a VALID pixel
//                  (gray: != -1; color: channel sum != -3), -1 when none
//   n_pos_elems  — elements > -1 (the valid_frac numerator)
void isr_rect_stats(const int16_t* canvas, int W, int c,
                    int rr, int rc, int rh, int rw,
                    long long* quad_pos, int* first_v, int* last_v,
                    long long* n_pos_elems) {
  for (int j = 0; j < rw; ++j) { first_v[j] = -1; last_v[j] = -1; }
  for (int q = 0; q < 4; ++q) quad_pos[q] = 0;
  long long npos = 0;
  const int half_r = rh / 2, half_c = rw / 2;
  const size_t stride = static_cast<size_t>(W) * c;
  for (int i = 0; i < rh; ++i) {
    const int16_t* row =
        canvas + (static_cast<size_t>(rr + i)) * stride +
        static_cast<size_t>(rc) * c;
    const bool upper = i < half_r;
    long long ql = 0, qr = 0;
    for (int j = 0; j < rw; ++j) {
      int sum = 0;
      long long pos = 0;
      for (int k = 0; k < c; ++k) {
        int v = row[j * c + k];
        sum += v;
        if (v > 0) ++pos;
        if (v > -1) ++npos;
      }
      if (j < half_c) ql += pos; else qr += pos;
      const bool valid = (c == 1) ? (sum != -1) : (sum != -3);
      if (valid) {
        if (first_v[j] < 0) first_v[j] = i;
        last_v[j] = i;
      }
    }
    if (upper) { quad_pos[0] += ql; quad_pos[3] += qr; }
    else       { quad_pos[1] += ql; quad_pos[2] += qr; }
  }
  *n_pos_elems = npos;
}

// One full fusion step on the int16 canvas, in place:
//   1. fused rect computed in float64 from (pre-paste canvas, post-paste
//      content) — the post-paste value is frame where the frame covers the
//      pixel, else the canvas value; A-invalid pixels take the post value
//   2. frame pasted (widening)
//   3. fused rect written back
// Weight modes as in isr_blend_rect.
void isr_fuse_step(int16_t* canvas, int H, int W, int c,
                   const uint8_t* frame, int fh, int fw, int fr, int fc,
                   int rr, int rc, int rh, int rw,
                   const double* war, const double* wac,
                   const double* wbr, const double* wbc,
                   int mode, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  std::vector<uint8_t> fused(static_cast<size_t>(rh) * rw * c);
  const size_t stride = static_cast<size_t>(W) * c;
  const double half_pi = 1.5707963267948966;
  auto fuse_rows = [&](int a, int b) {
    for (int i = a; i < b; ++i) {
      const int gi = rr + i;                     // canvas row
      const int16_t* crow = canvas + static_cast<size_t>(gi) * stride;
      uint8_t* orow = fused.data() + static_cast<size_t>(i) * rw * c;
      const bool in_fr = (gi >= fr && gi < fr + fh);
      const uint8_t* frow = in_fr ?
          frame + static_cast<size_t>(gi - fr) * fw * c : nullptr;
      for (int j = 0; j < rw; ++j) {
        double wa, wb;
        switch (mode) {
          case 0: wa = war[i] * wac[j]; wb = wbr[i] * wbc[j]; break;
          case 1: wb = wbr[i] * wbc[j]; wa = 1.0 - wb; break;
          case 2: {
            double s = std::sin(war[i] * wac[j] * half_pi);
            wa = s * s; wb = 1.0 - wa; break;
          }
          default: {
            double s = std::sin((1.0 - wbr[i] * wbc[j]) * half_pi);
            wa = s * s; wb = 1.0 - wa; break;
          }
        }
        const int gj = rc + j;
        const bool in_f = in_fr && gj >= fc && gj < fc + fw;
        for (int k = 0; k < c; ++k) {
          const double av = crow[static_cast<size_t>(gj) * c + k];
          const double bv = in_f ?
              static_cast<double>(frow[static_cast<size_t>(gj - fc) * c + k])
              : av;
          double a2 = av < 0 ? bv : av;
          double res = wa * a2 + wb * bv;
          if (res < 0) res = 0;
          if (res > 255) res = 255;
          orow[j * c + k] = static_cast<uint8_t>(res);
        }
      }
    }
  };
  {
    std::vector<std::thread> ts;
    int per = (rh + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int a = t * per, b = std::min(rh, a + per);
      if (a >= b) break;
      ts.emplace_back(fuse_rows, a, b);
    }
    for (auto& t : ts) t.join();
  }
  isr_paste16(canvas, H, W, c, frame, fh, fw, fr, fc, n_threads);
  // write the fused rect back (int16 widening)
  auto write_rows = [&](int a, int b) {
    for (int i = a; i < b; ++i) {
      int16_t* dst = canvas + (static_cast<size_t>(rr + i)) * stride +
                     static_cast<size_t>(rc) * c;
      const uint8_t* src = fused.data() + static_cast<size_t>(i) * rw * c;
      for (size_t k = 0; k < static_cast<size_t>(rw) * c; ++k)
        dst[k] = src[k];
    }
  };
  std::vector<std::thread> ts;
  int per = (rh + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int a = t * per, b = std::min(rh, a + per);
    if (a >= b) break;
    ts.emplace_back(write_rows, a, b);
  }
  for (auto& t : ts) t.join();
}

// Fill an int16 buffer with a constant (threaded; the -1 canvas init).
void isr_fill16(int16_t* buf, long long n, int16_t value, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  auto run = [=](long long a, long long b) {
    std::fill(buf + a, buf + b, value);
  };
  std::vector<std::thread> ts;
  long long per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long long a = t * per, b = std::min(n, a + per);
    if (a >= b) break;
    ts.emplace_back(run, a, b);
  }
  for (auto& t : ts) t.join();
}

// Finalize: -1 sentinel -> 0, narrow int16 canvas to uint8
// (Stitcher.py:485-486), threaded single pass.
void isr_finalize16(const int16_t* canvas, uint8_t* out, long long n,
                    int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  auto run = [=](long long a, long long b) {
    for (long long k = a; k < b; ++k) {
      int16_t v = canvas[k];
      out[k] = v < 0 ? 0 : static_cast<uint8_t>(v);
    }
  };
  std::vector<std::thread> ts;
  long long per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long long a = t * per, b = std::min(n, a + per);
    if (a >= b) break;
    ts.emplace_back(run, a, b);
  }
  for (auto& t : ts) t.join();
}

// Version tag for the ctypes wrapper's sanity check.
int isr_version() { return 3; }

}  // extern "C"

// First-party JPEG decode worker pool (C++, libjpeg).
//
// Host-side replacement for the reference's DataLoader worker processes
// (train.py:190-196) and our PIL thread pool: a fixed pool of C++ threads,
// each with a persistent libjpeg decompressor, decoding straight into a
// caller-provided batch buffer (no per-image Python object churn, no GIL
// involvement at all during decode).
//
// Capabilities:
//   * jpeg_dims(path)                      -> header-only (h, w) probe
//   * pool_decode(paths, n, H, W, out)     -> decode + bilinear resize each
//     image to exactly (H, W) RGB uint8 rows into out[n*H*W*3]
//   * pool_decode_crop(paths, boxes, ...)  -> per-image crop box
//     (y, x, h, w) applied before the resize — the host computes
//     RandomResizedCrop / CenterCrop geometry from jpeg_dims and the pool
//     does decode+crop+resize in one native pass.
//
// C ABI (ctypes-friendly); libjpeg scale_num/scale_denom is used to decode
// at the smallest scale that still covers the requested output (IDCT-level
// downscale: up to 8x less decode work for large photos -> small targets).
// With libjpeg-turbo the full M/8 fractional ladder (1/8..8/8) is used —
// e.g. a 420px eval crop -> 224 target decodes at 5/8 (263px), ~2.5x less
// IDCT + color-conversion work than the next power of two (1/1) — exactly
// PIL's draft-mode trick, but per-crop. Plain libjpeg falls back to the
// 1/1, 1/2, 1/4, 1/8 ladder. The horizontal training flip can also be
// folded into the resize output write (mirrored column stores, zero extra
// passes) via the per-image `flips` array.
// When the system libjpeg is libjpeg-turbo (jpeg_crop_scanline /
// jpeg_skip_scanlines available), cropped decodes also skip the rows above/
// below the crop and restrict columns to the iMCU-aligned crop window —
// entropy decode still walks every row's bitstream, but the IDCT + color
// conversion (the majority of the per-pixel cost) runs only on the region
// the caller keeps. For the standard eval crop (center 87.5%) that is
// ~30-40% less decode work per image; decode is the binding serving stage
// on few-core hosts, so this lifts images-in->answers-out qps directly.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode `path`, crop (cy,cx,ch,cw) in ORIGINAL image coordinates (ch/cw<=0
// means whole image), bilinear-resize the crop to (out_h, out_w) RGB uint8;
// `flip` mirrors the output horizontally during the resize write (free).
// Returns 0 on success.
int decode_one(const char* path, int cy, int cx, int ch, int cw, int out_h,
               int out_w, int flip, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = err_exit;
  std::vector<uint8_t> img;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  const int full_h = cinfo.image_height, full_w = cinfo.image_width;
  if (ch <= 0 || cw <= 0) {
    cy = cx = 0;
    ch = full_h;
    cw = full_w;
  }
  cy = std::max(0, std::min(cy, full_h - 1));
  cx = std::max(0, std::min(cx, full_w - 1));
  ch = std::max(1, std::min(ch, full_h - cy));
  cw = std::max(1, std::min(cw, full_w - cx));

  // IDCT-level downscale: smallest scale such that the scaled crop still
  // covers the output (keeps bilinear a downscale, not an upscale).
  // libjpeg-turbo decodes any M/8, M in 1..8 (smaller IDCT kernels: the
  // per-pixel IDCT + color-conversion cost tracks the SCALED pixel count);
  // plain libjpeg only the power-of-two subset.
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  int num = 8;
  for (int m = 1; m < 8; ++m) {
    // ceil(ch*m/8) >= out_h and likewise for width.
    if ((ch * m + 7) / 8 >= out_h && (cw * m + 7) / 8 >= out_w) {
      num = m;
      break;
    }
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  const double s = num / 8.0;
#else
  int denom = 1;
  for (int d = 2; d <= 8; d *= 2) {
    if (ch / d >= out_h && cw / d >= out_w) denom = d;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  const double s = 1.0 / denom;
#endif
  jpeg_start_decompress(&cinfo);
  const int sh = cinfo.output_height, sw = cinfo.output_width;
  const int comps = cinfo.output_components;  // 3 (RGB)

  // Crop in scaled coordinates — computed BEFORE reading so the decode can
  // be restricted to the crop window when the library supports it.
  double scy = cy * s, scx = cx * s;
  double sch = std::max(1.0, ch * s), scw = std::max(1.0, cw * s);
  scy = std::min(scy, sh - 1.0);
  scx = std::min(scx, sw - 1.0);
  sch = std::min(sch, sh - scy);
  scw = std::min(scw, sw - scx);

  // Decode window (bilinear below touches x0..x0+1 / y0..y0+1: pad by one;
  // +2 because the fractional end coordinate also rounds up).
  int wy0 = static_cast<int>(scy);
  const int wy1 = std::min(sh, static_cast<int>(scy + sch) + 2);
  int wx0 = static_cast<int>(scx);
  int www = std::min(sw - wx0, static_cast<int>(scw) + 2);
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  const bool window = wy0 > 0 || wy1 < sh || wx0 > 0 || www < sw;
  if (window) {
    // Column restriction: turbo expands [wx0, wx0+www) outward to iMCU
    // boundaries and rewrites both values; the decoded rows are then
    // exactly cinfo.output_width == www wide starting at source column wx0.
    if (wx0 > 0 || www < sw) {
      JDIMENSION jx = wx0, jw = www;
      jpeg_crop_scanline(&cinfo, &jx, &jw);
      wx0 = static_cast<int>(jx);
      www = static_cast<int>(jw);
    }
    // Row restriction: skip the rows above the window (entropy-decode only,
    // no IDCT/color conversion), read the window, skip the rest.
    if (wy0 > 0) {
      jpeg_skip_scanlines(&cinfo, wy0);
      wy0 = static_cast<int>(cinfo.output_scanline);
    }
  }
#else
  constexpr bool window = false;
  wy0 = 0;
  wx0 = 0;
  www = sw;
#endif
  const int dec_w = window ? www : sw;
  const int dec_h = window ? wy1 - wy0 : sh;
  if (!window) {
    wy0 = 0;
    wx0 = 0;
  }

  img.resize(static_cast<size_t>(dec_h) * dec_w * comps);
  std::vector<JSAMPROW> rows(1);
  for (int r = 0; r < dec_h; ++r) {
    rows[0] = img.data() + static_cast<size_t>(r) * dec_w * comps;
    jpeg_read_scanlines(&cinfo, rows.data(), 1);
  }
#ifdef LIBJPEG_TURBO_VERSION_NUMBER
  if (static_cast<int>(cinfo.output_scanline) < sh) {
    jpeg_skip_scanlines(&cinfo, sh - cinfo.output_scanline);
  }
#endif
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  // Identity fast path: full image at native size -> straight copy
  // (row-mirrored pixel copy when flipping).
  if (!window && s == 1.0 && cy == 0 && cx == 0 && ch == full_h &&
      cw == full_w && out_h == full_h && out_w == full_w && comps == 3) {
    if (!flip) {
      std::memcpy(out, img.data(), img.size());
    } else {
      for (int r = 0; r < out_h; ++r) {
        const uint8_t* src = img.data() + static_cast<size_t>(r) * out_w * 3;
        uint8_t* dst = out + static_cast<size_t>(r) * out_w * 3;
        for (int c = 0; c < out_w; ++c) {
          std::memcpy(dst + (out_w - 1 - c) * 3, src + c * 3, 3);
        }
      }
    }
    return 0;
  }

  // Bilinear resize (sch, scw) -> (out_h, out_w). Column geometry is
  // precomputed once; the inner loop is float lerps over RGB (comps==3 is
  // guaranteed by out_color_space=JCS_RGB above).
  // Bilinear resize (sch, scw) -> (out_h, out_w). Coordinates are in the
  // scaled-image frame; the decoded buffer holds only the window starting
  // at (wy0, wx0), so indices shift by the window origin and clamp at the
  // window's last row/column (identical to the full-image clamp whenever
  // the window reaches the image edge, and unreachable otherwise thanks to
  // the +2 pad above — the clamps are pure defense).
  std::vector<int> xi0(out_w), xi1(out_w);
  std::vector<float> xw(out_w);
  for (int c = 0; c < out_w; ++c) {
    const double fx = scx + (out_w > 1 ? (c * (scw - 1.0) / (out_w - 1)) : 0);
    const int x0 = static_cast<int>(fx);
    const int bx0 = std::min(std::max(x0 - wx0, 0), dec_w - 1);
    const int bx1 = std::min(std::min(x0 + 1, sw - 1) - wx0, dec_w - 1);
    xi0[c] = bx0 * comps;
    xi1[c] = std::max(bx1, 0) * comps;
    xw[c] = static_cast<float>(fx - x0);
  }
  for (int r = 0; r < out_h; ++r) {
    const double fy = scy + (out_h > 1 ? (r * (sch - 1.0) / (out_h - 1)) : 0);
    const int y0 = static_cast<int>(fy);
    const int by0 = std::min(std::max(y0 - wy0, 0), dec_h - 1);
    const int by1 =
        std::max(std::min(std::min(y0 + 1, sh - 1) - wy0, dec_h - 1), 0);
    const float wy = static_cast<float>(fy - y0);
    const float wyc = 1.0f - wy;
    uint8_t* orow = out + (static_cast<size_t>(r) * out_w) * 3;
    const uint8_t* row0 = img.data() + static_cast<size_t>(by0) * dec_w * comps;
    const uint8_t* row1 = img.data() + static_cast<size_t>(by1) * dec_w * comps;
    for (int c = 0; c < out_w; ++c) {
      const int a = xi0[c], b = xi1[c];
      const float wx = xw[c], wx0f = 1.0f - wx;
      // Horizontal flip costs nothing here: write the lerped pixel to the
      // mirrored output column instead of a separate reversal pass.
      const int oc = flip ? (out_w - 1 - c) : c;
      for (int k = 0; k < 3; ++k) {
        const float top = wx0f * row0[a + k] + wx * row0[b + k];
        const float bot = wx0f * row1[a + k] + wx * row1[b + k];
        orow[oc * 3 + k] = static_cast<uint8_t>(wyc * top + wy * bot + 0.5f);
      }
    }
  }
  return 0;
}

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < std::max(1, n); ++i) {
      threads_.emplace_back([this] { worker(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void run(std::vector<std::function<void()>> jobs) {
    std::atomic<int> remaining(static_cast<int>(jobs.size()));
    std::mutex done_mu;
    std::condition_variable done_cv;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (auto& j : jobs) {
        queue_.push([&remaining, &done_mu, &done_cv, job = std::move(j)] {
          job();
          if (remaining.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> dlk(done_mu);
            done_cv.notify_one();
          }
        });
      }
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> dlk(done_mu);
    done_cv.wait(dlk, [&] { return remaining.load() == 0; });
  }

 private:
  void worker() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop();
      }
      job();
    }
  }

  std::vector<std::thread> threads_;
  std::queue<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

int jpeg_dims(const char* path, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

void* decode_pool_create(int n_threads) { return new Pool(n_threads); }

void decode_pool_free(void* pool) { delete static_cast<Pool*>(pool); }

// boxes: per-image (y, x, h, w) int32 in original coordinates, or nullptr
// for whole-image; flips: per-image 0/1 horizontal-flip flags (nullptr =
// no flips). out: n * out_h * out_w * 3 uint8. Returns the number of
// images that FAILED to decode (their slots are zeroed).
int decode_pool_run(void* pool, const char** paths, const int* boxes,
                    const uint8_t* flips, int n, int out_h, int out_w,
                    uint8_t* out) {
  auto* p = static_cast<Pool*>(pool);
  std::atomic<int> failures(0);
  std::vector<std::function<void()>> jobs;
  jobs.reserve(n);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    jobs.push_back([=, &failures] {
      int cy = 0, cx = 0, ch = 0, cw = 0;
      if (boxes) {
        cy = boxes[i * 4 + 0];
        cx = boxes[i * 4 + 1];
        ch = boxes[i * 4 + 2];
        cw = boxes[i * 4 + 3];
      }
      const int flip = flips ? flips[i] : 0;
      uint8_t* dst = out + stride * i;
      if (decode_one(paths[i], cy, cx, ch, cw, out_h, out_w, flip, dst) !=
          0) {
        std::memset(dst, 0, stride);
        failures.fetch_add(1);
      }
    });
  }
  p->run(std::move(jobs));
  return failures.load();
}

// Full-image decode of a batch with per-image output buffers/sizes (the
// decode-only mode: callers probe jpeg_dims first and allocate per image).
int decode_pool_run_varied(void* pool, const char** paths, int n,
                           uint8_t** outs, const int* heights,
                           const int* widths) {
  auto* p = static_cast<Pool*>(pool);
  std::atomic<int> failures(0);
  std::vector<std::function<void()>> jobs;
  jobs.reserve(n);
  for (int i = 0; i < n; ++i) {
    jobs.push_back([=, &failures] {
      if (decode_one(paths[i], 0, 0, 0, 0, heights[i], widths[i], 0,
                     outs[i]) != 0) {
        std::memset(outs[i], 0,
                    static_cast<size_t>(heights[i]) * widths[i] * 3);
        failures.fetch_add(1);
      }
    });
  }
  p->run(std::move(jobs));
  return failures.load();
}

}  // extern "C"

// Native multi-view image loader: multi-threaded JPEG/PNG decode +
// bilinear resize + normalize, exposed as a C API for ctypes.
//
// Rationale (SURVEY.md section 7 "Hard parts" / input-bound risk): at
// 12 views/shape a v5e can be starved by host-side decode; the reference
// leaned on tf.data's internal C++ threading.  This is our native
// equivalent, framework-independent: Python hands in encoded blobs, the
// pool writes decoded float32 NHWC [-1, 1] directly into the caller's
// pinned buffer (which is then jax.device_put'ed) — zero extra copies on
// the Python side.
//
// Build: make -C gvcnn_tf_tpu/data/native  (links -ljpeg -lpng).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------
class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
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
  ~Pool() {
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
// Decoders -> RGB8
// ---------------------------------------------------------------------------
struct Image {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0, w = 0;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out, int target_h,
                 int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // IDCT-scaled decode: pick the largest 1/d (d in {1,2,4,8}) that still
  // leaves >= the target resolution — decoding a 512px render to 224px at
  // 1/2 scale costs ~1/4 of the IDCT work before the bilinear pass.
  if (target_h > 0 && target_w > 0) {
    int d = 1;
    while (d < 8 && int(cinfo.image_width) / (d * 2) >= target_w &&
           int(cinfo.image_height) / (d * 2) >= target_h) {
      d *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = d;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t len, off;
};

void png_read_cb(png_structp png, png_bytep dst, png_size_t n) {
  auto* s = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->off + n > s->len) {
    png_error(png, "eof");
    return;
  }
  std::memcpy(dst, s->data + s->off, n);
  s->off += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_cb);
  png_read_info(png, info);
  png_set_expand(png);           // palette/gray->8bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_any(const uint8_t* buf, size_t len, Image* out, int target_h,
                int target_w) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8)
    return decode_jpeg(buf, len, out, target_h, target_w);
  if (len >= 8 && buf[0] == 0x89 && buf[1] == 'P')
    return decode_png(buf, len, out);
  return false;
}

// ---------------------------------------------------------------------------
// Bilinear resize + store, optional horizontal flip.  The blend runs in
// float on [0, 255]; the output transform is chosen by dst type:
//   float    -> normalize to [-1, 1] (the classic pipeline contract)
//   uint8_t  -> round back to [0, 255] raw bytes (transfer_dtype="uint8":
//               4x less H2D; the device normalizes, utils/images.py)
// ---------------------------------------------------------------------------
inline void store_px(float v, float* o) {
  *o = v * (2.0f / 255.0f) - 1.0f;
}
inline void store_px(float v, uint8_t* o) {
  v += 0.5f;  // round-half-up of a non-negative blend in [0, 255]
  *o = uint8_t(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
}

template <typename T>
void resize_store(const Image& img, int oh, int ow, bool hflip, T* dst) {
  // Separable bilinear with precomputed column LUTs: horizontal pass blends
  // two source rows into float scanlines once per output row; the column
  // offsets/weights are computed once per image instead of per pixel.
  const float sy = float(img.h) / oh;
  const float sx = float(img.w) / ow;

  std::vector<int> x0s(ow), x1s(ow);
  std::vector<float> wxs(ow);
  for (int x = 0; x < ow; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int x0 = int(fx);
    x0s[x] = x0 * 3;
    x1s[x] = (x0 + 1 < img.w ? x0 + 1 : img.w - 1) * 3;
    wxs[x] = fx - x0;
  }

  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = int(fy);
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    const float wy = fy - y0;
    const float wy0 = 1.0f - wy;
    const uint8_t* r0 = img.rgb.data() + size_t(y0) * img.w * 3;
    const uint8_t* r1 = img.rgb.data() + size_t(y1) * img.w * 3;
    T* orow = dst + size_t(y) * ow * 3;
    const int step = hflip ? -3 : 3;
    T* o = hflip ? orow + (ow - 1) * 3 : orow;
    for (int x = 0; x < ow; ++x, o += step) {
      const int a = x0s[x], b = x1s[x];
      const float wx = wxs[x], wx0 = 1.0f - wx;
      for (int c = 0; c < 3; ++c) {
        const float top = wx0 * r0[a + c] + wx * r0[b + c];
        const float bot = wx0 * r1[a + c] + wx * r1[b + c];
        store_px(wy0 * top + wy * bot, o + c);
      }
    }
  }
}

struct Loader {
  explicit Loader(int threads) : pool(threads) {}
  Pool pool;
};

template <typename T>
int decode_batch_impl(void* handle, const uint8_t** blobs,
                      const size_t* sizes, int n, int out_h, int out_w,
                      const uint8_t* flips, T* out) {
  auto* L = reinterpret_cast<Loader*>(handle);
  std::atomic<int> failures{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  const size_t stride = size_t(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    L->pool.submit([&, i] {
      Image img;
      if (decode_any(blobs[i], sizes[i], &img, out_h, out_w) && img.h > 0 &&
          img.w > 0) {
        resize_store(img, out_h, out_w, flips && flips[i], out + stride * i);
      } else {
        std::memset(out + stride * i, 0, stride * sizeof(T));
        failures.fetch_add(1);
      }
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

}  // namespace

extern "C" {

void* gvl_create(int num_threads) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  return new Loader(num_threads);
}

void gvl_destroy(void* handle) { delete reinterpret_cast<Loader*>(handle); }

// Decode n encoded images into out (n, out_h, out_w, 3) float32 [-1,1].
// flips: per-image 0/1 horizontal flip (may be null).  Returns number of
// images that failed to decode (their slots are zero-filled).
int gvl_decode_batch(void* handle, const uint8_t** blobs, const size_t* sizes,
                     int n, int out_h, int out_w, const uint8_t* flips,
                     float* out) {
  return decode_batch_impl(handle, blobs, sizes, n, out_h, out_w, flips, out);
}

// Same, but out is raw uint8 [0, 255] (rounded post-resize): the wire
// format for transfer_dtype="uint8" runs — the device normalizes.
int gvl_decode_batch_u8(void* handle, const uint8_t** blobs,
                        const size_t* sizes, int n, int out_h, int out_w,
                        const uint8_t* flips, uint8_t* out) {
  return decode_batch_impl(handle, blobs, sizes, n, out_h, out_w, flips, out);
}

}  // extern "C"

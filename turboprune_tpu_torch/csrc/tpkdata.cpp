// tpkdata — memory-mapped packed-dataset reader with multithreaded JPEG
// decode and in-loader crop/resize, for turboprune_tpu_torch. A copy of
// native/tpkdata.cpp with one change: the JPEG decoder (libjpeg) is compiled
// only when TPK_WITH_JPEG is defined, which turboprune_tpu_torch/data/
// native.py::build_reader does when the compiler finds <jpeglib.h>. Without
// it the reader serves raw (mode 0) files, tpk_has_jpeg() returns 0 and
// tpk_decode_batch returns 3; the Python side refuses a JPEG (mode 1) file
// at open, naming the missing header. Everything that is compiled is the
// same code as native/tpkdata.cpp, so the two builds decode and crop bit for
// bit alike.
//
// The Python layer hands a batch of sample indices and a preallocated output
// buffer (a numpy array, or a pinned torch tensor through data_ptr()); this
// library does mmap'd reads, libjpeg decode, torchvision-style
// RandomResizedCrop (train) or ratio center-crop (eval), and bilinear
// resize, across a thread pool — no Python in the per-sample path.
//
// File format (.tpk), little-endian:
//   [0]  magic  "TPKD"                       (4 bytes)
//   [4]  u32    version = 1
//   [8]  u64    num_samples
//   [16] u32    mode: 0 = raw fixed-size uint8 HWC, 1 = JPEG blobs
//   [20] u32 h, [24] u32 w, [28] u32 c       (mode 0; zero for mode 1)
//   [32] i32    labels[num_samples]
//   then mode 0: images back-to-back (h*w*c bytes each)
//        mode 1: u64 offsets[num_samples+1] (relative to data start), blobs
//
// Exported C ABI (ctypes-friendly); all functions return 0 on success.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef TPK_WITH_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

constexpr uint32_t kMagic = 0x444b5054;  // "TPKD"
constexpr size_t kHeaderBytes = 32;

struct TpkFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t num_samples = 0;
  uint32_t mode = 0;
  uint32_t h = 0, w = 0, c = 0;
  const int32_t* labels = nullptr;
  const uint64_t* offsets = nullptr;  // mode 1
  const uint8_t* data = nullptr;
};

// xorshift64* — deterministic per-sample RNG so a (seed, index) pair always
// produces the same crop, independent of thread scheduling.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int64_t randint(int64_t lo, int64_t hi) {  // inclusive
    return lo + static_cast<int64_t>(uniform() * (hi - lo + 1));
  }
};

#ifdef TPK_WITH_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear resample of RGB region [x0,y0,cw,ch] of src (w x h) into
// out_size x out_size. Fixed-point (8-bit weights) with the horizontal taps
// precomputed once per image — the resample is the per-sample hot loop and
// the original double-precision version was ~3x slower than Pillow's SIMD
// path, wiping out the native loader's decode advantage.
void crop_resize_bilinear(const uint8_t* src, int w, int h, double x0,
                          double y0, double cw, double ch, uint8_t* dst,
                          int out_size) {
  const double sx = cw / out_size;
  const double sy = ch / out_size;
  thread_local std::vector<int32_t> xl, xr, wx;
  xl.resize(out_size);
  xr.resize(out_size);
  wx.resize(out_size);
  for (int ox = 0; ox < out_size; ++ox) {
    // Pixel-center sampling.
    double fx = x0 + (ox + 0.5) * sx - 0.5;
    fx = std::min(std::max(fx, 0.0), static_cast<double>(w - 1));
    const int x1 = static_cast<int>(fx);
    xl[ox] = x1 * 3;
    xr[ox] = std::min(x1 + 1, w - 1) * 3;
    wx[ox] = static_cast<int32_t>(std::lround((fx - x1) * 256.0));
  }
  for (int oy = 0; oy < out_size; ++oy) {
    double fy = y0 + (oy + 0.5) * sy - 0.5;
    fy = std::min(std::max(fy, 0.0), static_cast<double>(h - 1));
    const int y1 = static_cast<int>(fy);
    const int y2 = std::min(y1 + 1, h - 1);
    const int32_t wy = static_cast<int32_t>(std::lround((fy - y1) * 256.0));
    const uint8_t* r1 = src + static_cast<size_t>(y1) * w * 3;
    const uint8_t* r2 = src + static_cast<size_t>(y2) * w * 3;
    uint8_t* o = dst + static_cast<size_t>(oy) * out_size * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      const uint8_t* p11 = r1 + xl[ox];
      const uint8_t* p12 = r1 + xr[ox];
      const uint8_t* p21 = r2 + xl[ox];
      const uint8_t* p22 = r2 + xr[ox];
      const int32_t wxo = wx[ox];
      for (int ch_i = 0; ch_i < 3; ++ch_i) {
        // top/bot <= 255*256; blend fits int32 with room for rounding.
        const int32_t top = p11[ch_i] * (256 - wxo) + p12[ch_i] * wxo;
        const int32_t bot = p21[ch_i] * (256 - wxo) + p22[ch_i] * wxo;
        o[ox * 3 + ch_i] =
            static_cast<uint8_t>((top * (256 - wy) + bot * wy + (1 << 15)) >> 16);
      }
    }
  }
}

// torchvision RandomResizedCrop sampling (scale [0.08,1], ratio [3/4,4/3],
// 10 tries then aspect-clamped center fallback) — the same policy FFCV's
// RandomResizedCropRGBImageDecoder implements.
void sample_rrc(Rng& rng, int w, int h, double& x0, double& y0, double& cw,
                double& ch) {
  const double area = static_cast<double>(w) * h;
  for (int i = 0; i < 10; ++i) {
    const double target = area * (0.08 + rng.uniform() * (1.0 - 0.08));
    const double log_lo = std::log(3.0 / 4.0), log_hi = std::log(4.0 / 3.0);
    const double aspect = std::exp(log_lo + rng.uniform() * (log_hi - log_lo));
    const double tw = std::round(std::sqrt(target * aspect));
    const double th = std::round(std::sqrt(target / aspect));
    if (tw > 0 && th > 0 && tw <= w && th <= h) {
      x0 = static_cast<double>(rng.randint(0, w - static_cast<int64_t>(tw)));
      y0 = static_cast<double>(rng.randint(0, h - static_cast<int64_t>(th)));
      cw = tw;
      ch = th;
      return;
    }
  }
  const double in_ratio = static_cast<double>(w) / h;
  if (in_ratio < 3.0 / 4.0) {
    cw = w;
    ch = std::round(w / (3.0 / 4.0));
  } else if (in_ratio > 4.0 / 3.0) {
    ch = h;
    cw = std::round(h * (4.0 / 3.0));
  } else {
    cw = w;
    ch = h;
  }
  x0 = (w - cw) / 2.0;
  y0 = (h - ch) / 2.0;
}

#endif  // TPK_WITH_JPEG

void parallel_for(int n, int nthreads, const std::function<void(int)>& body) {
  nthreads = std::max(1, std::min(nthreads, n));
  if (nthreads == 1) {
    for (int i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) body(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* tpk_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < kHeaderBytes) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* f = new TpkFile();
  f->fd = fd;
  f->base = static_cast<const uint8_t*>(base);
  f->size = st.st_size;
  uint32_t magic, version;
  std::memcpy(&magic, f->base, 4);
  std::memcpy(&version, f->base + 4, 4);
  std::memcpy(&f->num_samples, f->base + 8, 8);
  std::memcpy(&f->mode, f->base + 16, 4);
  std::memcpy(&f->h, f->base + 20, 4);
  std::memcpy(&f->w, f->base + 24, 4);
  std::memcpy(&f->c, f->base + 28, 4);
  if (magic != kMagic || version != 1) {
    munmap(base, st.st_size);
    close(fd);
    delete f;
    return nullptr;
  }
  f->labels = reinterpret_cast<const int32_t*>(f->base + kHeaderBytes);
  const uint8_t* after_labels =
      f->base + kHeaderBytes + f->num_samples * sizeof(int32_t);
  if (f->mode == 1) {
    f->offsets = reinterpret_cast<const uint64_t*>(after_labels);
    f->data = after_labels + (f->num_samples + 1) * sizeof(uint64_t);
  } else {
    f->data = after_labels;
  }
  return f;
}

void tpk_close(void* handle) {
  auto* f = static_cast<TpkFile*>(handle);
  if (!f) return;
  munmap(const_cast<uint8_t*>(f->base), f->size);
  close(f->fd);
  delete f;
}

int64_t tpk_num_samples(void* handle) {
  return static_cast<TpkFile*>(handle)->num_samples;
}
int32_t tpk_mode(void* handle) { return static_cast<TpkFile*>(handle)->mode; }
int32_t tpk_height(void* handle) { return static_cast<TpkFile*>(handle)->h; }
int32_t tpk_width(void* handle) { return static_cast<TpkFile*>(handle)->w; }
int32_t tpk_channels(void* handle) { return static_cast<TpkFile*>(handle)->c; }

// mode 0: copy fixed-size raw samples for the given indices.
int tpk_read_raw_batch(void* handle, const int64_t* indices, int n,
                       uint8_t* out_images, int32_t* out_labels,
                       int nthreads) {
  auto* f = static_cast<TpkFile*>(handle);
  if (f->mode != 0) return 1;
  const size_t sample_bytes = static_cast<size_t>(f->h) * f->w * f->c;
  std::atomic<int> bad{0};
  parallel_for(n, nthreads, [&](int i) {
    const int64_t idx = indices[i];
    if (idx < 0 || static_cast<uint64_t>(idx) >= f->num_samples) {
      bad.store(1);
      return;
    }
    std::memcpy(out_images + static_cast<size_t>(i) * sample_bytes,
                f->data + static_cast<size_t>(idx) * sample_bytes,
                sample_bytes);
    out_labels[i] = f->labels[idx];
  });
  return bad.load();
}

// mode 1: decode + crop + resize JPEG samples.
//   train=1: RandomResizedCrop seeded by (seed, index) + optional hflip
//   train=0: center crop of crop_ratio*min_side
int tpk_decode_batch(void* handle, const int64_t* indices, int n,
                     int out_size, int train, uint64_t seed,
                     double center_crop_ratio, uint8_t* out_images,
                     int32_t* out_labels, int nthreads) {
#ifdef TPK_WITH_JPEG
  auto* f = static_cast<TpkFile*>(handle);
  if (f->mode != 1) return 1;
  const size_t out_bytes = static_cast<size_t>(out_size) * out_size * 3;
  std::atomic<int> bad{0};
  parallel_for(n, nthreads, [&](int i) {
    const int64_t idx = indices[i];
    if (idx < 0 || static_cast<uint64_t>(idx) >= f->num_samples) {
      bad.store(1);
      return;
    }
    const uint8_t* blob = f->data + f->offsets[idx];
    const size_t len = f->offsets[idx + 1] - f->offsets[idx];

    // One libjpeg pass: header (dims only) -> sample the crop in FULL-RES
    // coordinates (so the crop distribution and the (seed, index)
    // determinism never depend on the decode scale) -> pick the largest
    // DCT scale 1/2^k that keeps the scaled crop >= out_size -> decode at
    // that scale. For large sources (real ImageNet JPEGs, ~500px sides)
    // this skips most of the IDCT + color-convert work — the same
    // reduced-resolution decode FFCV leans on for its throughput.
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      bad.store(2);
      return;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    const int w = cinfo.image_width, h = cinfo.image_height;

    double x0, y0, cw, ch;
    bool flip = false;
    if (train) {
      Rng rng(seed ^ (0x9e3779b97f4a7c15ull * (idx + 1)));
      sample_rrc(rng, w, h, x0, y0, cw, ch);
      flip = rng.uniform() < 0.5;
    } else {
      const double side = center_crop_ratio * std::min(w, h);
      cw = ch = side;
      x0 = (w - side) / 2.0;
      y0 = (h - side) / 2.0;
    }
    unsigned denom = 1;
    while (denom < 8 && cw / (denom * 2) >= out_size &&
           ch / (denom * 2) >= out_size) {
      denom *= 2;
    }
    cinfo.out_color_space = JCS_RGB;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
    jpeg_start_decompress(&cinfo);
    const int ow = cinfo.output_width, oh = cinfo.output_height;
    thread_local std::vector<uint8_t> rgb;  // reused across samples
    rgb.resize(static_cast<size_t>(ow) * oh * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row =
          rgb.data() + static_cast<size_t>(cinfo.output_scanline) * ow * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    // Map the full-res crop into the scaled image's coordinates.
    const double rx = static_cast<double>(ow) / w;
    const double ry = static_cast<double>(oh) / h;
    uint8_t* dst = out_images + static_cast<size_t>(i) * out_bytes;
    crop_resize_bilinear(rgb.data(), ow, oh, x0 * rx, y0 * ry, cw * rx,
                         ch * ry, dst, out_size);
    if (flip) {
      for (int y = 0; y < out_size; ++y) {
        uint8_t* row = dst + static_cast<size_t>(y) * out_size * 3;
        for (int x = 0; x < out_size / 2; ++x) {
          for (int ci = 0; ci < 3; ++ci)
            std::swap(row[x * 3 + ci], row[(out_size - 1 - x) * 3 + ci]);
        }
      }
    }
    out_labels[i] = f->labels[idx];
  });
  return bad.load();
#else
  (void)handle; (void)indices; (void)n; (void)out_size; (void)train; (void)seed;
  (void)center_crop_ratio; (void)out_images; (void)out_labels; (void)nthreads;
  return 3;  // built without the JPEG decoder
#endif
}

// 1 when this build has the JPEG decoder (mode 1 files), else 0.
int tpk_has_jpeg() {
#ifdef TPK_WITH_JPEG
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"

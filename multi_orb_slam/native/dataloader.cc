// Native asynchronous RGB-D dataset loader.
//
// The reference's runtime is C++ (its driver loop loads and decodes images
// inline on the tracking thread, Examples/RGB-D/rgbd_tum.cc:103-131, which
// stalls tracking on disk+PNG latency).  This loader is this engine's
// equivalent of that IO path: a pthread pool decodes PNG/JPEG/PGM frames
// ahead of the consumer into pinned host buffers, delivering frames in
// submission order through a bounded queue, so the accelerator never waits
// on image IO.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC dataloader.cc -o libslamloader.so \
//            -lpng -ljpeg -lz -pthread

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  long seq = -1;
  int width = 0, height = 0;
  std::vector<float> gray;   // [H*W] grayscale 0..255
  std::vector<float> depth;  // [H*W] meters (empty if no depth image)
  bool ok = false;
};

struct Job {
  long seq;
  std::string rgb_path;
  std::string depth_path;  // may be empty
  float depth_factor;      // raw/factor -> meters
};

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

bool decode_png(const char* path, std::vector<uint16_t>* out, int* w, int* h,
                int* channels, int* bitdepth) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  *bitdepth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (*bitdepth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (*bitdepth == 16) png_set_swap(png);  // little-endian uint16
  png_read_update_info(png, info);
  *channels = png_get_channels(png, info);
  int bd = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<png_byte> data((size_t)(*h) * rowbytes);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; y++) rows[y] = data.data() + (size_t)y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  out->resize((size_t)(*w) * (*h) * (*channels));
  if (bd == 16) {
    memcpy(out->data(), data.data(), out->size() * 2);
    *bitdepth = 16;
  } else {
    for (size_t i = 0; i < out->size(); i++) (*out)[i] = data[i];
    *bitdepth = 8;
  }
  return true;
}

bool decode_jpeg(const char* path, std::vector<uint16_t>* out, int* w, int* h,
                 int* channels) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  *channels = cinfo.output_components;
  out->resize((size_t)(*w) * (*h) * (*channels));
  std::vector<uint8_t> row((size_t)(*w) * (*channels));
  uint8_t* rp = row.data();
  for (int y = 0; y < *h; y++) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    for (size_t i = 0; i < row.size(); i++)
      (*out)[(size_t)y * row.size() + i] = row[i];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode_pgm(const char* path, std::vector<uint16_t>* out, int* w, int* h,
                int* bitdepth) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int maxval = 0;
  if (fscanf(fp, "%2s %d %d %d", magic, w, h, &maxval) != 4 ||
      strcmp(magic, "P5") != 0) {
    fclose(fp);
    return false;
  }
  fgetc(fp);  // single whitespace after header
  size_t n = (size_t)(*w) * (*h);
  out->resize(n);
  if (maxval > 255) {
    std::vector<uint8_t> buf(n * 2);
    if (fread(buf.data(), 2, n, fp) != n) { fclose(fp); return false; }
    for (size_t i = 0; i < n; i++)
      (*out)[i] = (uint16_t)((buf[2 * i] << 8) | buf[2 * i + 1]);  // big-endian
    *bitdepth = 16;
  } else {
    std::vector<uint8_t> buf(n);
    if (fread(buf.data(), 1, n, fp) != n) { fclose(fp); return false; }
    for (size_t i = 0; i < n; i++) (*out)[i] = buf[i];
    *bitdepth = 8;
  }
  fclose(fp);
  return true;
}

bool load_image(const std::string& path, std::vector<uint16_t>* px, int* w,
                int* h, int* channels, int* bitdepth) {
  *channels = 1;
  *bitdepth = 8;
  size_t dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot + 1);
  for (auto& c : ext) c = (char)tolower(c);
  if (ext == "png") return decode_png(path.c_str(), px, w, h, channels, bitdepth);
  if (ext == "jpg" || ext == "jpeg")
    return decode_jpeg(path.c_str(), px, w, h, channels);
  if (ext == "pgm") return decode_pgm(path.c_str(), px, w, h, bitdepth);
  // fall back to trying PNG then JPEG by content
  if (decode_png(path.c_str(), px, w, h, channels, bitdepth)) return true;
  return decode_jpeg(path.c_str(), px, w, h, channels);
}

// ---------------------------------------------------------------------------
// Loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::thread> workers;
  std::queue<Job> jobs;
  std::map<long, Frame> ready;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_ready;
  std::atomic<bool> stop{false};
  size_t max_ready;

  explicit Loader(int n_threads, int queue_depth)
      : max_ready(queue_depth > 0 ? (size_t)queue_depth : 8) {
    for (int i = 0; i < n_threads; i++)
      workers.emplace_back([this] { worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_jobs.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_jobs.wait(lk, [this] {
          return stop || (!jobs.empty() && ready.size() < max_ready);
        });
        if (stop) return;
        job = jobs.front();
        jobs.pop();
      }
      Frame f;
      f.seq = job.seq;
      std::vector<uint16_t> px;
      int w = 0, h = 0, ch = 1, bd = 8;
      if (load_image(job.rgb_path, &px, &w, &h, &ch, &bd)) {
        f.width = w;
        f.height = h;
        f.gray.resize((size_t)w * h);
        for (size_t i = 0; i < f.gray.size(); i++) {
          if (ch >= 3) {
            // BT.601 luma, matching cv::cvtColor BGR/RGB->GRAY closely
            float r = px[i * ch + 0], g = px[i * ch + 1], b = px[i * ch + 2];
            f.gray[i] = 0.299f * r + 0.587f * g + 0.114f * b;
          } else {
            f.gray[i] = (float)px[i];
          }
        }
        f.ok = true;
      }
      if (f.ok && !job.depth_path.empty()) {
        std::vector<uint16_t> dp;
        int dw = 0, dh = 0, dch = 1, dbd = 16;
        if (load_image(job.depth_path, &dp, &dw, &dh, &dch, &dbd) &&
            dw == w && dh == h) {
          f.depth.resize((size_t)w * h);
          float inv = 1.0f / job.depth_factor;
          for (size_t i = 0; i < f.depth.size(); i++)
            f.depth[i] = (float)dp[i * dch] * inv;
        } else {
          f.ok = false;
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(f.seq, std::move(f));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dl_create(int n_threads, int queue_depth) {
  return new Loader(n_threads, queue_depth);
}

void dl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

void dl_submit(void* handle, long seq, const char* rgb_path,
               const char* depth_path, float depth_factor) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->jobs.push(Job{seq, rgb_path, depth_path ? depth_path : "",
                     depth_factor});
  }
  L->cv_jobs.notify_one();
}

// Blocking in-order pop: waits for `seq`, copies into caller buffers.
// Returns 1 on success, 0 on decode failure, -1 on size mismatch.
int dl_next(void* handle, long seq, float* gray_out, float* depth_out,
            int expect_h, int expect_w) {
  auto* L = static_cast<Loader*>(handle);
  Frame f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      return L->stop || L->ready.count(seq) > 0;
    });
    if (L->stop) return 0;
    f = std::move(L->ready[seq]);
    L->ready.erase(seq);
  }
  L->cv_jobs.notify_all();  // ready-queue slot freed
  if (!f.ok) return 0;
  if (f.height != expect_h || f.width != expect_w) return -1;
  memcpy(gray_out, f.gray.data(), f.gray.size() * sizeof(float));
  if (depth_out && !f.depth.empty())
    memcpy(depth_out, f.depth.data(), f.depth.size() * sizeof(float));
  return 1;
}

}  // extern "C"

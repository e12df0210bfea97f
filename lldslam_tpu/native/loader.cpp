// Native threaded image loader/prefetcher.
//
// The reference's runtime is native C++ end to end; its per-frame image IO
// is cv::imread on the main thread (Examples/Stereo/stereo_kitti.cc:108).
// Here the host-side runtime around the GPU compute is native too: a C++
// worker pool decodes PNG frames ahead of the tracker (libpng simplified
// API), so Python never sits in the decode path and the device queue is fed
// back-to-back. Exposed through a C ABI consumed via ctypes
// (native/__init__.py) — no pybind11 in this image.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 loader.cpp -lpng -o libloader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> data;
  uint32_t w = 0, h = 0;
  int status = 0;  // 0 = pending, 1 = ready, -1 = failed
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_work;
  std::atomic<size_t> next_decode{0};
  std::atomic<size_t> consumer_pos{0};
  size_t window;
  std::atomic<bool> stop{false};

  Loader(const char** cpaths, size_t n, size_t window_, size_t n_threads)
      : paths(cpaths, cpaths + n), slots(n), window(window_) {
    for (size_t t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Loader() {
    stop = true;
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  static bool decode(const std::string& path, Slot* out) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_file(&image, path.c_str())) return false;
    image.format = PNG_FORMAT_GRAY;
    out->w = image.width;
    out->h = image.height;
    out->data.resize(PNG_IMAGE_SIZE(image));
    if (!png_image_finish_read(&image, nullptr, out->data.data(), 0,
                               nullptr)) {
      png_image_free(&image);
      return false;
    }
    return true;
  }

  void run() {
    while (!stop) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] {
          return stop ||
                 (next_decode < paths.size() &&
                  next_decode < consumer_pos + window);
        });
        if (stop) return;
        idx = next_decode.fetch_add(1);
        if (idx >= paths.size()) return;
      }
      Slot tmp;
      bool ok = decode(paths[idx], &tmp);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx].data = std::move(tmp.data);
        slots[idx].w = tmp.w;
        slots[idx].h = tmp.h;
        slots[idx].status = ok ? 1 : -1;
      }
      cv_ready.notify_all();
    }
  }

  // blocks until frame idx is decoded; returns 1 ok / -1 failed
  int get(size_t idx, uint8_t* out, uint32_t* w, uint32_t* h, size_t cap) {
    {
      std::lock_guard<std::mutex> lk(mu);
      consumer_pos = idx;  // advance the prefetch window
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return slots[idx].status != 0; });
    if (slots[idx].status < 0) return -1;
    Slot& s = slots[idx];
    *w = s.w;
    *h = s.h;
    size_t n = static_cast<size_t>(s.w) * s.h;
    if (n > cap) return -2;
    memcpy(out, s.data.data(), n);
    // release memory behind the consumer
    s.data.clear();
    s.data.shrink_to_fit();
    return 1;
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, size_t n, size_t window,
                    size_t n_threads) {
  return new Loader(paths, n, window, n_threads);
}

int loader_get(void* handle, size_t idx, uint8_t* out, uint32_t* w,
               uint32_t* h, size_t cap) {
  return static_cast<Loader*>(handle)->get(idx, out, w, h, cap);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int loader_probe_size(const char* path, uint32_t* w, uint32_t* h) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return -1;
  *w = image.width;
  *h = image.height;
  png_image_free(&image);
  return 1;
}

}  // extern "C"

// Native dataset loader for rpg_svo_tpu_torch (a copy of the JAX
// package's rpg_svo_tpu/native/loader.cpp).
//
// C++ equivalent of the reference's host-side data path (OpenCV imread in
// benchmark_node.cpp / vo_node.cpp plus vikit's FileReader): fast PNG/PGM
// grayscale decoding with a C ABI consumed from Python via ctypes.  ctypes
// releases the GIL during calls, so Python-level prefetch threads decode
// in parallel while the device computes.
//
// Built by rpg_svo_tpu_torch/native/loader.py on first use:
//   g++ -O2 -shared -fPIC -pthread loader.cpp -lpng -lz
// and where libpng is missing, PGM only:
//   g++ -O2 -shared -fPIC -pthread -DSVO_NO_PNG loader.cpp

#ifndef SVO_NO_PNG
#include <png.h>
#endif

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// 1 where the library decodes PNG (built with libpng), else 0.
int svo_has_png() {
#ifdef SVO_NO_PNG
  return 0;
#else
  return 1;
#endif
}

// Decode an image file to grayscale float32 in [0, 255], row-major.
// Returns 0 on success; fills *w/*h. `out` must hold max_pixels floats.
// Supported: PNG (any color type via libpng simplified API), binary PGM (P5).
int svo_load_gray(const char* path, float* out, int* w, int* h,
                  long max_pixels) {
  // --- PGM fast path ---
  const char* dot = strrchr(path, '.');
  if (dot && (strcmp(dot, ".pgm") == 0 || strcmp(dot, ".PGM") == 0)) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    int ww = 0, hh = 0, maxv = 0;
    if (fscanf(f, "%2s %d %d %d", magic, &ww, &hh, &maxv) != 4 ||
        strcmp(magic, "P5") != 0 || maxv > 255) {
      fclose(f);
      return -2;
    }
    fgetc(f);  // single whitespace after header
    long n = (long)ww * hh;
    if (n > max_pixels) {
      fclose(f);
      return -3;
    }
    unsigned char* buf = (unsigned char*)malloc(n);
    if (fread(buf, 1, n, f) != (size_t)n) {
      free(buf);
      fclose(f);
      return -4;
    }
    fclose(f);
    for (long i = 0; i < n; ++i) out[i] = (float)buf[i];
    free(buf);
    *w = ww;
    *h = hh;
    return 0;
  }

#ifdef SVO_NO_PNG
  return -7;  // PNG needs libpng
#else
  // --- PNG via libpng simplified API ---
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return -5;
  image.format = PNG_FORMAT_GRAY;
  long n = (long)image.width * image.height;
  if (n > max_pixels) {
    png_image_free(&image);
    return -3;
  }
  unsigned char* buf = (unsigned char*)malloc(n);
  if (!png_image_finish_read(&image, nullptr, buf, 0, nullptr)) {
    free(buf);
    png_image_free(&image);
    return -6;
  }
  for (long i = 0; i < n; ++i) out[i] = (float)buf[i];
  free(buf);
  *w = (int)image.width;
  *h = (int)image.height;
  return 0;
#endif
}

// Decode straight into a caller-provided uint8 buffer (zero-copy variant
// for callers that quantize on device).
int svo_load_gray_u8(const char* path, unsigned char* out, int* w, int* h,
                     long max_pixels) {
#ifdef SVO_NO_PNG
  return -7;
#else
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return -5;
  image.format = PNG_FORMAT_GRAY;
  long n = (long)image.width * image.height;
  if (n > max_pixels) {
    png_image_free(&image);
    return -3;
  }
  if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
    png_image_free(&image);
    return -6;
  }
  *w = (int)image.width;
  *h = (int)image.height;
  return 0;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native prefetch queue: a worker-thread pool decodes frames ahead of the
// tracker (the reference's ROS subscriber queue + vk::FileReader role,
// vo_node.cpp:163-169).  Python submits (id, path) pairs; workers decode
// into an in-flight store; get() blocks until the id is ready.  All
// synchronization is C++-side (std::thread/mutex/condvar) — the decode
// pipeline never touches the Python GIL.
// ---------------------------------------------------------------------------

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Decoded {
  std::vector<float> px;
  int w = 0, h = 0;
  int rc = -1;
};

struct Prefetcher {
  std::mutex mu;
  std::condition_variable cv_submit;   // workers wait for work
  std::condition_variable cv_done;     // consumers wait for results
  std::deque<std::pair<long, std::string>> queue;
  std::unordered_map<long, Decoded> done;
  std::vector<std::thread> workers;
  long max_pixels = 0;
  size_t queue_cap = 0;
  bool stopping = false;

  void worker() {
    std::vector<float> buf;
    for (;;) {
      std::pair<long, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [&] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      Decoded d;
      d.px.resize(max_pixels);
      d.rc = svo_load_gray(job.second.c_str(), d.px.data(), &d.w, &d.h,
                           max_pixels);
      if (d.rc == 0) d.px.resize((size_t)d.w * d.h);
      {
        std::lock_guard<std::mutex> lk(mu);
        done.emplace(job.first, std::move(d));
      }
      cv_done.notify_all();
    }
  }
};

Prefetcher* g_pf = nullptr;

}  // namespace

extern "C" {

// Start the pool (idempotent; restarts with new parameters if called
// again after svo_prefetch_stop).  Returns 0 on success.
int svo_prefetch_start(int n_workers, int queue_cap, long max_pixels) {
  if (g_pf) return -1;
  g_pf = new Prefetcher();
  g_pf->max_pixels = max_pixels;
  g_pf->queue_cap = queue_cap > 0 ? (size_t)queue_cap : 8;
  for (int i = 0; i < (n_workers > 0 ? n_workers : 2); ++i)
    g_pf->workers.emplace_back([] { g_pf->worker(); });
  return 0;
}

// Enqueue a decode job.  Returns 0, or -1 if the in-flight window
// (queue + undrained results) is at capacity — caller retries after
// draining, which bounds memory like the reference's queue cap.
int svo_prefetch_submit(long id, const char* path) {
  if (!g_pf) return -2;
  std::lock_guard<std::mutex> lk(g_pf->mu);
  if (g_pf->queue.size() + g_pf->done.size() >= g_pf->queue_cap)
    return -1;
  g_pf->queue.emplace_back(id, std::string(path));
  g_pf->cv_submit.notify_one();
  return 0;
}

// Block until job `id` is decoded; copy into out.  Returns the decode rc.
int svo_prefetch_get(long id, float* out, int* w, int* h) {
  if (!g_pf) return -2;
  Decoded d;
  {
    std::unique_lock<std::mutex> lk(g_pf->mu);
    g_pf->cv_done.wait(lk, [&] { return g_pf->done.count(id) > 0; });
    d = std::move(g_pf->done[id]);
    g_pf->done.erase(id);
  }
  if (d.rc != 0) return d.rc;
  memcpy(out, d.px.data(), d.px.size() * sizeof(float));
  *w = d.w;
  *h = d.h;
  return 0;
}

void svo_prefetch_stop() {
  if (!g_pf) return;
  {
    std::lock_guard<std::mutex> lk(g_pf->mu);
    g_pf->stopping = true;
  }
  g_pf->cv_submit.notify_all();
  for (auto& t : g_pf->workers) t.join();
  delete g_pf;
  g_pf = nullptr;
}

}  // extern "C"

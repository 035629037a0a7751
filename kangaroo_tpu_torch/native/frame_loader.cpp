// Threaded frame loader: streams PGM/PPM (PXM) image sequences from disk
// into a ring buffer off the Python thread.
//
// Native-runtime equivalent of the reference's camera input layer
// (include/kangaroo/extra/RpgCameraOpen.h + HAL video capture feeding
// dKinect.CopyFrom each frame, applications/kinectfusion/main.cpp:196-208):
// the device compute path stays on the card, while frame IO and decoding run
// in C++ worker threads so the device never waits on disk. Exposed to Python
// via ctypes (kangaroo_tpu_torch/io/frame_loader.py). A copy of
// kangaroo_tpu/native/frame_loader.cpp: the two packages build their own.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libframe_loader.so frame_loader.cpp

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
  int64_t w = 0, h = 0, channels = 0, bytes_per_sample = 0;
  int64_t index = -1;
  bool ok = false;
};

bool read_token(FILE* f, std::string* tok) {
  tok->clear();
  int c;
  while ((c = std::fgetc(f)) != EOF) {
    if (c == '#') {  // comment to end of line
      while ((c = std::fgetc(f)) != EOF && c != '\n') {
      }
      continue;
    }
    if (std::isspace(c)) {
      if (!tok->empty()) return true;
      continue;
    }
    tok->push_back((char)c);
  }
  return !tok->empty();
}

bool load_pxm(const std::string& path, Frame* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::string magic, ws, hs, maxs;
  if (!read_token(f, &magic) || !read_token(f, &ws) || !read_token(f, &hs) ||
      !read_token(f, &maxs)) {
    std::fclose(f);
    return false;
  }
  int channels = magic == "P6" ? 3 : (magic == "P5" ? 1 : 0);
  if (!channels) {
    std::fclose(f);
    return false;
  }
  int64_t w = std::atoll(ws.c_str());
  int64_t h = std::atoll(hs.c_str());
  int64_t maxval = std::atoll(maxs.c_str());
  int64_t bps = maxval > 255 ? 2 : 1;
  out->w = w;
  out->h = h;
  out->channels = channels;
  out->bytes_per_sample = bps;
  out->data.resize((size_t)(w * h * channels * bps));
  size_t got = std::fread(out->data.data(), 1, out->data.size(), f);
  std::fclose(f);
  out->ok = got == out->data.size();
  return out->ok;
}

struct Loader {
  std::vector<std::string> paths;
  std::queue<Frame> ready;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  size_t capacity = 4;
  std::atomic<size_t> next_index{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    while (!stop.load()) {
      size_t i = next_index.fetch_add(1);
      if (i >= paths.size()) break;
      Frame fr;
      fr.index = (int64_t)i;
      load_pxm(paths[i], &fr);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < capacity || stop.load(); });
      if (stop.load()) break;
      ready.push(std::move(fr));
      cv_data.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    ready.push(Frame{});  // sentinel: index = -1
    cv_data.notify_all();
  }
};

}  // namespace

extern "C" {

void* fl_open(const char** paths, int64_t n_paths, int64_t n_threads,
              int64_t capacity) {
  auto* ld = new Loader();
  ld->paths.assign(paths, paths + n_paths);
  ld->capacity = (size_t)capacity;
  for (int64_t t = 0; t < n_threads; ++t)
    ld->workers.emplace_back(&Loader::worker, ld);
  return ld;
}

// Pops the next decoded frame (frames may arrive out of order across
// threads; with n_threads=1 order is sequential). Returns 1 and fills the
// output params on success, 0 at end of stream. Caller frees *data with
// fl_free.
int fl_next(void* handle, uint8_t** data, int64_t* w, int64_t* h,
            int64_t* channels, int64_t* bps, int64_t* index) {
  auto* ld = (Loader*)handle;
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_data.wait(lk, [&] { return !ld->ready.empty(); });
  Frame fr = std::move(ld->ready.front());
  ld->ready.pop();
  ld->cv_space.notify_one();
  if (fr.index < 0) return 0;  // sentinel
  *w = fr.w;
  *h = fr.h;
  *channels = fr.channels;
  *bps = fr.bytes_per_sample;
  *index = fr.index;
  auto* buf = (uint8_t*)std::malloc(fr.data.size());
  std::memcpy(buf, fr.data.data(), fr.data.size());
  *data = buf;
  return fr.ok ? 1 : -1;
}

void fl_free(uint8_t* p) { std::free(p); }

void fl_close(void* handle) {
  auto* ld = (Loader*)handle;
  ld->stop.store(true);
  ld->cv_space.notify_all();
  for (auto& t : ld->workers)
    if (t.joinable()) t.join();
  delete ld;
}

}  // extern "C"

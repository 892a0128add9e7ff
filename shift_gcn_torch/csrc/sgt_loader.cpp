// sgt_loader: native batch loader for .npy skeleton datasets.
//
// The port's trainer feeds the GPU one batch a step: N clips (~4.7 MB
// each at (3,300,33,1) fp32) gathered from an mmap'd .npy into one
// contiguous buffer.  This library does the gather with a small thread
// pool (and an async single-request prefetch) so that Python never blocks
// on page faults; it has a plain C ABI, loaded through ctypes
// (data/native_loader.py).
//
// A copy of the repository's native/sgt_loader.cpp, code unchanged.
// Build (data/native_loader.py does it on first use, into _build/):
//   g++ -O3 -shared -fPIC -pthread -std=c++17 sgt_loader.cpp -o libsgt_loader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  size_t header_bytes = 0;
  size_t item_bytes = 0;   // bytes per element (float32 -> 4)
  bool fortran = false;
};

// Minimal .npy v1/v2 header parser (little-endian f4/f8 arrays only).
bool parse_npy_header(const unsigned char* data, size_t size, NpyInfo* info) {
  if (size < 10 || std::memcmp(data, "\x93NUMPY", 6) != 0) return false;
  const int major = data[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = data[8] | (data[9] << 8);
    header_off = 10;
  } else {
    header_len = data[8] | (data[9] << 8) | (data[10] << 16)
                 | ((size_t)data[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > size) return false;
  std::string header(reinterpret_cast<const char*>(data + header_off),
                     header_len);
  info->header_bytes = header_off + header_len;

  auto find_value = [&](const std::string& key) -> std::string {
    size_t k = header.find("'" + key + "'");
    if (k == std::string::npos) return "";
    size_t colon = header.find(':', k);
    return header.substr(colon + 1);
  };

  std::string descr = find_value("descr");
  if (descr.find("<f4") != std::string::npos) info->item_bytes = 4;
  else if (descr.find("<f8") != std::string::npos) info->item_bytes = 8;
  else return false;

  info->fortran = find_value("fortran_order").find("True") != std::string::npos;
  if (info->fortran) return false;

  std::string shape_s = find_value("shape");
  size_t lp = shape_s.find('(');
  size_t rp = shape_s.find(')');
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string inner = shape_s.substr(lp + 1, rp - lp - 1);
  info->shape.clear();
  const char* p = inner.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    info->shape.push_back(strtoll(p, const_cast<char**>(&p), 10));
  }
  return !info->shape.empty();
}

struct Loader {
  int fd = -1;
  const unsigned char* map = nullptr;
  size_t map_size = 0;
  NpyInfo info;
  size_t clip_elems = 0;   // elements per leading-index slice
  int num_threads = 4;

  // async prefetch state
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<int64_t> pending;   // indices to fetch
  float* pending_out = nullptr;
  std::atomic<bool> busy{false};
  std::atomic<bool> stop{false};

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
    if (map) munmap(const_cast<unsigned char*>(map), map_size);
    if (fd >= 0) close(fd);
  }

  const unsigned char* clip_ptr(int64_t idx) const {
    return map + info.header_bytes
           + static_cast<size_t>(idx) * clip_elems * info.item_bytes;
  }

  void gather(const int64_t* indices, int n, float* out) const {
    const int threads = std::min<int>(num_threads, std::max(1, n));
    std::vector<std::thread> pool;
    std::atomic<int> next{0};
    auto work = [&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        const unsigned char* src = clip_ptr(indices[i]);
        float* dst = out + static_cast<size_t>(i) * clip_elems;
        if (info.item_bytes == 4) {
          std::memcpy(dst, src, clip_elems * 4);
        } else {
          const double* s = reinterpret_cast<const double*>(src);
          for (size_t j = 0; j < clip_elems; ++j) dst[j] = (float)s[j];
        }
      }
    };
    for (int t = 0; t < threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }

  void run_worker() {
    for (;;) {
      std::vector<int64_t> idx;
      float* out;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || pending_out != nullptr; });
        if (stop) return;
        idx.swap(pending);
        out = pending_out;
        pending_out = nullptr;
      }
      gather(idx.data(), static_cast<int>(idx.size()), out);
      busy = false;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* sgt_open(const char* path, int num_threads) {
  auto* l = new Loader();
  l->num_threads = num_threads > 0 ? num_threads : 4;
  l->fd = open(path, O_RDONLY);
  if (l->fd < 0) { delete l; return nullptr; }
  struct stat st;
  if (fstat(l->fd, &st) != 0) { delete l; return nullptr; }
  l->map_size = st.st_size;
  void* m = mmap(nullptr, l->map_size, PROT_READ, MAP_SHARED, l->fd, 0);
  if (m == MAP_FAILED) { delete l; return nullptr; }
  l->map = static_cast<const unsigned char*>(m);
  madvise(m, l->map_size, MADV_WILLNEED);
  if (!parse_npy_header(l->map, l->map_size, &l->info)) {
    delete l;
    return nullptr;
  }
  l->clip_elems = 1;
  for (size_t i = 1; i < l->info.shape.size(); ++i)
    l->clip_elems *= l->info.shape[i];
  l->worker = std::thread(&Loader::run_worker, l);
  return l;
}

int sgt_ndim(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->info.shape.size());
}

void sgt_shape(void* handle, int64_t* dims) {
  auto* l = static_cast<Loader*>(handle);
  for (size_t i = 0; i < l->info.shape.size(); ++i) dims[i] = l->info.shape[i];
}

// Synchronous gather of n clips into out (float32, caller-allocated).
int sgt_gather(void* handle, const int64_t* indices, int n, float* out) {
  auto* l = static_cast<Loader*>(handle);
  for (int i = 0; i < n; ++i)
    if (indices[i] < 0 || indices[i] >= l->info.shape[0]) return -1;
  l->gather(indices, n, out);
  return 0;
}

// Async prefetch into out; pair with sgt_wait. One outstanding request.
int sgt_prefetch(void* handle, const int64_t* indices, int n, float* out) {
  auto* l = static_cast<Loader*>(handle);
  if (l->busy.load()) return -1;
  for (int i = 0; i < n; ++i)
    if (indices[i] < 0 || indices[i] >= l->info.shape[0]) return -2;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->pending.assign(indices, indices + n);
    l->pending_out = out;
    l->busy = true;
  }
  l->cv.notify_all();
  return 0;
}

void sgt_wait(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv.wait(lk, [&] { return !l->busy.load(); });
}

void sgt_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

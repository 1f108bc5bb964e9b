// Native data-loader primitives: positional reads + background prefetch.
//
// The port's copy of distributed_embeddings_tpu/native/io.cpp: the
// reference's RawBinaryDataset host path (examples/dlrm/utils.py:231-266:
// os.pread + a single-thread prefetch executor) as a small C++ thread pool
// that issues pread()s ahead of the training step, so the host input
// pipeline overlaps device compute. Built into one library with
// hashmap.cpp and host_apply.cpp (native/loader.py).
//
// Unlike the JAX package's copy, it reports failures: pf_create refuses a
// file it cannot open, and pf_wait / pf_read return the bytes a read got
// (short at the file's end) or -errno, for the caller to raise.

#include <cerrno>
#include <fcntl.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct ReadRequest {
  int file;
  int64_t offset;
  int64_t size;
  uint8_t* dst;
  int64_t got = 0;  // bytes read, or -errno of the failed pread
  bool done = false;
};

struct Prefetcher {
  std::vector<int> fds;
  std::deque<ReadRequest*> queue;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;
  bool stop = false;

  // err: the index of the first file that did not open and its errno,
  // or -1 (no thread is started then)
  Prefetcher(const char** paths, int64_t n_files, int64_t n_threads,
             int64_t* err) {
    err[0] = -1;
    for (int64_t i = 0; i < n_files; ++i) {
      int fd = open(paths[i], O_RDONLY);
      if (fd < 0) {
        err[0] = i;
        err[1] = errno;
        return;
      }
      fds.push_back(fd);
    }
    for (int64_t t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { this->worker(); });
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    for (int fd : fds) {
      if (fd >= 0) close(fd);
    }
  }

  void worker() {
    while (true) {
      ReadRequest* req = nullptr;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        req = queue.front();
        queue.pop_front();
      }
      int64_t got = 0;
      while (got < req->size) {
        ssize_t r = pread(fds[req->file], req->dst + got, req->size - got,
                          req->offset + got);
        if (r < 0 && errno == EINTR) continue;
        if (r < 0) {
          got = -errno;
          break;
        }
        if (r == 0) break;  // the file's end
        got += r;
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        req->got = got;
        req->done = true;
      }
      cv_done.notify_all();
    }
  }

  ReadRequest* submit(int file, int64_t offset, int64_t size, uint8_t* dst) {
    auto* req = new ReadRequest{file, offset, size, dst};
    {
      std::lock_guard<std::mutex> lock(mu);
      queue.push_back(req);
    }
    cv_work.notify_one();
    return req;
  }

  int64_t wait(ReadRequest* req) {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [req] { return req->done; });
    return req->got;
  }
};

}  // namespace

extern "C" {

// NULL when a file does not open: err[0] its index, err[1] the errno
void* pf_create(const char** paths, int64_t n_files, int64_t n_threads,
                int64_t* err) {
  auto* pf = new Prefetcher(paths, n_files, n_threads, err);
  if (err[0] >= 0) {
    delete pf;
    return nullptr;
  }
  return pf;
}

void pf_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

void* pf_submit(void* handle, int64_t file, int64_t offset, int64_t size,
                void* dst) {
  return static_cast<Prefetcher*>(handle)->submit(
      static_cast<int>(file), offset, size, static_cast<uint8_t*>(dst));
}

// the bytes the read got (fewer than asked past the file's end), or -errno
int64_t pf_wait(void* handle, void* request) {
  auto* pf = static_cast<Prefetcher*>(handle);
  auto* req = static_cast<ReadRequest*>(request);
  int64_t got = pf->wait(req);
  delete req;
  return got;
}

// synchronous convenience read
int64_t pf_read(void* handle, int64_t file, int64_t offset, int64_t size,
                void* dst) {
  auto* pf = static_cast<Prefetcher*>(handle);
  auto* req = pf->submit(static_cast<int>(file), offset, size,
                         static_cast<uint8_t*>(dst));
  int64_t got = pf->wait(req);
  delete req;
  return got;
}

}  // extern "C"

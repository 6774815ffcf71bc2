// Async file I/O engine: a thread pool and an op queue over pread / pwrite.
// The port's own copy of the JAX package's csrc/aio/aio_engine.cpp.
//
// Counterpart of the reference's libaio engine (csrc/aio/common/* +
// csrc/aio/py_lib/*): worker threads drain a queue of read / write
// descriptors against host buffers, with POSIX pread / pwrite in place of
// libaio (the reference itself falls back to a thread pool per file
// shard).  Exposed as a C ABI for ctypes (ops/op_builder.py).
//
// Ops complete out of order; completion is polled / waited per op or
// drained with wait_all, as deepspeed_aio_thread.cpp's completion queue.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

using Flag = std::shared_ptr<std::atomic<int>>; // 0 pending, 1 ok, -1 error

struct Op {
  int64_t id;
  bool write;
  std::string path;
  int64_t offset;
  int64_t size;
  char *buffer;
  Flag done_flag;
};

class AioEngine {
public:
  AioEngine(int num_threads, int queue_depth)
      : queue_depth_(queue_depth), stop_(false), next_id_(1) {
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { this->worker(); });
  }

  ~AioEngine() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_)
      t.join();
  }

  int64_t submit(bool write, const char *path, int64_t offset, int64_t size,
                 char *buffer) {
    auto flag = std::make_shared<std::atomic<int>>(0);
    std::unique_lock<std::mutex> lk(mu_);
    int64_t id = next_id_++;
    flags_[id] = flag;
    queue_.push_back(Op{id, write, path, offset, size, buffer, flag});
    lk.unlock();
    cv_.notify_one();
    return id;
  }

  // 1 done-ok, -1 error, 0 pending
  int poll(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = flags_.find(id);
    if (it == flags_.end())
      return -2; // unknown id
    return it->second->load();
  }

  int wait(int64_t id) {
    Flag flag; // shared ownership: safe even if another waiter reclaims the id
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = flags_.find(id);
      if (it == flags_.end())
        return -2;
      flag = it->second;
    }
    int v;
    {
      std::unique_lock<std::mutex> lk(done_mu_);
      done_cv_.wait(lk, [&] { return (v = flag->load()) != 0; });
    }
    // reclaim the flag entry; only the waiter that still finds it erases
    std::lock_guard<std::mutex> lk2(mu_);
    auto it = flags_.find(id);
    if (it != flags_.end() && it->second == flag)
      flags_.erase(it);
    return v;
  }

  int wait_all() {
    int rc = 1;
    std::vector<int64_t> ids;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (auto &kv : flags_)
        ids.push_back(kv.first);
    }
    for (int64_t id : ids) {
      int v = wait(id);
      // -2 here means a concurrent waiter already reclaimed the id after
      // completion — not an I/O failure
      if (v < 0 && v != -2)
        rc = v;
    }
    return rc;
  }

  int pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int)flags_.size();
  }

private:
  void worker() {
    for (;;) {
      Op op;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty())
          return;
        op = queue_.front();
        queue_.pop_front();
      }
      int rc = run(op);
      {
        // Publish under done_mu_ so a waiter that just evaluated the
        // predicate cannot miss the notification between check and block.
        std::lock_guard<std::mutex> lk(done_mu_);
        op.done_flag->store(rc);
      }
      done_cv_.notify_all();
    }
  }

  static int run(const Op &op) {
    int flags = op.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = ::open(op.path.c_str(), flags, 0644);
    if (fd < 0)
      return -1;
    int64_t remaining = op.size;
    char *buf = op.buffer;
    int64_t off = op.offset;
    while (remaining > 0) {
      ssize_t n = op.write ? ::pwrite(fd, buf, remaining, off)
                           : ::pread(fd, buf, remaining, off);
      if (n <= 0) {
        ::close(fd);
        return -1;
      }
      remaining -= n;
      buf += n;
      off += n;
    }
    ::close(fd);
    return 1;
  }

  int queue_depth_;
  bool stop_;
  int64_t next_id_;
  std::deque<Op> queue_;
  std::unordered_map<int64_t, Flag> flags_;
  std::mutex mu_, done_mu_;
  std::condition_variable cv_, done_cv_;
  std::vector<std::thread> workers_;
};

} // namespace

extern "C" {

void *aio_create(int num_threads, int queue_depth) {
  return new AioEngine(num_threads, queue_depth);
}

void aio_destroy(void *h) { delete static_cast<AioEngine *>(h); }

int64_t aio_submit_read(void *h, const char *path, int64_t offset,
                        int64_t size, char *buffer) {
  return static_cast<AioEngine *>(h)->submit(false, path, offset, size, buffer);
}

int64_t aio_submit_write(void *h, const char *path, int64_t offset,
                         int64_t size, char *buffer) {
  return static_cast<AioEngine *>(h)->submit(true, path, offset, size, buffer);
}

int aio_poll(void *h, int64_t id) { return static_cast<AioEngine *>(h)->poll(id); }
int aio_wait(void *h, int64_t id) { return static_cast<AioEngine *>(h)->wait(id); }
int aio_wait_all(void *h) { return static_cast<AioEngine *>(h)->wait_all(); }
int aio_pending(void *h) { return static_cast<AioEngine *>(h)->pending(); }
}

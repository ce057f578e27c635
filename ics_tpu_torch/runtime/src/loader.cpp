// Copied from ics_tpu/runtime/src/loader.cpp (unchanged below this note). The port
// builds it at first use: ics_tpu_torch/runtime/_lib.py.
//
// Thread-pool file prefetcher for the ICS-TPU host runtime.
//
// The TPU solver is device-bound; the host's job is to keep it fed.  The
// reference loads one image at a time on the main thread (PIL / tifffile,
// ref deconvolve.py:375-421).  This pool reads files into caller-provided
// buffers on background threads so decode/upload overlaps the previous
// image's solve — the data-loader role of a training framework's input
// pipeline, in ~150 lines of C++.
//
// C ABI (ctypes-friendly):
//   ics_loader_create(n_threads) -> handle
//   ics_loader_submit(handle, path) -> ticket (>=0) or -1
//   ics_loader_size(handle, ticket) -> file size once read, -1 if pending,
//                                      -2 on read error
//   ics_loader_take(handle, ticket, dst, cap) -> bytes copied (blocks until
//                                      the read finishes), -1 on error
//   ics_loader_destroy(handle)

#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<unsigned char> data;
  bool done = false;
  bool error = false;
};

struct Loader {
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::deque<long long> queue;
  std::unordered_map<long long, std::unique_ptr<Job>> jobs;
  std::vector<std::thread> threads;
  long long next_ticket = 0;
  bool shutdown = false;

  explicit Loader(int n_threads) {
    for (int t = 0; t < n_threads; ++t) {
      threads.emplace_back([this] { Work(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      shutdown = true;
    }
    cv_work.notify_all();
    for (auto& t : threads) t.join();
  }

  void Work() {
    for (;;) {
      long long ticket;
      Job* job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [this] { return shutdown || !queue.empty(); });
        if (shutdown && queue.empty()) return;
        ticket = queue.front();
        queue.pop_front();
        job = jobs[ticket].get();
      }
      bool err = false;
      std::vector<unsigned char> data;
      FILE* f = std::fopen(job->path.c_str(), "rb");
      if (!f) {
        err = true;
      } else {
        std::fseek(f, 0, SEEK_END);
        const long long size = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        data.resize(static_cast<size_t>(size));
        if (size > 0 &&
            std::fread(data.data(), 1, static_cast<size_t>(size), f) !=
                static_cast<size_t>(size)) {
          err = true;
        }
        std::fclose(f);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        job->data = std::move(data);
        job->error = err;
        job->done = true;
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

#define ICS_API __attribute__((visibility("default")))

extern "C" {

ICS_API void* ics_loader_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Loader(n_threads);
}

ICS_API long long ics_loader_submit(void* handle, const char* path) {
  auto* loader = static_cast<Loader*>(handle);
  if (!loader || !path) return -1;
  std::lock_guard<std::mutex> lock(loader->mu);
  const long long ticket = loader->next_ticket++;
  auto job = std::make_unique<Job>();
  job->path = path;
  loader->jobs.emplace(ticket, std::move(job));
  loader->queue.push_back(ticket);
  loader->cv_work.notify_one();
  return ticket;
}

ICS_API long long ics_loader_size(void* handle, long long ticket) {
  auto* loader = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(loader->mu);
  auto it = loader->jobs.find(ticket);
  if (it == loader->jobs.end()) return -2;
  if (!it->second->done) return -1;
  if (it->second->error) return -2;
  return static_cast<long long>(it->second->data.size());
}

ICS_API long long ics_loader_take(void* handle, long long ticket, unsigned char* dst,
                          long long cap) {
  auto* loader = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(loader->mu);
  auto it = loader->jobs.find(ticket);
  if (it == loader->jobs.end()) return -1;
  Job* job = it->second.get();
  loader->cv_done.wait(lock, [job] { return job->done; });
  if (job->error) {
    loader->jobs.erase(it);
    return -1;
  }
  const long long n =
      static_cast<long long>(job->data.size()) < cap
          ? static_cast<long long>(job->data.size())
          : cap;
  std::memcpy(dst, job->data.data(), static_cast<size_t>(n));
  loader->jobs.erase(it);
  return n;
}

ICS_API void ics_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

// The benchmark's load generator: a frozen copy of the program's native
// mini-loadgen (rnnt_inference_tpu_torch/csrc/rnnt_loadgen.cpp), Server mode
// only, that issues a schedule it is given.
//
// A dedicated thread pushes query ids into a bounded queue at their
// scheduled arrival times on a steady clock, free of the Python
// interpreter's jitter.  Completions are stamped here.  A query's latency
// runs from its SCHEDULED arrival to its completion, so a stall that makes
// later queries late is charged to them (loadgen's rule); the actual issue
// time is kept apart, to say how late the generator ran.
//
// C ABI, loaded with ctypes.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_seconds(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}

  bool push(int64_t v) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push(v);
    cv_pop_.notify_one();
    return true;
  }

  // Pop up to n items, waiting at most timeout_us for the first one.
  int pop_bulk(int64_t* out, int n, int64_t timeout_us) {
    std::unique_lock<std::mutex> lk(mu_);
    if (q_.empty()) {
      cv_pop_.wait_for(lk, std::chrono::microseconds(timeout_us),
                       [&] { return !q_.empty() || closed_; });
    }
    int k = 0;
    while (k < n && !q_.empty()) {
      out[k++] = q_.front();
      q_.pop();
    }
    if (k) cv_push_.notify_all();
    return k;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_pop_.notify_all();
    cv_push_.notify_all();
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::queue<int64_t> q_;
  size_t cap_;
  bool closed_ = false;
};

struct Test {
  BoundedQueue queue{65536};
  std::thread issuer;
  Clock::time_point t0;
  // guards the stamp arrays: the issuer and bl_complete write them while
  // bl_stamps may read them
  std::mutex stamp_mu;
  std::vector<double> sched_time;     // per query: its scheduled arrival
  std::vector<double> actual_time;    // per query: when it was pushed; -1 before
  std::vector<double> complete_time;  // -1 until completed
  std::atomic<int64_t> issued{0};
  std::atomic<int64_t> completed{0};
  std::atomic<bool> done_issuing{false};
  std::atomic<bool> stop{false};

  ~Test() {
    stop = true;
    queue.close();
    if (issuer.joinable()) issuer.join();
  }
};

}  // namespace

extern "C" {

// Issue n queries, query q at sched[q] seconds after this call (ascending).
void* bl_create(int64_t n, const double* sched) {
  auto* t = new Test();
  t->sched_time.assign(sched, sched + n);
  t->actual_time.assign(n, -1.0);
  t->complete_time.assign(n, -1.0);
  t->t0 = Clock::now();
  t->issuer = std::thread([t, n] {
    for (int64_t q = 0; q < n && !t->stop; ++q) {
      double wait = t->sched_time[q] - now_seconds(t->t0);
      if (wait > 0) std::this_thread::sleep_for(std::chrono::duration<double>(wait));
      {
        std::lock_guard<std::mutex> lk(t->stamp_mu);
        t->actual_time[q] = now_seconds(t->t0);
      }
      if (!t->queue.push(q)) return;
      t->issued.fetch_add(1);
    }
    t->done_issuing = true;
  });
  return t;
}

void bl_destroy(void* h) { delete static_cast<Test*>(h); }

// Pull up to n issued query ids; returns the count (0 on timeout).
int bl_poll(void* h, int64_t* out, int n, int64_t timeout_us) {
  return static_cast<Test*>(h)->queue.pop_bulk(out, n, timeout_us);
}

// Stamp a query complete on this clock.
void bl_complete(void* h, int64_t q) {
  auto* t = static_cast<Test*>(h);
  {
    std::lock_guard<std::mutex> lk(t->stamp_mu);
    t->complete_time[q] = now_seconds(t->t0);
  }
  t->completed.fetch_add(1);
}

int64_t bl_issued(void* h) { return static_cast<Test*>(h)->issued.load(); }
int64_t bl_completed(void* h) { return static_cast<Test*>(h)->completed.load(); }
int64_t bl_pending(void* h) {
  return static_cast<int64_t>(static_cast<Test*>(h)->queue.size());
}
int64_t bl_done_issuing(void* h) {
  return static_cast<Test*>(h)->done_issuing.load() ? 1 : 0;
}
double bl_now(void* h) { return now_seconds(static_cast<Test*>(h)->t0); }

// Per query, seconds on this clock: scheduled arrival, actual issue (-1 if
// not issued) and completion (-1 if not completed), into out[3 n].
void bl_stamps(void* h, double* out) {
  auto* t = static_cast<Test*>(h);
  std::lock_guard<std::mutex> lk(t->stamp_mu);
  size_t n = t->sched_time.size();
  std::copy(t->sched_time.begin(), t->sched_time.end(), out);
  std::copy(t->actual_time.begin(), t->actual_time.end(), out + n);
  std::copy(t->complete_time.begin(), t->complete_time.end(), out + 2 * n);
}

}  // extern "C"

// Mini-loadgen: native load generation + latency accounting.
//
// Replacement for the pieces the reference gets from
// mlcommons loadgen + moodycamel::BlockingConcurrentQueue
// (reference: csrc/torch_sut.cpp IssueQuery/QuerySamplesComplete paths,
// csrc/main.cpp:108-147): a dedicated issue thread pushes QUERY ids into a
// bounded MPMC queue (steady_clock, immune to Python GIL jitter), and
// completions are timestamped here so latency percentiles are measured
// outside the Python interpreter.
//
// Loadgen rule semantics implemented:
//   - queries loop over the sample set (query q -> sample q % n_samples),
//     so min_query_count larger than the set is honored like loadgen's
//     sample-set cycling
//   - the issuer keeps issuing until BOTH min_query_count queries are issued
//     AND min_duration has elapsed (mlperf.conf min_duration/min_query_count,
//     reference csrc/main.cpp:108-115 TestSettings)
//   - Server latency is charged from the SCHEDULED Poisson arrival, not the
//     actual (possibly backpressured) issue time — matching loadgen's
//     overload accounting; the actual issue time is kept separately
//   - SingleStream issues the next query only after the previous completes
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_seconds(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

// Bounded MPMC queue (mutex+condvar; ~10M ops/s, far above the 4.2k QPS
// target — the reference's lock-free moodycamel queue is rate-overkill here
// and 3.7 kLoC of vendored header).
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

// Counting semaphore for SingleStream issue-after-complete pacing.
class Tokens {
 public:
  void post() {
    std::lock_guard<std::mutex> lk(mu_);
    ++n_;
    cv_.notify_one();
  }
  // Wait for a token; returns false if released by close().
  bool take(const std::atomic<bool>& stop) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return n_ > 0 || stop.load(); });
    if (n_ == 0) return false;
    --n_;
    return true;
  }
  void release() {
    std::lock_guard<std::mutex> lk(mu_);
    cv_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int64_t n_ = 0;
};

struct Test {
  BoundedQueue queue{4096};
  std::thread issuer;
  Clock::time_point t0;
  // stamp_mu guards the three timestamp arrays: issuer threads and
  // lg_complete write them while lg_report may read mid-run (the arrays
  // are plain doubles, so unsynchronized access would be a data race)
  std::mutex stamp_mu;
  std::vector<double> sched_time;     // per query: latency reference point
  std::vector<double> actual_time;    // per query: actual issue timestamp
  std::vector<double> complete_time;  // -1 until completed
  // QoS-deferred queries (over-long samples parked until the issue stream
  // drains, reference csrc/torch_sut.cpp:384-417): their completions land
  // AFTER the measured window and must not pollute the live percentiles
  std::vector<uint8_t> deferred;
  std::atomic<int64_t> issued{0};
  std::atomic<int64_t> completed{0};
  std::atomic<bool> done_issuing{false};
  int64_t n_samples = 0;
  int64_t max_queries = 0;
  std::atomic<bool> stop{false};
  Tokens tokens;  // SingleStream pacing

  ~Test() {
    stop = true;
    queue.close();
    tokens.release();
    if (issuer.joinable()) issuer.join();
  }
};

}  // namespace

extern "C" {

// mode 0 = Server (Poisson at target_qps), 1 = Offline (issue everything
// up front), 2 = SingleStream (issue next only after previous completes).
//
// Queries are issued until BOTH `min_query_count` have been issued AND
// `min_duration_s` has elapsed (each may be satisfied trivially by passing
// 0); query q maps to sample q % n_samples.
void* lg_create(int64_t n_samples, double target_qps, int mode, uint64_t seed,
                int64_t min_query_count, double min_duration_s) {
  auto* t = new Test();
  t->n_samples = n_samples;
  if (min_query_count < 1) min_query_count = n_samples;
  // Upper bound on queries so per-query arrays can be preallocated: the
  // count rule, plus enough rate*duration queries to satisfy the duration
  // rule at the target rate (2x slack; if the SUT is slower than target the
  // duration is satisfied by backpressured wall time anyway).
  int64_t rate_bound = min_query_count;
  if (mode == 0) {
    rate_bound = static_cast<int64_t>(target_qps * min_duration_s * 2) + 16;
  } else if (mode == 2 && min_duration_s > 0) {
    // SingleStream issue rate is SUT-latency-bound and unknown up front;
    // 1M queries of headroom (24 MB of timestamps) covers any real run.
    rate_bound = min_query_count + 1000000;
  }
  t->max_queries = std::max(min_query_count, rate_bound);
  t->sched_time.assign(t->max_queries, -1.0);
  t->actual_time.assign(t->max_queries, -1.0);
  t->complete_time.assign(t->max_queries, -1.0);
  t->deferred.assign(t->max_queries, 0);
  t->t0 = Clock::now();

  if (mode == 1) {  // Offline: everything at t=0 (issuer thread only so the
                    // bounded queue can backpressure without blocking create)
    t->issuer = std::thread([t, min_query_count] {
      for (int64_t q = 0; q < min_query_count && !t->stop; ++q) {
        {
          std::lock_guard<std::mutex> lk(t->stamp_mu);
          t->sched_time[q] = 0.0;
          t->actual_time[q] = now_seconds(t->t0);
        }
        if (!t->queue.push(q)) return;
        t->issued.fetch_add(1);
      }
      t->done_issuing = true;
    });
  } else if (mode == 2) {  // SingleStream: issue-after-complete
    t->tokens.post();      // first query needs no predecessor
    t->issuer = std::thread([t, min_query_count, min_duration_s] {
      for (int64_t q = 0; q < t->max_queries && !t->stop; ++q) {
        if (q >= min_query_count && now_seconds(t->t0) >= min_duration_s) break;
        if (!t->tokens.take(t->stop)) return;
        double ts = now_seconds(t->t0);
        {
          std::lock_guard<std::mutex> lk(t->stamp_mu);
          t->sched_time[q] = ts;  // latency from issue (no arrival schedule)
          t->actual_time[q] = ts;
        }
        if (!t->queue.push(q)) return;
        t->issued.fetch_add(1);
      }
      t->done_issuing = true;
    });
  } else {  // Server: Poisson schedule on a dedicated thread
    t->issuer = std::thread([t, target_qps, seed, min_query_count,
                             min_duration_s] {
      std::mt19937_64 rng(seed);
      std::exponential_distribution<double> exp_dist(target_qps);
      double sched = 0.0;
      for (int64_t q = 0; q < t->max_queries && !t->stop; ++q) {
        if (q >= min_query_count && sched >= min_duration_s) break;
        sched += exp_dist(rng);
        double wait = sched - now_seconds(t->t0);
        if (wait > 0) {
          std::this_thread::sleep_for(std::chrono::duration<double>(wait));
        }
        // Latency is charged from the SCHEDULED arrival: under overload the
        // actual push happens later (sleep skipped / queue backpressure) and
        // that lateness must count against the SUT, like loadgen does.
        {
          std::lock_guard<std::mutex> lk(t->stamp_mu);
          t->sched_time[q] = sched;
          t->actual_time[q] = now_seconds(t->t0);
        }
        if (!t->queue.push(q)) return;
        t->issued.fetch_add(1);
      }
      t->done_issuing = true;
    });
  }
  return t;
}

void lg_destroy(void* h) { delete static_cast<Test*>(h); }

// Pull up to n pending query ids; returns count (0 on timeout).
int lg_poll(void* h, int64_t* out, int n, int64_t timeout_us) {
  return static_cast<Test*>(h)->queue.pop_bulk(out, n, timeout_us);
}

// Mark query complete (timestamped here, native clock).
void lg_complete(void* h, int64_t query_id) {
  auto* t = static_cast<Test*>(h);
  {
    std::lock_guard<std::mutex> lk(t->stamp_mu);
    t->complete_time[query_id] = now_seconds(t->t0);
  }
  t->completed.fetch_add(1);
  t->tokens.post();  // unblocks the SingleStream issuer; no-op otherwise
}

// Flag a query as QoS-deferred: its completion is excluded from the live
// latency percentiles and reported separately (reference drains mQosQueue_
// only after FlushQueries, i.e. outside the measured window).
void lg_mark_deferred(void* h, int64_t query_id) {
  auto* t = static_cast<Test*>(h);
  std::lock_guard<std::mutex> lk(t->stamp_mu);
  t->deferred[query_id] = 1;
}

int64_t lg_completed(void* h) { return static_cast<Test*>(h)->completed.load(); }
int64_t lg_issued(void* h) { return static_cast<Test*>(h)->issued.load(); }
int64_t lg_n_samples(void* h) { return static_cast<Test*>(h)->n_samples; }

// Issued-but-not-yet-polled queries currently waiting in the queue.
int64_t lg_pending(void* h) {
  return static_cast<int64_t>(static_cast<Test*>(h)->queue.size());
}

// 1 once the issuer has issued its final query (count+duration satisfied).
int64_t lg_done_issuing(void* h) {
  return static_cast<Test*>(h)->done_issuing.load() ? 1 : 0;
}

// Latency stats over completed queries, milliseconds.  The percentile pool
// covers only LIVE (non-deferred) completions; QoS-deferred completions are
// summarized separately in out[9..11].
// out: [count, mean, p50, p90, p99, max, wall_seconds, qps, issued,
//       deferred_count, deferred_mean, deferred_max]
void lg_report(void* h, double* out) {
  auto* t = static_cast<Test*>(h);
  std::vector<double> lat;
  lat.reserve(t->max_queries);
  double t_last = 0.0;
  int64_t n_def = 0;
  double def_sum = 0.0, def_max = 0.0;
  {
    std::lock_guard<std::mutex> lk(t->stamp_mu);
    for (int64_t q = 0; q < t->max_queries; ++q) {
      if (t->complete_time[q] >= 0 && t->sched_time[q] >= 0) {
        double ms = (t->complete_time[q] - t->sched_time[q]) * 1e3;
        if (t->deferred[q]) {
          // deferred drains land after the measured window: keep them out of
          // wall_seconds/qps as well as the percentile pool
          ++n_def;
          def_sum += ms;
          def_max = std::max(def_max, ms);
        } else {
          t_last = std::max(t_last, t->complete_time[q]);
          lat.push_back(ms);
        }
      }
    }
  }
  std::sort(lat.begin(), lat.end());
  auto pct = [&](double p) -> double {
    if (lat.empty()) return 0.0;
    double idx = p / 100.0 * (lat.size() - 1);
    size_t lo = static_cast<size_t>(idx);
    size_t hi = std::min(lo + 1, lat.size() - 1);
    double frac = idx - lo;
    return lat[lo] * (1 - frac) + lat[hi] * frac;
  };
  double mean = 0.0;
  for (double v : lat) mean += v;
  if (!lat.empty()) mean /= lat.size();
  out[0] = static_cast<double>(lat.size());
  out[1] = mean;
  out[2] = pct(50);
  out[3] = pct(90);
  out[4] = pct(99);
  out[5] = lat.empty() ? 0.0 : lat.back();
  out[6] = t_last;
  out[7] = t_last > 0 ? lat.size() / t_last : 0.0;
  out[8] = static_cast<double>(t->issued.load());
  out[9] = static_cast<double>(n_def);
  out[10] = n_def ? def_sum / n_def : 0.0;
  out[11] = def_max;
}

}  // extern "C"

// Native multi-threaded slot data feed.
//
// The port's equivalent of the reference's C++ input stack:
//   - MultiSlotDataFeed (paddle/fluid/framework/data_feed.h:224) — textual
//     slot files parsed off the Python thread
//   - LoDTensorBlockingQueue (operators/reader/lod_tensor_blocking_queue.h)
//     — bounded producer/consumer queue
//   - the AsyncExecutor file-sharded reader threads
//     (framework/executor_thread_worker.cc)
//
// Differences by design: ragged slots are padded/truncated to a fixed
// per-slot width (static shapes) instead of carrying LoD offsets; batches
// are delivered as contiguous host buffers, which the Python side wraps as
// numpy arrays, and the executor stages in pinned memory and copies to the
// card.
//
// Line format (one example per line, same shape as the reference's
// MultiSlotDataFeed): for each slot, "<count> v0 v1 ..." whitespace
// separated; int slots pad with pad_value, float slots with 0.
//
// C API (ctypes-friendly): mdf_create / mdf_start / mdf_next_batch /
// mdf_batch_data / mdf_batch_rows / mdf_batch_free / mdf_destroy.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

enum SlotType { kInt64 = 0, kFloat32 = 1 };

struct SlotSpec {
  SlotType type;
  int width;  // values per example (pad/truncate)
};

struct Batch {
  int rows = 0;
  // one contiguous buffer per slot: rows * width elements
  std::vector<std::vector<int64_t>> int_data;
  std::vector<std::vector<float>> float_data;
};

struct Example {
  std::vector<std::vector<int64_t>> ints;
  std::vector<std::vector<float>> floats;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t cap) : cap_(cap) {}

  bool Push(std::unique_ptr<Batch> b) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(b));
    cv_pop_.notify_one();
    return true;
  }

  std::unique_ptr<Batch> Pop() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [&] { return !q_.empty() || (closed_ && done_); });
    if (q_.empty()) return nullptr;
    auto b = std::move(q_.front());
    q_.pop_front();
    cv_push_.notify_one();
    return b;
  }

  void Close(bool producers_done) {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    done_ = producers_done;
    cv_pop_.notify_all();
    cv_push_.notify_all();
  }

  void MarkDone() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    done_ = true;
    cv_pop_.notify_all();
  }

 private:
  size_t cap_;
  std::deque<std::unique_ptr<Batch>> q_;
  std::mutex mu_;
  std::condition_variable cv_push_, cv_pop_;
  bool closed_ = false;
  bool done_ = false;
};

class MultiSlotFeed {
 public:
  MultiSlotFeed(std::vector<std::string> files, int batch_size,
                std::vector<SlotSpec> slots, int n_threads, int epochs,
                int64_t pad_value, size_t queue_cap)
      : files_(std::move(files)),
        batch_size_(batch_size),
        slots_(std::move(slots)),
        n_threads_(n_threads),
        epochs_(epochs),
        pad_value_(pad_value),
        queue_(queue_cap) {}

  ~MultiSlotFeed() { Stop(); }

  void Start() {
    file_cursor_ = 0;
    for (int t = 0; t < n_threads_; ++t) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
    closer_ = std::thread([this] {
      for (auto& w : workers_) w.join();
      FlushPartial();
      queue_.MarkDone();
    });
  }

  std::unique_ptr<Batch> Next() { return queue_.Pop(); }

  void Stop() {
    stop_.store(true);
    queue_.Close(true);
    if (closer_.joinable()) closer_.join();
    workers_.clear();
  }

 private:
  void WorkerLoop() {
    for (int e = 0; e < epochs_ && !stop_.load(); ++e) {
      while (!stop_.load()) {
        size_t i = file_cursor_.fetch_add(1);
        size_t n = files_.size();
        if (i >= n * (size_t)(e + 1)) {
          // crude epoch boundary: cursor is global; recompute per epoch
          file_cursor_.fetch_sub(1);
          break;
        }
        ReadFile(files_[i % n]);
      }
    }
  }

  void ReadFile(const std::string& path) {
    std::ifstream in(path);
    if (!in.good()) return;
    std::string line;
    std::vector<Example> local;
    local.reserve(batch_size_);
    while (std::getline(in, line) && !stop_.load()) {
      Example ex;
      if (!ParseLine(line, &ex)) continue;
      local.push_back(std::move(ex));
      if ((int)local.size() == batch_size_) {
        EmitBatch(local);
        local.clear();
      }
    }
    if (!local.empty()) {
      std::lock_guard<std::mutex> lk(partial_mu_);
      for (auto& e : local) partial_.push_back(std::move(e));
      while ((int)partial_.size() >= batch_size_) {
        std::vector<Example> b(
            std::make_move_iterator(partial_.begin()),
            std::make_move_iterator(partial_.begin() + batch_size_));
        partial_.erase(partial_.begin(), partial_.begin() + batch_size_);
        EmitBatch(b);
      }
    }
  }

  bool ParseLine(const std::string& line, Example* ex) {
    std::istringstream ss(line);
    ex->ints.resize(slots_.size());
    ex->floats.resize(slots_.size());
    for (size_t s = 0; s < slots_.size(); ++s) {
      long long cnt;
      if (!(ss >> cnt) || cnt < 0) return false;
      if (slots_[s].type == kInt64) {
        auto& v = ex->ints[s];
        v.reserve(cnt);
        for (long long j = 0; j < cnt; ++j) {
          long long x;
          if (!(ss >> x)) return false;
          v.push_back((int64_t)x);
        }
      } else {
        auto& v = ex->floats[s];
        v.reserve(cnt);
        for (long long j = 0; j < cnt; ++j) {
          float x;
          if (!(ss >> x)) return false;
          v.push_back(x);
        }
      }
    }
    return true;
  }

  void EmitBatch(const std::vector<Example>& exs) {
    auto b = std::make_unique<Batch>();
    b->rows = (int)exs.size();
    b->int_data.resize(slots_.size());
    b->float_data.resize(slots_.size());
    for (size_t s = 0; s < slots_.size(); ++s) {
      int w = slots_[s].width;
      if (slots_[s].type == kInt64) {
        auto& out = b->int_data[s];
        out.assign((size_t)b->rows * w, pad_value_);
        for (int r = 0; r < b->rows; ++r) {
          const auto& v = exs[r].ints[s];
          int n = std::min((int)v.size(), w);
          std::memcpy(out.data() + (size_t)r * w, v.data(),
                      n * sizeof(int64_t));
        }
      } else {
        auto& out = b->float_data[s];
        out.assign((size_t)b->rows * w, 0.0f);
        for (int r = 0; r < b->rows; ++r) {
          const auto& v = exs[r].floats[s];
          int n = std::min((int)v.size(), w);
          std::memcpy(out.data() + (size_t)r * w, v.data(), n * sizeof(float));
        }
      }
    }
    queue_.Push(std::move(b));
  }

  void FlushPartial() {
    std::lock_guard<std::mutex> lk(partial_mu_);
    if (partial_.empty()) return;
    EmitBatch(partial_);
    partial_.clear();
  }

  std::vector<std::string> files_;
  int batch_size_;
  std::vector<SlotSpec> slots_;
  int n_threads_;
  int epochs_;
  int64_t pad_value_;
  BlockingQueue queue_;
  std::vector<std::thread> workers_;
  std::thread closer_;
  std::atomic<size_t> file_cursor_{0};
  std::atomic<bool> stop_{false};
  std::mutex partial_mu_;
  std::vector<Example> partial_;
};

}  // namespace

extern "C" {

void* mdf_create(const char* files_csv, int batch_size, int n_slots,
                 const int* types, const int* widths, int n_threads,
                 int epochs, long long pad_value, int queue_cap) {
  std::vector<std::string> files;
  std::string cur;
  for (const char* p = files_csv;; ++p) {
    if (*p == ',' || *p == '\0') {
      if (!cur.empty()) files.push_back(cur);
      cur.clear();
      if (*p == '\0') break;
    } else {
      cur.push_back(*p);
    }
  }
  std::vector<SlotSpec> slots(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    slots[i].type = types[i] == 0 ? kInt64 : kFloat32;
    slots[i].width = widths[i];
  }
  return new MultiSlotFeed(std::move(files), batch_size, std::move(slots),
                           n_threads, epochs, (int64_t)pad_value,
                           (size_t)queue_cap);
}

void mdf_start(void* h) { static_cast<MultiSlotFeed*>(h)->Start(); }

void* mdf_next_batch(void* h) {
  return static_cast<MultiSlotFeed*>(h)->Next().release();
}

int mdf_batch_rows(void* b) { return static_cast<Batch*>(b)->rows; }

const void* mdf_batch_data(void* b, int slot, int is_int) {
  auto* batch = static_cast<Batch*>(b);
  if (is_int) return batch->int_data[slot].data();
  return batch->float_data[slot].data();
}

void mdf_batch_free(void* b) { delete static_cast<Batch*>(b); }

void mdf_destroy(void* h) { delete static_cast<MultiSlotFeed*>(h); }

}  // extern "C"

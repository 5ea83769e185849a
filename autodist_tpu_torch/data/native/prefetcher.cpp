// Native data pipeline: threaded shuffling batch loader over a memory-mapped
// record file, feeding a bounded ring of ready batches.
//
// Role parity: the reference leans on TensorFlow's C++ input stack
// (FIFOQueue/iterator ops, /root/reference/autodist/kernel/common/op_info.py:119-149)
// for feed-side throughput; this is the framework's own native equivalent —
// batch assembly runs in C++ worker threads (no GIL), the Python side only
// hands out ready buffers.
//
// File format: flat binary of fixed-size records (sample_bytes each).
// Epoch shuffling: Fisher-Yates over the index array, per-epoch seed.
//
// Sharded (per-host) loading: loader_create_ex takes (shard_index,
// shard_count) and the loader sees ONLY its contiguous stripe of the
// record file — records [shard_index*per, (shard_index+1)*per) where
// per = file_records / shard_count (trailing remainder records are
// dropped so every shard has identical batch geometry).  Read accounting
// (loader_stats) lets callers assert a process never touched records
// outside its stripe.
//
// Block shuffle (flags bit 0): the per-epoch permutation runs over
// CONTIGUOUS batch-sized blocks instead of individual records.  A batch
// is then one contiguous mmap range, which enables the zero-copy path:
// loader_next_view hands out a POINTER into the mmap (no memcpy at all)
// and the next block in the epoch gets an madvise(WILLNEED) readahead
// hint.  Shuffle granularity drops to blocks (records within a block
// keep file order) — the standard sequential-I/O trade.
//
// C ABI (consumed via ctypes from autodist_tpu/data/loader.py):
//   loader_create(path, sample_bytes, batch_size, capacity, seed, threads)
//   loader_create_ex(..., shard_index, shard_count, flags)
//   loader_next(handle, out_buf)   -> 0 ok, <0 error; blocks until ready
//   loader_next_view(handle, &ptr) -> 0 ok, -4 not in block mode
//   loader_next_async(handle, out_buf) -> 0 accepted, -2 ring full
//   loader_next_wait(handle)       -> oldest job's rc; -3 no job queued
//   loader_num_samples(handle)     -> records in THIS shard's stripe
//   loader_stats(handle, int64[3]) -> {records_read, min_idx, max_idx}
//   loader_destroy(handle)
//
// next_async/next_wait: a bounded FIFO ring of assemblies running on a
// dedicated native (GIL-free) thread.  The consumer queues up to
// `capacity` caller-owned buffers (a Python-side buffer pool recycles
// them) and collects results strictly in submission order — batch
// assembly overlaps the consumer's transfer-issue/poll/dispatch work
// instead of serializing in front of the wire.  Depth 1 reproduces the
// original single-slot software pipeline.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int kFlagBlockShuffle = 1;

struct Batch {
  std::vector<uint8_t> data;
};

class Loader {
 public:
  Loader(const char* path, int64_t sample_bytes, int64_t batch_size,
         int64_t capacity, uint64_t seed, int num_threads,
         int64_t shard_index, int64_t shard_count, int flags)
      : sample_bytes_(sample_bytes),
        batch_size_(batch_size),
        capacity_(capacity > 0 ? capacity : 4),
        seed_(seed),
        block_shuffle_((flags & kFlagBlockShuffle) != 0) {
    fd_ = open(path, O_RDONLY);
    if (fd_ < 0) { ok_ = false; return; }
    struct stat st;
    if (fstat(fd_, &st) != 0) { ok_ = false; return; }
    file_bytes_ = static_cast<int64_t>(st.st_size);
    const int64_t file_samples = file_bytes_ / sample_bytes_;
    if (shard_count < 1 || shard_index < 0 || shard_index >= shard_count) {
      ok_ = false;
      return;
    }
    // Contiguous per-shard stripe; equal size per shard (floor), trailing
    // remainder dropped so every host sees identical batch geometry.
    const int64_t per = file_samples / shard_count;
    shard_lo_ = shard_index * per;
    num_samples_ = per;
    if (num_samples_ < batch_size_) { ok_ = false; return; }
    base_ = static_cast<const uint8_t*>(
        mmap(nullptr, file_bytes_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (base_ == MAP_FAILED) { ok_ = false; return; }
    // Readahead hint over this shard's stripe only: a host must not fault
    // in the other shards' pages.
    madvise(const_cast<uint8_t*>(base_ + shard_lo_ * sample_bytes_),
            num_samples_ * sample_bytes_, MADV_WILLNEED);
    // num_threads == 0: synchronous mode — Next() assembles the batch in
    // the calling thread, straight from the mmap into the caller's buffer
    // (no ring, no extra copy).  On single-core hosts worker threads only
    // timeshare against the consumer (and the accelerator runtime's own
    // processes), so zero threads is the fast configuration there.
    for (int t = 0; t < num_threads; ++t) {
      workers_.emplace_back([this, t] { WorkerLoop(t); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(amu_);
      astop_ = true;
    }
    acv_.notify_all();
    if (athread_.joinable()) athread_.join();
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& w : workers_) w.join();
    if (base_ && base_ != MAP_FAILED) {
      munmap(const_cast<uint8_t*>(base_), file_bytes_);
    }
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }
  int64_t num_samples() const { return num_samples_; }
  int64_t batch_bytes() const { return sample_bytes_ * batch_size_; }

  // Blocks until a batch is ready; copies it into out.
  int Next(uint8_t* out) {
    if (block_shuffle_) {
      const uint8_t* src = NextBlock();
      if (src == nullptr) return -1;
      std::memcpy(out, src, batch_bytes());
      return 0;
    }
    if (workers_.empty()) {  // synchronous mode
      const int64_t batches_per_epoch = num_samples_ / batch_size_;
      int64_t ticket = next_ticket_.fetch_add(1);
      int64_t epoch = ticket / batches_per_epoch;
      int64_t slot = ticket % batches_per_epoch;
      // mu_ guards sync_perm_ against concurrent consumers (the threaded
      // mode's Next() is mutex-guarded too; uncontended lock is ~ns).
      std::lock_guard<std::mutex> lk(mu_);
      RefreshPerm(sync_perm_, sync_perm_epoch_, epoch, num_samples_);
      for (int64_t i = 0; i < batch_size_; ++i) {
        int64_t idx = shard_lo_ + sync_perm_[slot * batch_size_ + i];
        std::memcpy(out + i * sample_bytes_, base_ + idx * sample_bytes_,
                    sample_bytes_);
      }
      AccountLocked(slot * batch_size_, batch_size_, /*contiguous=*/false,
                    &sync_perm_);
      return 0;
    }
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [this] { return !ready_.empty() || stop_; });
    if (stop_ && ready_.empty()) return -1;
    Batch b = std::move(ready_.front());
    ready_.pop_front();
    lk.unlock();
    // notify_all: workers wait on per-ticket predicates, so notify_one
    // could wake one whose turn it isn't and strand the right one.
    cv_space_.notify_all();
    std::memcpy(out, b.data.data(), b.data.size());
    return 0;
  }

  // Zero-copy hand-out (block-shuffle mode only): *out points at the
  // batch's contiguous bytes inside the mmap.  The pointer stays valid
  // until loader_destroy; records keep file order within the block.
  int NextView(const uint8_t** out) {
    if (!block_shuffle_) return -4;
    const uint8_t* src = NextBlock();
    if (src == nullptr) return -1;
    *out = src;
    return 0;
  }

  // Queue ONE assembly of the next batch into `out` on the async thread
  // (lazily started).  Up to `capacity` jobs ride the FIFO ring; results
  // are collected strictly in submission order via NextWait.  Returns 0
  // if accepted, -2 if the ring is full.
  int NextAsync(uint8_t* out) {
    std::lock_guard<std::mutex> lk(amu_);
    if (static_cast<int64_t>(ajobs_.size()) >= capacity_) return -2;
    if (!athread_.joinable()) {
      athread_ = std::thread([this] { AsyncLoop(); });
    }
    ajobs_.push_back(AJob{out, kQueued, 0});
    acv_.notify_all();
    return 0;
  }

  // Block until the OLDEST queued assembly finishes and pop it; returns
  // its result code, or -3 when no job is queued / torn down mid-job.
  int NextWait() {
    std::unique_lock<std::mutex> lk(amu_);
    if (ajobs_.empty()) return -3;
    acv_done_.wait(lk, [this] {
      return ajobs_.front().state == kDone || astop_;
    });
    if (ajobs_.front().state != kDone) return -3;  // torn down mid-job
    int r = ajobs_.front().result;
    ajobs_.pop_front();
    return r;
  }

  int64_t AsyncPending() {
    std::lock_guard<std::mutex> lk(amu_);
    return static_cast<int64_t>(ajobs_.size());
  }

  // {records_read, min_global_idx, max_global_idx}; min/max are -1 when
  // nothing has been read yet.
  void Stats(int64_t out[3]) {
    std::lock_guard<std::mutex> lk(mu_);
    out[0] = records_read_;
    out[1] = min_idx_;
    out[2] = max_idx_;
  }

 private:
  enum AState { kQueued, kRunning, kDone };
  struct AJob {
    uint8_t* out;
    AState state;
    int result;
  };

  void AsyncLoop() {
    std::unique_lock<std::mutex> lk(amu_);
    while (true) {
      acv_.wait(lk, [this] { return FirstQueued() != nullptr || astop_; });
      if (astop_) return;
      AJob* j = FirstQueued();  // deque refs stay valid across push/pop
      j->state = kRunning;
      uint8_t* out = j->out;
      lk.unlock();
      int r = Next(out);  // same path as the sync API: ticket + perm + copy
      lk.lock();
      j->state = kDone;
      j->result = r;
      acv_done_.notify_all();
    }
  }

  AJob* FirstQueued() {
    // Jobs run strictly FIFO, so the first non-done job is either running
    // (nothing to pick) or queued (next to run).
    for (auto& j : ajobs_) {
      if (j.state == kQueued) return &j;
      if (j.state == kRunning) return nullptr;
    }
    return nullptr;
  }

  // Hand out the next contiguous block (block-shuffle mode), with an
  // madvise readahead hint for the epoch's next block.
  const uint8_t* NextBlock() {
    const int64_t bpe = num_samples_ / batch_size_;
    int64_t ticket = next_ticket_.fetch_add(1);
    int64_t epoch = ticket / bpe;
    int64_t slot = ticket % bpe;
    std::lock_guard<std::mutex> lk(mu_);
    RefreshPerm(block_perm_, block_perm_epoch_, epoch, bpe);
    const int64_t block = block_perm_[slot];
    const int64_t first = block * batch_size_;  // stripe-local record idx
    AccountLocked(first, batch_size_, /*contiguous=*/true, nullptr);
    if (slot + 1 < bpe) {  // prefetch hint: next block this epoch
      const int64_t nxt = block_perm_[slot + 1] * batch_size_;
      madvise(const_cast<uint8_t*>(
                  base_ + (shard_lo_ + nxt) * sample_bytes_),
              batch_bytes(), MADV_WILLNEED);
    }
    return base_ + (shard_lo_ + first) * sample_bytes_;
  }

  // Recompute a shuffled index array when `epoch` changes (identical in
  // every worker from the shared seed).  `n` is the permutation length:
  // records per epoch (record shuffle) or blocks per epoch (block mode).
  void RefreshPerm(std::vector<int64_t>& perm, int64_t& perm_epoch,
                   int64_t epoch, int64_t n) {
    if (epoch == perm_epoch) return;
    perm.resize(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    std::mt19937_64 rng(seed_ + static_cast<uint64_t>(epoch));
    for (int64_t i = n - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(perm[i], perm[d(rng)]);
    }
    perm_epoch = epoch;
  }

  // Read accounting (mu_ held).  `first` is a stripe-local record index;
  // contiguous runs cover [first, first+count), permuted reads record the
  // touched perm entries.
  void AccountLocked(int64_t first, int64_t count, bool contiguous,
                     const std::vector<int64_t>* perm) {
    records_read_ += count;
    if (contiguous) {
      const int64_t lo = shard_lo_ + first;
      const int64_t hi = shard_lo_ + first + count - 1;
      if (min_idx_ < 0 || lo < min_idx_) min_idx_ = lo;
      if (hi > max_idx_) max_idx_ = hi;
    } else {
      for (int64_t i = 0; i < count; ++i) {
        const int64_t g = shard_lo_ + (*perm)[first + i];
        if (min_idx_ < 0 || g < min_idx_) min_idx_ = g;
        if (g > max_idx_) max_idx_ = g;
      }
    }
  }

  // Each worker claims the next global batch index; batches are assembled
  // from the epoch's shuffled index array (recomputed per epoch, identical
  // in every worker from the shared seed).
  void WorkerLoop(int /*tid*/) {
    const int64_t batches_per_epoch = num_samples_ / batch_size_;
    std::vector<int64_t> perm;
    int64_t perm_epoch = -1;
    while (true) {
      int64_t ticket = next_ticket_.fetch_add(1);
      int64_t epoch = ticket / batches_per_epoch;
      int64_t slot = ticket % batches_per_epoch;
      RefreshPerm(perm, perm_epoch, epoch, num_samples_);
      Batch b;
      b.data.resize(batch_bytes());
      for (int64_t i = 0; i < batch_size_; ++i) {
        int64_t idx = shard_lo_ + perm[slot * batch_size_ + i];
        std::memcpy(b.data.data() + i * sample_bytes_,
                    base_ + idx * sample_bytes_, sample_bytes_);
      }
      {
        // Deliver strictly in ticket order: a worker that finished batch
        // t waits until every batch < t has been handed out, so epochs
        // never interleave ("full shuffled permutation per epoch" holds
        // for any num_threads).
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this, ticket] {
          return (next_deliver_ == ticket &&
                  static_cast<int64_t>(ready_.size()) < capacity_) ||
                 stop_;
        });
        if (stop_) return;
        ready_.push_back(std::move(b));
        ++next_deliver_;
        AccountLocked(slot * batch_size_, batch_size_, /*contiguous=*/false,
                      &perm);
      }
      // notify_all: other workers wait on distinct ticket predicates.
      cv_space_.notify_all();
      cv_ready_.notify_one();
    }
  }

  int64_t sample_bytes_, batch_size_, capacity_;
  uint64_t seed_;
  bool block_shuffle_ = false;
  int fd_ = -1;
  int64_t file_bytes_ = 0, num_samples_ = 0, shard_lo_ = 0;
  const uint8_t* base_ = nullptr;
  bool ok_ = true;

  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::deque<Batch> ready_;
  std::vector<int64_t> sync_perm_;   // synchronous record mode only
  int64_t sync_perm_epoch_ = -1;     // synchronous record mode only
  std::vector<int64_t> block_perm_;  // block-shuffle mode only
  int64_t block_perm_epoch_ = -1;    // block-shuffle mode only
  std::atomic<int64_t> next_ticket_{0};
  int64_t next_deliver_ = 0;  // guarded by mu_
  int64_t records_read_ = 0, min_idx_ = -1, max_idx_ = -1;  // guarded by mu_
  bool stop_ = false;
  std::vector<std::thread> workers_;

  // Multi-slot async assembly ring (all guarded by amu_).
  std::mutex amu_;
  std::condition_variable acv_, acv_done_;
  std::thread athread_;
  std::deque<AJob> ajobs_;
  bool astop_ = false;
};

}  // namespace

extern "C" {

void* loader_create_ex(const char* path, int64_t sample_bytes,
                       int64_t batch_size, int64_t capacity, uint64_t seed,
                       int num_threads, int64_t shard_index,
                       int64_t shard_count, int flags) {
  auto* l = new Loader(path, sample_bytes, batch_size, capacity, seed,
                       num_threads, shard_index, shard_count, flags);
  if (!l->ok()) { delete l; return nullptr; }
  return l;
}

void* loader_create(const char* path, int64_t sample_bytes,
                    int64_t batch_size, int64_t capacity, uint64_t seed,
                    int num_threads) {
  return loader_create_ex(path, sample_bytes, batch_size, capacity, seed,
                          num_threads, 0, 1, 0);
}

int loader_next(void* handle, uint8_t* out) {
  return static_cast<Loader*>(handle)->Next(out);
}

int loader_next_view(void* handle, const uint8_t** out) {
  return static_cast<Loader*>(handle)->NextView(out);
}

int loader_next_async(void* handle, uint8_t* out) {
  return static_cast<Loader*>(handle)->NextAsync(out);
}

int loader_next_wait(void* handle) {
  return static_cast<Loader*>(handle)->NextWait();
}

int64_t loader_async_pending(void* handle) {
  return static_cast<Loader*>(handle)->AsyncPending();
}

int64_t loader_num_samples(void* handle) {
  return static_cast<Loader*>(handle)->num_samples();
}

void loader_stats(void* handle, int64_t out[3]) {
  static_cast<Loader*>(handle)->Stats(out);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

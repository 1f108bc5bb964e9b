// Host-side open-addressing hash map for on-the-fly vocabulary building.
//
// The port's copy of distributed_embeddings_tpu/native/hashmap.cpp, built
// into the port's own library (native/loader.py). The original library
// kept this map on the GPU with cuCollections (reference:
// cc/kernels/embedding_lookup_kernels.cu:383-516); the JAX package runs
// it on the host, called through ctypes, and keeps the device side a
// plain gather, and so does the port. Matches the reference's semantics:
// index 0 reserved for OOV, capacity = max_tokens + 1, per-key frequency
// counts, 1.5x slot load factor.

#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;          // sentinel for empty slot
constexpr int64_t kTombstone = INT64_MIN + 1;  // erased slot (probe through)

// The two slot sentinels are RESERVED key values: a user key equal to
// either would corrupt probe chains (its occupied slot would read as
// empty/erased and be silently overwritten). Both map to OOV instead —
// the same graceful answer a full table gives (the numpy backend
// mirrors this; the Python layer documents the reservation).
inline bool reserved_key(int64_t key) {
  return key == kEmpty || key == kTombstone;
}

struct IntegerLookupMap {
  int64_t capacity;    // max distinct keys + 1 (index 0 = OOV)
  int64_t num_slots;   // power of two >= 1.5 * capacity
  int64_t mask;
  int64_t size;        // number of LIVE keys (erases decrement)
  int64_t tombstones;  // erased slots awaiting reuse/rehash
  std::vector<int64_t> slot_keys;
  std::vector<int64_t> slot_vals;      // index assigned to the key
  std::vector<int64_t> keys_by_index;  // reverse map: index-1 -> key
                                       // (kEmpty hole for erased indices)
  std::vector<int64_t> counts;         // per-index frequency (index 0 = OOV)
  std::vector<int64_t> free_idx;       // erased indices, reused LIFO

  explicit IntegerLookupMap(int64_t cap)
      : capacity(cap), size(0), tombstones(0) {
    int64_t want = static_cast<int64_t>(cap * 3 / 2) + 2;
    num_slots = 16;
    while (num_slots < want) num_slots <<= 1;
    mask = num_slots - 1;
    slot_keys.assign(num_slots, kEmpty);
    slot_vals.assign(num_slots, 0);
    keys_by_index.reserve(capacity);
    counts.assign(capacity, 0);
  }

  static inline uint64_t hash(int64_t key) {
    // splitmix64 finalizer
    uint64_t x = static_cast<uint64_t>(key) + 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
  }

  inline int64_t find(int64_t key) const {
    if (reserved_key(key)) return 0;  // -> OOV
    uint64_t h = hash(key) & mask;
    while (true) {
      int64_t k = slot_keys[h];
      if (k == key) return slot_vals[h];
      if (k == kEmpty) return -1;  // tombstones probe through
      h = (h + 1) & mask;
    }
  }

  inline int64_t find_or_insert(int64_t key) {
    if (reserved_key(key)) return 0;  // -> OOV, never stored
    uint64_t h = hash(key) & mask;
    int64_t first_tomb = -1;
    while (true) {
      int64_t k = slot_keys[h];
      if (k == key) return slot_vals[h];
      if (k == kTombstone && first_tomb < 0) {
        first_tomb = static_cast<int64_t>(h);
      } else if (k == kEmpty) {
        if (size >= capacity - 1) return 0;  // table full -> OOV
        // indices: reuse an erased one (eviction freed its row slot)
        // before minting past the high-water mark
        int64_t idx;
        if (!free_idx.empty()) {
          idx = free_idx.back();
          free_idx.pop_back();
          keys_by_index[idx - 1] = key;
        } else {
          idx = static_cast<int64_t>(keys_by_index.size()) + 1;
          keys_by_index.push_back(key);
        }
        ++size;
        if (first_tomb >= 0) {
          h = static_cast<uint64_t>(first_tomb);
          --tombstones;
        }
        slot_keys[h] = key;
        slot_vals[h] = idx;
        // the probe loops terminate only on a kEmpty slot, so SOME
        // kEmpty slots must always survive: inserts that land on a
        // kEmpty slot (not a reused tombstone) consume one, and must
        // uphold the same occupancy bound erase() does — without this,
        // churn whose inserts keep missing the tombstones can fill the
        // last empty slot and the next absent-key lookup spins forever
        if (first_tomb < 0 && tombstones + size > (num_slots * 7) / 8)
          rehash();
        return idx;
      }
      h = (h + 1) & mask;
    }
  }

  // Erase a key: its index is freed for reuse, its slot becomes a
  // tombstone (probe chains through it stay intact), its frequency
  // count resets (a future key bound to this index must not inherit
  // it). Returns the freed index, 0 if the key was not present.
  inline int64_t erase(int64_t key) {
    if (reserved_key(key)) return 0;
    uint64_t h = hash(key) & mask;
    while (true) {
      int64_t k = slot_keys[h];
      if (k == key) {
        int64_t idx = slot_vals[h];
        slot_keys[h] = kTombstone;
        slot_vals[h] = 0;
        ++tombstones;
        keys_by_index[idx - 1] = kEmpty;
        counts[idx] = 0;
        free_idx.push_back(idx);
        --size;
        // erase-heavy churn can fill every kEmpty slot with tombstones,
        // degrading probes toward O(num_slots); rebuild from the live
        // reverse map well before that (live keys are bounded by
        // capacity <= 2/3 num_slots, so post-rehash load stays sane)
        if (tombstones + size > (num_slots * 7) / 8) rehash();
        return idx;
      }
      if (k == kEmpty) return 0;
      h = (h + 1) & mask;
    }
  }

  void rehash() {
    std::fill(slot_keys.begin(), slot_keys.end(), kEmpty);
    std::fill(slot_vals.begin(), slot_vals.end(), 0);
    tombstones = 0;
    for (size_t i = 0; i < keys_by_index.size(); ++i) {
      int64_t key = keys_by_index[i];
      if (key == kEmpty) continue;
      uint64_t h = hash(key) & mask;
      while (slot_keys[h] != kEmpty) h = (h + 1) & mask;
      slot_keys[h] = key;
      slot_vals[h] = static_cast<int64_t>(i) + 1;
    }
  }
};

// Persistent worker pool for the per-batch probe parallelism. The previous
// implementation spawned std::thread per batch (~10us each) — measurable
// against a ~1ms 16k-key probe, and paid on EVERY lookup call. Workers here
// are created once (lazily, hardware_concurrency - 1 of them: the caller
// always runs chunk 0 itself) and parked on a condition variable between
// batches; dispatch cost is one lock + notify (~1us).
//
// The pool object is intentionally leaked: the library is loaded via ctypes
// and never dlclosed, and joining detached workers from a static destructor
// during interpreter teardown is a known crash source. Workers exit with
// the process.
class WorkerPool {
 public:
  static WorkerPool& instance() {
    static WorkerPool* pool = new WorkerPool();  // leaked by design
    return *pool;
  }

  // Run fn(worker_index) on `nt - 1` pool workers (indices 1..nt-1) while
  // the caller runs index 0; returns when all are done. Serialized per
  // process (one batch in flight) — callers already hold the Python-side
  // map lock, and a single pool avoids oversubscribing the host.
  void run(int nt, const std::function<void(int)>& fn) {
    std::unique_lock<std::mutex> lk(run_mu_);
    // fork safety: a child inherits this object but none of its worker
    // THREADS — dispatching to them would wait on done_cv_ forever.
    // Workers are (re)spawned lazily on the first run() in each process
    // (also avoids paying hw-1 thread spawns in processes that only ever
    // do small single-threaded lookups). Residual risk: forking WHILE
    // another thread is inside a lookup is UB (inherited locked mutexes)
    // — the Python wrapper's per-map lock makes that a caller bug.
    if (pid_ != getpid()) {
      threads_.clear();  // detached std::threads: clearing is safe
      generation_ = 0;
      active_ = 0;
      task_workers_ = 0;
      for (int i = 0; i < max_workers_; ++i) {
        threads_.emplace_back([this, i] { Loop(i + 1); });
        threads_.back().detach();  // leaked pool: never joined
      }
      pid_ = getpid();
    }
    int workers = nt - 1;
    if (workers > static_cast<int>(threads_.size()))
      workers = static_cast<int>(threads_.size());
    if (workers > 0) {
      {
        std::lock_guard<std::mutex> g(mu_);
        task_ = &fn;
        task_workers_ = workers;
        active_ = workers;
        ++generation_;
      }
      cv_.notify_all();
    }
    fn(0);
    if (workers > 0) {
      std::unique_lock<std::mutex> g(mu_);
      done_cv_.wait(g, [&] { return active_ == 0; });
      task_ = nullptr;
    }
  }

  // Potential parallelism (caller + workers); workers spawn lazily on the
  // first run() so small-batch-only processes never pay the thread spawns.
  int max_threads() const { return max_workers_ + 1; }

 private:
  WorkerPool() {
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    max_workers_ = hw > 1 ? hw - 1 : 0;
    if (max_workers_ > 31) max_workers_ = 31;  // caller + 31 = old 32 cap
  }

  void Loop(int index) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* task = nullptr;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [&] { return generation_ != seen; });
        seen = generation_;
        // not needed for this batch: only participants (index <=
        // task_workers_) touch active_, so just go back to sleep
        if (index > task_workers_) continue;
        task = task_;
      }
      (*task)(index);
      {
        std::lock_guard<std::mutex> g(mu_);
        if (--active_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex run_mu_;  // one batch in flight at a time
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int)>* task_ = nullptr;
  int task_workers_ = 0;
  int active_ = 0;
  int max_workers_ = 0;
  pid_t pid_ = -1;   // owner process: workers respawn lazily after fork
  uint64_t generation_ = 0;
  std::vector<std::thread> threads_;
};

// Threads for an n-key batch. With the persistent pool, dispatch is ~1us
// (vs ~10us+ per spawned thread before), but parallel probing also fights
// cache sharing and the relaxed atomic hit-count adds on hot power-law
// keys — measured on the 2-vCPU reference host (docs/parity.md), the
// multi-thread probe only breaks even around 64k keys/batch and loses
// below it (e.g. 15.3 vs 18.9 M keys/s at 16k). So: single thread under
// 64k keys, then >=32k keys per thread, capped by the pool size.
inline int threads_for(int64_t n) {
  int hw = WorkerPool::instance().max_threads();
  if (hw <= 1 || n < (1 << 16)) return 1;
  int64_t want = n >> 15;  // ~32k keys per thread minimum
  if (want > hw) want = hw;
  if (want > 32) want = 32;
  return static_cast<int>(want);
}

template <typename Fn>
inline void parallel_chunks(int64_t n, Fn fn) {
  int nt = threads_for(n);
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  int64_t chunk = (n + nt - 1) / nt;
  WorkerPool::instance().run(nt, [&](int t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo < hi) fn(lo, hi);
  });
}

}  // namespace

extern "C" {

void* il_create(int64_t capacity) { return new IntegerLookupMap(capacity); }

void il_destroy(void* handle) {
  delete static_cast<IntegerLookupMap*>(handle);
}

int64_t il_size(void* handle) {
  return static_cast<IntegerLookupMap*>(handle)->size;
}

// Two-phase batch insert: phase 1 probes read-only IN PARALLEL (callers
// are serialized per map — the Python wrapper holds a lock across each
// call, so no writer is ever concurrent with the probe and plain reads of
// slot_keys/slot_vals are race-free; hit counts use relaxed atomic adds),
// phase 2 inserts the misses
// SEQUENTIALLY in batch order — preserving the exact first-appearance
// id-assignment contract of the sequential map (the property
// get_vocabulary() and the keras-parity tests pin). After vocabulary
// warmup nearly every key is a hit, so the parallel phase is ~all of the
// work; the reference gets the same effect from a massively-parallel GPU
// probe (embedding_lookup_kernels.cu:383-516).
void il_lookup_or_insert(void* handle, const int64_t* keys, int64_t n,
                         int64_t* out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  int64_t* counts = m->counts.data();
  parallel_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t idx = m->find(keys[i]);
      out[i] = idx;
      if (idx >= 0) __atomic_fetch_add(&counts[idx], 1, __ATOMIC_RELAXED);
    }
  });
  for (int64_t i = 0; i < n; ++i) {
    if (out[i] < 0) {
      int64_t idx = m->find_or_insert(keys[i]);
      out[i] = idx;
      counts[idx] += 1;
    }
  }
}

void il_lookup(void* handle, const int64_t* keys, int64_t n, int64_t* out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  parallel_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t idx = m->find(keys[i]);
      out[i] = idx < 0 ? 0 : idx;
    }
  });
}

// keys_out must have room for il_high_water() entries (index order,
// 1-based indices: keys_out[i] is the key mapped to index i+1; erased
// indices export INT64_MIN holes). high_water == size when no key was
// ever erased, so pre-erase callers see the original contract.
void il_export_keys(void* handle, int64_t* keys_out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  std::memcpy(keys_out, m->keys_by_index.data(),
              sizeof(int64_t) * m->keys_by_index.size());
}

// Highest index ever assigned (= export_keys entry count).
int64_t il_high_water(void* handle) {
  return static_cast<int64_t>(
      static_cast<IntegerLookupMap*>(handle)->keys_by_index.size());
}

// Erase keys (eviction): out[i] = the freed index, 0 if the key
// was not bound. Sequential — erase batches are eviction-sized (small),
// and the tombstone/rehash writes need no probe parallelism.
void il_erase(void* handle, const int64_t* keys, int64_t n, int64_t* out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  for (int64_t i = 0; i < n; ++i) out[i] = m->erase(keys[i]);
}

// Number of freed (reusable) indices.
int64_t il_free_count(void* handle) {
  return static_cast<int64_t>(
      static_cast<IntegerLookupMap*>(handle)->free_idx.size());
}

// free_out must have room for il_free_count() entries; exported in
// reuse order (the LAST entry is the next index lookup_or_insert mints).
void il_export_free(void* handle, int64_t* free_out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  std::memcpy(free_out, m->free_idx.data(),
              sizeof(int64_t) * m->free_idx.size());
}

// counts_out must have room for capacity entries (index 0 = OOV count).
void il_export_counts(void* handle, int64_t* counts_out) {
  auto* m = static_cast<IntegerLookupMap*>(handle);
  std::memcpy(counts_out, m->counts.data(), sizeof(int64_t) * m->capacity);
}

}  // extern "C"

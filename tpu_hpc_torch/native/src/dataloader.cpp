// Native host-side data pipeline: deterministic synthetic ERA5-like
// batch generation + a threaded prefetch ring.
// (The JAX package keeps the same source beside its loader,
// tpu_hpc/native/src/dataloader.cpp; the PyTorch port builds this copy.)
//
// Role parity: the reference's hot-loop input path is
// DataLoader(pin_memory=True, num_workers=4) feeding H2D copies
// (multinode_ddp_unet.py:283-292,334-339) -- CPython worker processes
// around native torch collate kernels. Here the same layer is a small
// C++ library driven through ctypes: worker threads generate batches
// ahead of the training loop into a bounded ring so the host never
// stalls the device queue. The on-device (traced) generator in
// models/datasets.py stays the fast path for synthetic data; this is
// the host path a real-dataset loader would extend (file readers drop
// in where gen_batch() is).
//
// Determinism contract (matches models/datasets.py's index-stateless
// design): batch contents depend only on (seed, step), never on thread
// scheduling -- each step's batch is generated wholly by one worker
// from a splitmix64-derived per-step stream.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// splitmix64: seed -> well-mixed 64-bit stream key.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// xoshiro256** -- fast, high-quality, per-step-seeded.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (auto& si : s) si = x = splitmix64(x);
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in (0, 1]: never 0, so log() below is safe.
  inline double uniform() {
    return ((next() >> 11) + 1) * (1.0 / 9007199254740993.0);
  }
};

struct GenConfig {
  int64_t batch, lat, lon, ch;
  uint64_t seed;
  int64_t elems() const { return batch * lat * lon * ch; }
};

// Deterministic (seed, step) -> (x, y) batch. y = 0.5x + 0.1*noise,
// the same learnable-signal scheme as datasets.ERA5Synthetic._gen.
void gen_batch(const GenConfig& cfg, int64_t step, float* x, float* y) {
  Rng rng(splitmix64(cfg.seed ^ splitmix64(static_cast<uint64_t>(step))));
  const int64_t n = cfg.elems();
  // Box-Muller, two normals per round.
  for (int64_t i = 0; i < n; i += 2) {
    double u1 = rng.uniform(), u2 = rng.uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    double a = 6.283185307179586 * u2;
    x[i] = static_cast<float>(r * std::cos(a));
    if (i + 1 < n) x[i + 1] = static_cast<float>(r * std::sin(a));
  }
  for (int64_t i = 0; i < n; i += 2) {
    double u1 = rng.uniform(), u2 = rng.uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    double a = 6.283185307179586 * u2;
    y[i] = 0.5f * x[i] + 0.1f * static_cast<float>(r * std::cos(a));
    if (i + 1 < n)
      y[i + 1] = 0.5f * x[i + 1] + 0.1f * static_cast<float>(r * std::sin(a));
  }
}

struct Slot {
  int64_t step;
  std::vector<float> x, y;
};

// Bounded prefetch ring: workers claim the next step atomically,
// generate into a free slot, publish; next() pops in step order.
// The batch producer is a std::function so the same ring serves the
// synthetic generator and the file-backed reader below.
using BatchFn = std::function<void(int64_t step, float* x, float* y)>;

class Prefetcher {
 public:
  Prefetcher(GenConfig cfg, int depth, int n_threads)
      : Prefetcher(
            cfg.elems(), cfg.elems(),
            [cfg](int64_t step, float* x, float* y) {
              gen_batch(cfg, step, x, y);
            },
            depth, n_threads) {}

  Prefetcher(int64_t x_elems, int64_t y_elems, BatchFn fn, int depth,
             int n_threads)
      : x_elems_(x_elems), y_elems_(y_elems), fn_(std::move(fn)),
        depth_(depth), next_gen_(0), next_out_(0), stop_(false) {
    for (int t = 0; t < n_threads; ++t)
      workers_.emplace_back([this] { Work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_ready_.notify_all();
    for (auto& w : workers_) w.join();
  }

  // Returns 0 on success, 1 if the prefetcher is shutting down (the
  // output buffers are untouched in that case -- callers must check).
  int Next(float* x, float* y, int64_t* step_out) {
    std::unique_lock<std::mutex> lk(mu_);
    const int64_t want = next_out_++;
    cv_ready_.wait(lk, [&] { return ready_.count(want) || stop_; });
    if (!ready_.count(want)) return 1;  // stopped before it was built
    Slot slot = std::move(ready_[want]);
    ready_.erase(want);
    lk.unlock();
    cv_free_.notify_all();
    std::memcpy(x, slot.x.data(), slot.x.size() * sizeof(float));
    std::memcpy(y, slot.y.data(), slot.y.size() * sizeof(float));
    *step_out = slot.step;
    return 0;
  }

  // Resync the ring to an arbitrary step (checkpoint resume: the
  // consumer restarts at step N, the ring must follow, not keep
  // filling 0..depth-1 forever). In-flight generations from before
  // the seek are discarded on publish via the epoch tag.
  void Seek(int64_t step) {
    std::lock_guard<std::mutex> lk(mu_);
    ++epoch_;
    next_gen_ = step;
    next_out_ = step;
    ready_.clear();
    cv_free_.notify_all();
  }

 private:
  void Work() {
    for (;;) {
      int64_t step;
      uint64_t epoch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_free_.wait(lk, [&] {
          return stop_ ||
                 (next_gen_ - next_out_) < static_cast<int64_t>(depth_);
        });
        if (stop_) return;
        step = next_gen_++;
        epoch = epoch_;
      }
      Slot slot;
      slot.step = step;
      slot.x.resize(x_elems_);
      slot.y.resize(y_elems_);
      fn_(step, slot.x.data(), slot.y.data());
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (epoch == epoch_) ready_[step] = std::move(slot);
      }
      cv_ready_.notify_all();
    }
  }

  int64_t x_elems_, y_elems_;
  BatchFn fn_;
  int depth_;
  int64_t next_gen_, next_out_;
  uint64_t epoch_ = 0;
  bool stop_;
  std::mutex mu_;
  std::condition_variable cv_free_, cv_ready_;
  std::map<int64_t, Slot> ready_;
  std::vector<std::thread> workers_;
};

// ---------------------------------------------------------------------------
// File-backed dataset: mmap'd binary of fp32 (x, y) records with a
// deterministic per-epoch shuffle. This is the real-data path the
// reference gets from DataLoader(num_workers=4) over a downloaded
// dataset (resnet_fsdp_training.py:45-87) -- here the OS page cache
// plays pin_memory and the Prefetcher plays the worker pool.
//
// Format (tpu_hpc_torch/native/dataloader.py:write_dataset):
//   int64 magic  'TPUHPCD1'
//   int64 n_samples, int64 x_elems, int64 y_elems    (per sample, fp32)
//   n_samples x (x_elems + y_elems) float32 records, x then y.
// ---------------------------------------------------------------------------

constexpr uint64_t kFileMagic = 0x3144435048555054ULL;  // "TPUHPCD1" LE

// Shared mmap lifecycle for the header-plus-records file formats:
// open/fstat/mmap once, validate the magic, expose header + payload.
// Both dataset readers delegate here so corrupt-file handling (and
// fixes to it) exist exactly once.
struct MappedFile {
  int fd = -1;
  size_t size = 0;
  const uint8_t* base = nullptr;
  bool ok = false;

  void Open(const char* path, uint64_t magic, int n_header_words) {
    fd = open(path, O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0) return;
    size = static_cast<size_t>(st.st_size);
    base = static_cast<const uint8_t*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (base == MAP_FAILED) {
      base = nullptr;
      return;
    }
    const size_t hdr_bytes = n_header_words * sizeof(uint64_t);
    if (size < hdr_bytes) return;
    if (reinterpret_cast<const uint64_t*>(base)[0] != magic) return;
    ok = true;
  }

  const uint64_t* header() const {
    return reinterpret_cast<const uint64_t*>(base);
  }
  const uint8_t* payload(int n_header_words) const {
    return base + n_header_words * sizeof(uint64_t);
  }
  // Payload bytes actually present after the header.
  size_t payload_bytes(int n_header_words) const {
    return size - n_header_words * sizeof(uint64_t);
  }

  ~MappedFile() {
    if (base != nullptr && base != MAP_FAILED)
      munmap(const_cast<uint8_t*>(base), size);
    if (fd >= 0) close(fd);
  }
};


// Deterministic epoch shuffle without materialising a permutation:
// a 4-round Feistel network over [0, 2^(2w)) with cycle-walking back
// into [0, n). Bijective for every (seed, epoch), so each epoch visits
// every sample exactly once -- DistributedSampler.set_epoch semantics,
// index-stateless.
struct EpochShuffle {
  uint64_t keys[4];
  uint64_t n;
  int half_bits;
  uint64_t half_mask;

  EpochShuffle(uint64_t seed, uint64_t epoch, uint64_t n_) : n(n_) {
    uint64_t k = splitmix64(seed ^ splitmix64(epoch + 0x5eedULL));
    for (auto& key : keys) key = k = splitmix64(k);
    half_bits = 1;
    while ((1ULL << (2 * half_bits)) < n) ++half_bits;
    half_mask = (1ULL << half_bits) - 1;
  }

  uint64_t permute_once(uint64_t x) const {
    uint64_t l = x >> half_bits, r = x & half_mask;
    for (const auto& key : keys) {
      uint64_t f = splitmix64(r ^ key) & half_mask;
      uint64_t nl = r;
      r = l ^ f;
      l = nl;
    }
    return (l << half_bits) | r;
  }

  uint64_t operator()(uint64_t i) const {
    uint64_t x = permute_once(i);
    while (x >= n) x = permute_once(x);  // cycle-walk into range
    return x;
  }
};

// Per-epoch Feistel-shuffled batch fill: positions advance forever,
// reshuffling at each epoch boundary (possibly mid-batch). `copy`
// receives (shuffled_index, slot_in_batch). Shared by both readers so
// the epoch/key-schedule subtlety lives once. One key schedule per
// epoch, not per sample (a batch crosses an epoch boundary at most
// every n/batch steps).
template <typename CopyFn>
void FillShuffled(int64_t step, int64_t batch, int64_t n, uint64_t seed,
                  CopyFn copy) {
  uint64_t cur_epoch = static_cast<uint64_t>(step) * batch / n;
  EpochShuffle shuffle(seed, cur_epoch, n);
  for (int64_t b = 0; b < batch; ++b) {
    const uint64_t pos = static_cast<uint64_t>(step) * batch + b;
    const uint64_t epoch = pos / n;
    if (epoch != cur_epoch) {
      cur_epoch = epoch;
      shuffle = EpochShuffle(seed, cur_epoch, n);
    }
    copy(static_cast<int64_t>(shuffle(pos % n)), b);
  }
}

class FileDataset {
 public:
  FileDataset(const char* path, int64_t batch, uint64_t seed, int depth,
              int n_threads)
      : batch_(batch), seed_(seed) {
    map_.Open(path, kFileMagic, 4);
    if (!map_.ok) return;
    const uint64_t* hdr = map_.header();
    n_samples_ = static_cast<int64_t>(hdr[1]);
    x_elems_ = static_cast<int64_t>(hdr[2]);
    y_elems_ = static_cast<int64_t>(hdr[3]);
    if (n_samples_ <= 0 || x_elems_ < 0 || y_elems_ < 0) return;
    const uint64_t rec_bytes =
        (static_cast<uint64_t>(x_elems_) + y_elems_) * 4;
    // Overflow-safe capacity check: divide, never multiply -- a
    // corrupt header with huge counts must reject, not wrap need
    // around and SIGSEGV on the first out-of-bounds read.
    if (rec_bytes == 0 ||
        static_cast<uint64_t>(n_samples_) >
            map_.payload_bytes(4) / rec_bytes)
      return;
    records_ = reinterpret_cast<const float*>(map_.payload(4));
    ok_ = true;
    prefetcher_.reset(new Prefetcher(
        batch * x_elems_, batch * y_elems_,
        [this](int64_t step, float* x, float* y) { Fill(step, x, y); },
        depth, n_threads));
  }

  ~FileDataset() {
    prefetcher_.reset();  // joins workers before the map goes away
  }

  bool ok() const { return ok_; }
  int64_t n_samples() const { return n_samples_; }
  int64_t x_elems() const { return x_elems_; }
  int64_t y_elems() const { return y_elems_; }

  // Batch `step` = samples [step*batch, (step+1)*batch) of the
  // epoch-shuffled stream; wraps forever, reshuffling each epoch.
  void Fill(int64_t step, float* x, float* y) {
    const int64_t rec = x_elems_ + y_elems_;
    FillShuffled(
        step, batch_, n_samples_, seed_,
        [&](int64_t idx, int64_t b) {
          const float* r = records_ + idx * rec;
          std::memcpy(x + b * x_elems_, r, x_elems_ * 4);
          std::memcpy(y + b * y_elems_, r + x_elems_, y_elems_ * 4);
        });
  }

  Prefetcher* prefetcher() { return prefetcher_.get(); }

 private:
  int64_t batch_;
  uint64_t seed_;
  MappedFile map_;
  const float* records_ = nullptr;
  int64_t n_samples_ = 0, x_elems_ = 0, y_elems_ = 0;
  bool ok_ = false;
  std::unique_ptr<Prefetcher> prefetcher_;
};

// ---------------------------------------------------------------------------
// Token corpus: mmap'd flat binary of token ids (uint16 or uint32),
// sliced into seq_len+1 windows with the same per-epoch Feistel
// shuffle. The LLM-pretraining counterpart of FileDataset: the
// reference trains its Llama on random tokens
// (scripts/04_pipeline_parallel_pp/03_pipeline_training.py:220-230);
// a real corpus is a token stream on disk, and this reader turns it
// into deterministic (inputs, targets) next-token batches with zero
// Python in the hot path.
//
// Format (tpu_hpc_torch/native/dataloader.py:write_token_dataset):
//   uint64 magic 'TPUHPCT1'
//   uint64 n_tokens, uint64 token_bytes (2|4), uint64 max_token_id
//   n_tokens ids, little-endian, token_bytes each.
// max_token_id lets loaders validate a corpus against a model's
// vocab_size at open time instead of training silently on all-zero
// embeddings for out-of-range ids.
//
// Outputs are int32 written through the float* ring buffers as raw
// bit patterns (memcpy punning -- the ring only moves bytes); the
// Python side reinterprets. Window w covers tokens
// [w*S, w*S + S]: inputs = first S, targets = last S (shift by one).
// ---------------------------------------------------------------------------

constexpr uint64_t kTokenMagic = 0x3154435048555054ULL;  // "TPUHPCT1" LE

class TokenDataset {
 public:
  TokenDataset(const char* path, int64_t batch, int64_t seq_len,
               uint64_t seed, int depth, int n_threads)
      : batch_(batch), seq_(seq_len), seed_(seed) {
    if (seq_ <= 0 || batch_ <= 0) return;  // ok_ stays false; a 0
    // seq_len would otherwise SIGFPE the n_windows_ division below.
    map_.Open(path, kTokenMagic, 4);
    if (!map_.ok) return;
    const uint64_t* hdr = map_.header();
    n_tokens_ = static_cast<int64_t>(hdr[1]);
    tok_bytes_ = static_cast<int64_t>(hdr[2]);
    max_token_id_ = static_cast<int64_t>(hdr[3]);
    if (tok_bytes_ != 2 && tok_bytes_ != 4) return;
    // Overflow-safe capacity check (divide, never multiply).
    if (n_tokens_ <= 0 ||
        static_cast<uint64_t>(n_tokens_) >
            map_.payload_bytes(4) / tok_bytes_)
      return;
    data_ = map_.payload(4);
    // Each window needs seq_len + 1 tokens (the shifted target).
    n_windows_ = (n_tokens_ - 1) / seq_;
    if (n_windows_ <= 0) return;
    ok_ = true;
    prefetcher_.reset(new Prefetcher(
        batch * seq_, batch * seq_,
        [this](int64_t step, float* x, float* y) { Fill(step, x, y); },
        depth, n_threads));
  }

  ~TokenDataset() { prefetcher_.reset(); }

  bool ok() const { return ok_; }
  int64_t n_tokens() const { return n_tokens_; }
  int64_t n_windows() const { return n_windows_; }
  int64_t max_token_id() const { return max_token_id_; }

  void Fill(int64_t step, float* xf, float* yf) {
    int32_t* x = reinterpret_cast<int32_t*>(xf);
    int32_t* y = reinterpret_cast<int32_t*>(yf);
    FillShuffled(
        step, batch_, n_windows_, seed_,
        [&](int64_t w, int64_t b) {
          CopyWindow(w, x + b * seq_, y + b * seq_);
        });
  }

 private:
  void CopyWindow(int64_t w, int32_t* x, int32_t* y) const {
    const int64_t start = w * seq_;
    if (tok_bytes_ == 2) {
      const uint16_t* t =
          reinterpret_cast<const uint16_t*>(data_) + start;
      for (int64_t i = 0; i < seq_; ++i) {
        x[i] = static_cast<int32_t>(t[i]);
        y[i] = static_cast<int32_t>(t[i + 1]);
      }
    } else {
      const uint32_t* t =
          reinterpret_cast<const uint32_t*>(data_) + start;
      for (int64_t i = 0; i < seq_; ++i) {
        x[i] = static_cast<int32_t>(t[i]);
        y[i] = static_cast<int32_t>(t[i + 1]);
      }
    }
  }

 public:
  Prefetcher* prefetcher() { return prefetcher_.get(); }

 private:
  int64_t batch_, seq_;
  uint64_t seed_;
  MappedFile map_;
  const uint8_t* data_ = nullptr;
  int64_t n_tokens_ = 0, tok_bytes_ = 0, n_windows_ = 0;
  int64_t max_token_id_ = 0;
  bool ok_ = false;
  std::unique_ptr<Prefetcher> prefetcher_;
};

}  // namespace

extern "C" {

// Synchronous deterministic generation (random access by step).
void era5_gen(int64_t batch, int64_t lat, int64_t lon, int64_t ch,
              uint64_t seed, int64_t step, float* x, float* y) {
  GenConfig cfg{batch, lat, lon, ch, seed};
  gen_batch(cfg, step, x, y);
}

void* era5_prefetcher_create(int64_t batch, int64_t lat, int64_t lon,
                             int64_t ch, uint64_t seed, int depth,
                             int n_threads) {
  GenConfig cfg{batch, lat, lon, ch, seed};
  return new Prefetcher(cfg, depth, n_threads);
}

// Returns 0 on success, 1 on shutdown (outputs untouched).
int era5_prefetcher_next(void* p, float* x, float* y, int64_t* step_out) {
  return static_cast<Prefetcher*>(p)->Next(x, y, step_out);
}

void era5_prefetcher_seek(void* p, int64_t step) {
  static_cast<Prefetcher*>(p)->Seek(step);
}

void era5_prefetcher_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

// -- file-backed dataset --

void* file_dataset_open(const char* path, int64_t batch, uint64_t seed,
                        int depth, int n_threads) {
  auto* ds = new FileDataset(path, batch, seed, depth, n_threads);
  if (!ds->ok()) {
    delete ds;
    return nullptr;
  }
  return ds;
}

void file_dataset_info(void* p, int64_t* n_samples, int64_t* x_elems,
                       int64_t* y_elems) {
  auto* ds = static_cast<FileDataset*>(p);
  *n_samples = ds->n_samples();
  *x_elems = ds->x_elems();
  *y_elems = ds->y_elems();
}

// Synchronous random access (bypasses the ring, deterministic).
void file_dataset_batch(void* p, int64_t step, float* x, float* y) {
  static_cast<FileDataset*>(p)->Fill(step, x, y);
}

int file_dataset_next(void* p, float* x, float* y, int64_t* step_out) {
  return static_cast<FileDataset*>(p)->prefetcher()->Next(x, y, step_out);
}

void file_dataset_seek(void* p, int64_t step) {
  static_cast<FileDataset*>(p)->prefetcher()->Seek(step);
}

void file_dataset_close(void* p) { delete static_cast<FileDataset*>(p); }

// -- token corpus --

void* token_dataset_open(const char* path, int64_t batch,
                         int64_t seq_len, uint64_t seed, int depth,
                         int n_threads) {
  auto* ds = new TokenDataset(path, batch, seq_len, seed, depth,
                              n_threads);
  if (!ds->ok()) {
    delete ds;
    return nullptr;
  }
  return ds;
}

void token_dataset_info(void* p, int64_t* n_tokens, int64_t* n_windows,
                        int64_t* max_token_id) {
  auto* ds = static_cast<TokenDataset*>(p);
  *n_tokens = ds->n_tokens();
  *n_windows = ds->n_windows();
  *max_token_id = ds->max_token_id();
}

// Synchronous random access; outputs are int32 bit patterns in the
// float* buffers (see TokenDataset comment).
void token_dataset_batch(void* p, int64_t step, float* x, float* y) {
  static_cast<TokenDataset*>(p)->Fill(step, x, y);
}

int token_dataset_next(void* p, float* x, float* y, int64_t* step_out) {
  return static_cast<TokenDataset*>(p)->prefetcher()->Next(x, y,
                                                           step_out);
}

void token_dataset_seek(void* p, int64_t step) {
  static_cast<TokenDataset*>(p)->prefetcher()->Seek(step);
}

void token_dataset_close(void* p) { delete static_cast<TokenDataset*>(p); }

}  // extern "C"

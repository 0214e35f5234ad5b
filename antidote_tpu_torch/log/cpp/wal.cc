// wal.cc — per-shard append-only write-ahead log with group commit (the
// port's own copy of the JAX package's log/cpp/wal.cc; same frames).
//
// Native replacement for the reference's OTP disk_log usage
// (AntidoteDB src/logging_vnode.erl:896-919): one log file per shard,
// buffered appends, an explicit commit barrier, and an optional background
// fsync thread reproducing the sync_log=false default (async flush,
// AntidoteDB src/antidote.app.src:44-48) without losing group-commit
// durability when sync_log=true.
//
// Record framing (read side is implemented in Python):
//   u32 magic 0xA17D07E1 | u32 payload_len | u32 crc32(payload) | payload
//
// C ABI for ctypes. Thread-safety: one writer per WAL handle (matches the
// single-commit-stream-per-shard architecture); the fsync thread only
// calls fdatasync on the fd.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>

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

struct Wal {
  int fd = -1;
  bool sync_on_commit = false;
  // group-commit state
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> appended_bytes{0};
  uint64_t synced_bytes = 0;
  std::thread syncer;
  int sync_interval_ms = 0;

  ~Wal() { close(); }

  void close() {
    if (syncer.joinable()) {
      stop.store(true);
      cv.notify_all();
      syncer.join();
    }
    if (fd >= 0) {
      ::fdatasync(fd);
      ::close(fd);
      fd = -1;
    }
  }
};

void sync_loop(Wal* w) {
  std::unique_lock<std::mutex> lk(w->mu);
  while (!w->stop.load()) {
    w->cv.wait_for(lk, std::chrono::milliseconds(w->sync_interval_ms));
    uint64_t cur = w->appended_bytes.load();
    if (cur != w->synced_bytes && w->fd >= 0) {
      ::fdatasync(w->fd);
      w->synced_bytes = cur;
    }
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
// sync_interval_ms > 0: background fsync thread (async durability).
void* wal_open(const char* path, int sync_on_commit, int sync_interval_ms) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  Wal* w = new Wal();
  w->fd = fd;
  w->sync_on_commit = sync_on_commit != 0;
  w->sync_interval_ms = sync_interval_ms;
  if (sync_interval_ms > 0) w->syncer = std::thread(sync_loop, w);
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
  if (w->sync_on_commit) {
    if (::fdatasync(w->fd) != 0) return -1;
    w->synced_bytes = w->appended_bytes.load();
  }
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
  if (::fdatasync(w->fd) != 0) return -1;
  w->synced_bytes = w->appended_bytes.load();
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

// router.cc — native key→shard router (the port's own copy of the JAX
// package's store/cpp/router.cc; the same hash, bit for bit).
//
// The reference routes keys through the crypto NIF's consistent hash
// (chash_key → crypto:bytes_to_integer, AntidoteDB
// src/log_utilities.erl:96-118).  Here the router is a XXH64-style 64-bit
// hash (implemented from the public spec) with a batch API: the client
// protocol and commit path hash thousands of keys per call, so the
// per-key FFI cost is amortized to one crossing.
//
// C ABI for ctypes; pure functions, no state.  Built by
// antidote_tpu_torch/native_build.py, which embeds the source's sha.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/arm LE)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint64_t round_(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round_(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round_(v1, read64(p)); p += 8;
      v2 = round_(v2, read64(p)); p += 8;
      v3 = round_(v3, read64(p)); p += 8;
      v4 = round_(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round_(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

}  // namespace

#ifndef ANTIDOTE_SRC_SHA
#define ANTIDOTE_SRC_SHA "unknown"
#endif

extern "C" {

const char* router_src_sha() { return ANTIDOTE_SRC_SHA; }

uint64_t router_hash64(const uint8_t* data, uint64_t len, uint64_t seed) {
  return xxh64(data, len, seed);
}

// Batch: blob holds n concatenated keys; offsets[i]..offsets[i+1] bounds
// key i (offsets has n+1 entries).  out[i] = hash % n_shards.
void router_shard_batch(const uint8_t* blob, const uint64_t* offsets,
                        int64_t n, uint64_t seed, int64_t n_shards,
                        int64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = xxh64(blob + offsets[i], offsets[i + 1] - offsets[i], seed);
    out[i] = static_cast<int64_t>(h % static_cast<uint64_t>(n_shards));
  }
}

}  // extern "C"

// Materializer kernels for Hopper (sm_90a): the OR-set presence test (and
// the resolve's top-K compaction fused with it), the counter_pn ring fold,
// the set_aw ring fold and the stable-time column min.
//
// Built by antidote_tpu_torch/materializer/cuda_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmaterializer_<hash>.so materializer.cu
// and bound through the plain C entry points at the bottom (ctypes).  Each
// entry launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch surfaces in the wrapper.
//
// Layouts are the JAX package's public ones, row-major and contiguous:
// per-key state [B, E] / [B, E, D], op rings [B, K, *], clocks [B, D].
// Handles are read as int64 directly; the TPU kernels' lo/hi int32 planes
// and [D, B, K] transposes existed only for Mosaic and are gone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------------
// Lanes a key: a key's slots (or ring slots) spread over a group of
// G = 1 << log_g lanes, G = min(next_pow2(width), 32), so a warp packs 32 / G
// keys and lane `sl` of a group holds slots sl, G + sl, ...  Ballots and
// shuffles run over the whole warp (every lane reaches them: the loops'
// trip counts are warp-uniform) and are masked and shifted to the group.
// ---------------------------------------------------------------------------
struct Group {
  int log_g, g, sl, seg_base;
  unsigned seg_mask;
  int64_t key;         // the group's key
  bool live;           // false: a packed warp's spare group past n_keys
  bool warp_done;      // every group of the warp is past n_keys
};

__device__ __forceinline__ Group group_of(int log_g, int64_t n_keys) {
  Group gr;
  const int lane = threadIdx.x & 31;
  gr.log_g = log_g;
  gr.g = 1 << log_g;
  gr.sl = lane & (gr.g - 1);
  gr.seg_base = lane - gr.sl;
  gr.seg_mask = gr.g == 32 ? kFullMask
                           : ((1u << (gr.g % 32)) - 1) << gr.seg_base;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  gr.key = tid >> log_g;
  gr.live = gr.key < n_keys;
  gr.warp_done = ((tid - lane) >> log_g) >= n_keys;
  return gr;
}

// the group's bits of a warp ballot, group lane 0 at bit 0
__device__ __forceinline__ unsigned group_ballot(const Group& gr, bool p) {
  return (__ballot_sync(kFullMask, p) & gr.seg_mask) >> gr.seg_base;
}

inline int log_group(int width) {
  int lg = 0;
  while ((1 << lg) < width && lg < 5) ++lg;
  return lg;
}

inline unsigned blocks_for(int64_t threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

// threads of a grid that gives each of n_keys a group of 1 << log_g lanes
inline int64_t group_threads(int64_t n_keys, int log_g) {
  const int64_t per_warp = 32 >> log_g;
  return (n_keys + per_warp - 1) / per_warp * 32;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// orset_presence / orset_resolve
//
// Replaces antidote_tpu/materializer/pallas_kernels.py::_presence_kernel
// (orset_presence) and, in the compacted form, the top-K compaction that
// follows it in SetAW.resolve (antidote_tpu/crdt/base.py::compact_top).
//   present[b, e] = (exists d: addvc > rmvc) && elems != 0 (all 64 bits)
//   mask form:      out[b, e] = present
//   compacted form: top[b, 0..T) = the first T present handles in slot
//                   order, zero-padded; count[b] = the number present
// Bound: bytes — per slot 2*D int32 clocks and one int64 handle read once
// against D compares; the mask writes one byte a slot, the compacted form
// 8 * T + 4 bytes a key.
// Design: one body, COMPACT picks the output.  A key's E slots spread over
// a group of G = min(next_pow2(E), 32) lanes, slot e on lane e % G (at
// E = 16 two keys a warp, which is the flat slot-per-lane layout).  VEC
// (D = 4, both clock arrays 16-byte aligned): each lane reads a slot's two
// clock rows as one 16-byte load each through the read-only path, and its
// handle as 8 bytes; a warp's loads cover 512 contiguous bytes of each
// clock array.  Otherwise scalar loads over the D lanes.  The compaction
// needs no sort: a slot's output position is the popcount of the group's
// presence ballot below its lane, plus the present slots of earlier rounds
// (E > 32: one warp a key walks ceil(E / 32) rounds, carrying the prefix,
// so slot order holds).  A present slot below T stores its handle, lanes
// count..T-1 store 0 and group lane 0 stores count: every output once.
// ---------------------------------------------------------------------------
constexpr int kOrsetThreads = 256;

struct OrsetArgs {
  const int32_t* addvc;  // [B, E, D]
  const int32_t* rmvc;   // [B, E, D]
  const int64_t* elems;  // [B, E]
  uint8_t* mask;         // mask form: [B, E]
  int64_t* top;          // compacted form: [B, T]
  int32_t* count;        // compacted form: [B]
  int64_t n_keys;
  int e, d, t, log_g;
};

template <bool COMPACT, bool VEC>
__global__ void __launch_bounds__(kOrsetThreads)
    orset_kernel(const OrsetArgs a) {
  const Group gr = group_of(a.log_g, a.n_keys);
  if (gr.warp_done) return;  // uniform across the warp
  const int e = a.e, d = a.d;
  int prefix = 0;  // present slots of the earlier rounds
  for (int c = 0; c < e; c += gr.g) {
    const int slot = c + gr.sl;
    const int64_t at = gr.key * e + slot;
    bool p = false;
    long long h = 0;
    if (gr.live && slot < e) {
      h = __ldg(reinterpret_cast<const long long*>(a.elems) + at);
      if constexpr (VEC) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(a.addvc) + at);
        const int4 y = __ldg(reinterpret_cast<const int4*>(a.rmvc) + at);
        p = x.x > y.x || x.y > y.y || x.z > y.z || x.w > y.w;
      } else {
        for (int j = 0; j < d; ++j)
          p |= __ldg(a.addvc + at * d + j) > __ldg(a.rmvc + at * d + j);
      }
      p = p && h != 0;
      if constexpr (!COMPACT) a.mask[at] = p ? 1 : 0;
    }
    if constexpr (COMPACT) {
      const unsigned bits = group_ballot(gr, p);
      const int pos = prefix + __popc(bits & ((1u << gr.sl) - 1));
      if (p && pos < a.t) a.top[gr.key * a.t + pos] = h;
      prefix += __popc(bits);
    }
  }
  if constexpr (COMPACT) {
    if (!gr.live) return;
    for (int q = prefix + gr.sl; q < a.t; q += gr.g)
      a.top[gr.key * a.t + q] = 0;
    if (gr.sl == 0) a.count[gr.key] = prefix;
  }
}

template <bool COMPACT>
int launch_orset(const OrsetArgs& a, cudaStream_t st) {
  const bool vec = a.d == 4 && aligned16(a.addvc) && aligned16(a.rmvc);
  const unsigned blocks =
      blocks_for(group_threads(a.n_keys, a.log_g), kOrsetThreads);
  if (vec)
    orset_kernel<COMPACT, true><<<blocks, kOrsetThreads, 0, st>>>(a);
  else
    orset_kernel<COMPACT, false><<<blocks, kOrsetThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// counter_fold
//
// Replaces pallas_kernels.py::_counter_fold_kernel (counter_fold /
// counter_fold_local).  cnt[b] = base_cnt[b] + sum of deltas[b, s] over the
// ring slots s < n_ops[b] with !(ops_vc <= base_vc) && ops_vc <= read_vc;
// applied[b] counts them.  The sum is int64, so no delta bound applies (the
// TPU kernel summed in int32 and refused |delta| > INT32_MAX / K).
// Bound: bytes — each visited slot is D clock lanes plus one int64 delta
// against 2*D compares, plus a key's two clock rows and its outputs.
// Design: a group of G = min(next_pow2(ceil(K / 2)), 32) lanes a key (at
// K = 16 eight lanes, four keys a warp, 512 blocks: one wave on 132 SMs),
// lane l on ring slots l and G + l of each round of 2G slots, both loads of
// a round issued before either test.  A slot s < min(n_ops, K) is read as
// one 16-byte clock row (VEC: D = 4 and the clock arrays 16-byte aligned;
// scalar loads otherwise) and an 8-byte delta, neighbouring lanes on
// neighbouring slots; a slot past n_ops is not read.  The deltas are a
// strided view (row and element strides in int64 words), so the caller
// passes lane 0 of its [B, K, A] effect lanes without a copy.  The int64
// sum is reduced by shuffles within the group, the count by the popcount
// of the group's inclusion ballots; group lane 0 stores both.  Measured
// against G = min(next_pow2(K), 32) one slot a lane (1,024 blocks, 1.3
// waves at 40 registers) and four slots a lane: two is the fastest.
// ---------------------------------------------------------------------------
constexpr int kCounterThreads = 256;
constexpr int kCounterSlots = 2;  // ring slots a lane loads at once

struct CounterArgs {
  const int64_t* base_cnt;  // [B]
  const int64_t* deltas;    // deltas[b, s] at b * row_stride + s * el_stride
  const int32_t* ops_vc;    // [B, K, D]
  const int32_t* n_ops;     // [B]
  const int32_t* base_vc;   // [B, D]
  const int32_t* read_vc;   // [B, D]
  int64_t* out_cnt;         // [B]
  int32_t* applied;         // [B]
  int64_t n_keys, row_stride, el_stride;
  int k, d, log_g;
};

template <bool VEC>
__global__ void __launch_bounds__(kCounterThreads)
    counter_fold_kernel(const CounterArgs a) {
  const Group gr = group_of(a.log_g, a.n_keys);
  if (gr.warp_done) return;  // uniform across the warp
  const int k = a.k, d = a.d;
  const int64_t key = gr.key;
  int n = 0;
  long long base = 0;
  int4 bv = make_int4(0, 0, 0, 0), rv = bv;
  if (gr.live) {
    n = max(min(__ldg(a.n_ops + key), k), 0);
    if (gr.sl == 0)
      base = __ldg(reinterpret_cast<const long long*>(a.base_cnt) + key);
    if constexpr (VEC) {
      bv = __ldg(reinterpret_cast<const int4*>(a.base_vc) + key);
      rv = __ldg(reinterpret_cast<const int4*>(a.read_vc) + key);
    }
  }
  // rounds of kCounterSlots * G slots up to the warp's longest ring
  const int n_warp = (int)__reduce_max_sync(kFullMask, (unsigned)n);
  long long sum = 0;
  int32_t count = 0;
  for (int c = 0; c < n_warp; c += kCounterSlots * gr.g) {
    // every load of the round first, then the tests
    long long delta[kCounterSlots];
    int4 v[kCounterSlots];
#pragma unroll
    for (int j = 0; j < kCounterSlots; ++j) {
      const int s = c + j * gr.g + gr.sl;
      delta[j] = 0;
      v[j] = make_int4(0, 0, 0, 0);
      if (s < n) {
        delta[j] = __ldg(reinterpret_cast<const long long*>(a.deltas) +
                         key * a.row_stride + s * a.el_stride);
        if constexpr (VEC)
          v[j] = __ldg(reinterpret_cast<const int4*>(a.ops_vc) + key * k + s);
      }
    }
#pragma unroll
    for (int j = 0; j < kCounterSlots; ++j) {
      const int s = c + j * gr.g + gr.sl;
      bool inc = false;
      if (s < n) {
        bool in_base = true, visible = true;
        if constexpr (VEC) {
          const int4 x = v[j];
          in_base = x.x <= bv.x && x.y <= bv.y && x.z <= bv.z && x.w <= bv.w;
          visible = x.x <= rv.x && x.y <= rv.y && x.z <= rv.z && x.w <= rv.w;
        } else {
          const int32_t* row = a.ops_vc + (key * k + s) * d;
          for (int t = 0; t < d; ++t) {
            const int32_t x = __ldg(row + t);
            in_base &= x <= __ldg(a.base_vc + key * d + t);
            visible &= x <= __ldg(a.read_vc + key * d + t);
          }
        }
        inc = !in_base && visible;
        if (inc) sum += delta[j];
      }
      count += __popc(group_ballot(gr, inc));
    }
  }
  for (int o = gr.g >> 1; o > 0; o >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, o);
  if (gr.live && gr.sl == 0) {
    a.out_cnt[key] = base + sum;
    a.applied[key] = count;
  }
}

// An empty kernel: the launch floor of this source's ctypes path.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// set_aw_fold
//
// Replaces pallas_kernels.py::_set_aw_fold_kernel (set_aw_fold /
// set_aw_fold_local): the add-wins observed-remove rule of SetAW.apply
// replayed over each key's ring in slot order, for the ops the inclusion
// test admits.
//   add h:    take the first slot with elems == h (h != 0); else the first
//             slot that is not present, zeroing both of its clock rows; then
//             addvc[origin] = max(addvc[origin], ops_vc[origin]).  With no
//             such slot, ovf += 1 and nothing else changes.
//   remove h: the first matching slot's rmvc = max(rmvc, observed add VC);
//             with no match nothing changes.
// Every included op counts in `applied`.
//
// Bound: bytes — each key's state is read and written once and its ring
// prefix read once.  But the ops of one key form a serial chain (each op's
// slot choice depends on the previous op's writes), so what holds a kernel
// back is the latency of each link of that chain.
//
// Design (set_aw_fold_reg_kernel): the chain runs in registers.
// * A key's E slots spread over a segment of W lanes (W = 8, 16 or 32), SPL
//   slots a lane (slot j * W + lane).  Each lane holds its slots' handles,
//   both clock rows and a present bit, updated only when its slot changes.
//   With W < 32 a warp packs 32 / W keys, so at E = 16 no lane idles; the
//   ballots and shuffles of a packed warp are masked to each segment.
// * The key's state and ring are loaded once, coalesced: lane s <- op s of
//   the ring prefix, in chunks of W ops; 16-byte loads and stores of a
//   slot's or an op's clock row when D % 4 == 0 and the rows are aligned.
// * Inclusion of a whole chunk in one step: each lane tests its op against
//   base_vc and read_vc and one __ballot_sync gives the mask (the TPU
//   kernel's [BLK, K] tile test); `applied` is its popcount.
// * The warp walks the set bits in order with no memory traffic: the op's
//   handle, kind + origin, stamp and observed VC are __shfl_sync'd from
//   the lane that staged it (unconditionally: a vote to skip the observed
//   VC of adds cost more than the shuffles); two ballots per register
//   round and __ffs give first match and first free in slot order; the lane
//   that owns the chosen slot updates its registers.  Keys of a packed warp
//   with fewer included ops keep stepping with the others (every lane
//   reaches every full-mask shuffle) with their updates predicated off.
// * Every output element is written once, at the end.
// The register variants hold D <= 4, the widest clock any configuration of
// the repo runs (max_dcs 2 to 4).  Other widths (E > 256 or 4 < D <= 32)
// run set_aw_fold_wide_kernel: one warp per key over the state in global
// memory (copied into the outputs, then updated in place), which rescans
// the E slots for every included op.  The launcher picks by (E, D) only.
// ---------------------------------------------------------------------------
constexpr int kFoldThreads = 128;

struct SetAwArgs {
  const int64_t* elems0;
  const int32_t* addvc0;
  const int32_t* rmvc0;
  const int32_t* ovf0;
  const int64_t* ops_a;
  const int32_t* ops_b;
  const int32_t* ops_vc;
  const int32_t* origin;
  const int32_t* n_ops;
  const int32_t* base_vc;
  const int32_t* read_vc;
  int64_t* elems;
  int32_t* addvc;
  int32_t* rmvc;
  int32_t* ovf;
  int32_t* applied;
  int64_t n_keys;
  int k, e, d, a_w, b_w;
  bool vec;  // d % 4 == 0 and every clock array 16-byte aligned
};

// A clock row of d <= DM lanes into registers; lanes >= d read as 0.
template <int DM>
__device__ __forceinline__ void load_row(const int32_t* p, int d, bool vec,
                                         int32_t (&r)[DM]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < DM / 4; ++q) {
      int4 v = make_int4(0, 0, 0, 0);
      if (4 * q < d) v = *reinterpret_cast<const int4*>(p + 4 * q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < DM; ++t) r[t] = t < d ? p[t] : 0;
  }
}

template <int DM>
__device__ __forceinline__ void store_row(int32_t* p, int d, bool vec,
                                          const int32_t (&r)[DM]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < DM / 4; ++q)
      if (4 * q < d)
        *reinterpret_cast<int4*>(p + 4 * q) =
            make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < DM; ++t)
      if (t < d) p[t] = r[t];
  }
}

// present = occupied && (exists lane: addvc > rmvc); lanes >= d are 0 in both
template <int DM>
__device__ __forceinline__ bool is_present(int64_t h, const int32_t (&a)[DM],
                                           const int32_t (&r)[DM]) {
  bool p = false;
#pragma unroll
  for (int t = 0; t < DM; ++t) p |= a[t] > r[t];
  return p && h != 0;
}

template <int W, int SPL, int DM>
__global__ void __launch_bounds__(kFoldThreads)
    set_aw_fold_reg_kernel(const SetAwArgs a) {
  constexpr int kKeys = 32 / W;  // keys a warp holds
  const int lane = threadIdx.x & 31;
  const int sl = lane % W;        // lane within the key's segment
  const int seg_base = lane - sl;
  const unsigned seg_mask =
      W == 32 ? kFullMask : ((1u << (W % 32)) - 1) << seg_base;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (warp * kKeys >= a.n_keys) return;  // uniform across the warp
  const int64_t key = warp * kKeys + lane / W;
  const bool live = key < a.n_keys;  // false: a packed warp's spare segment
  const int k = a.k, e = a.e, d = a.d;
  const bool vec = a.vec;

  // ---- the key's state: lane sl holds slots sl, W + sl, ...
  int64_t el[SPL];
  int32_t av[SPL][DM], rv[SPL][DM];
  bool valid[SPL], pres[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int slot = j * W + sl;
    valid[j] = live && slot < e;
    el[j] = 0;
#pragma unroll
    for (int t = 0; t < DM; ++t) av[j][t] = rv[j][t] = 0;
    if (valid[j]) {
      const int64_t at = key * e + slot;
      el[j] = a.elems0[at];
      load_row<DM>(a.addvc0 + at * d, d, vec, av[j]);
      load_row<DM>(a.rmvc0 + at * d, d, vec, rv[j]);
    }
    pres[j] = is_present<DM>(el[j], av[j], rv[j]);
  }
  int32_t bv[DM], rdv[DM];
#pragma unroll
  for (int t = 0; t < DM; ++t) bv[t] = rdv[t] = 0;
  int n = 0;
  int32_t n_ovf = 0, n_applied = 0;
  if (live) {
    load_row<DM>(a.base_vc + key * d, d, vec, bv);
    load_row<DM>(a.read_vc + key * d, d, vec, rdv);
    n = min(a.n_ops[key], k);
    n_ovf = a.ovf0[key];
  }

  for (int c = 0; c < k; c += W) {
    // ---- stage the chunk: lane sl <- op c + sl
    const int s = c + sl;
    bool inc = false;
    long long h = 0;
    int32_t meta = 0, own = 0, obs[DM];
#pragma unroll
    for (int t = 0; t < DM; ++t) obs[t] = 0;
    if (s < n) {
      const int64_t op = key * k + s;
      int32_t v[DM];
      load_row<DM>(a.ops_vc + op * d, d, vec, v);
      h = a.ops_a[op * a.a_w];
      const int32_t* ob = a.ops_b + op * a.b_w;
      const int32_t o = a.origin[op];
      bool in_base = true, visible = true;
#pragma unroll
      for (int t = 0; t < DM; ++t) {
        if (t < d) {
          in_base &= v[t] <= bv[t];
          visible &= v[t] <= rdv[t];
          obs[t] = ob[1 + t];
        }
        if (t == o) own = v[t];
      }
      inc = !in_base && visible;
      meta = (ob[0] == 1 ? 1 : 0) | (o << 1);
    }
    unsigned rem = (__ballot_sync(kFullMask, inc) & seg_mask) >> seg_base;
    n_applied += __popc(rem);
    const unsigned steps = __reduce_max_sync(kFullMask, (unsigned)__popc(rem));

    // ---- walk the included ops in slot order
    for (unsigned it = 0; it < steps; ++it) {
      const bool act = rem != 0;
      const int src = seg_base + (act ? __ffs(rem) - 1 : 0);
      rem &= rem - 1;
      const long long oh = __shfl_sync(kFullMask, h, src);
      const int32_t om = __shfl_sync(kFullMask, meta, src);
      const int32_t oown = __shfl_sync(kFullMask, own, src);
      const bool is_rm = om & 1;
      const int oorg = om >> 1;
      int idx_match = -1, idx_free = -1;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const unsigned mm = (__ballot_sync(kFullMask, el[j] != 0 && el[j] == oh)
                             & seg_mask) >> seg_base;
        const unsigned fm = (__ballot_sync(kFullMask, valid[j] && !pres[j])
                             & seg_mask) >> seg_base;
        if (idx_match < 0 && mm) idx_match = j * W + __ffs(mm) - 1;
        if (idx_free < 0 && fm) idx_free = j * W + __ffs(fm) - 1;
      }
      int32_t oobs[DM];
#pragma unroll
      for (int t = 0; t < DM; ++t)
        oobs[t] = __shfl_sync(kFullMask, obs[t], src);
      if (!act) continue;
      if (is_rm) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          if (j * W + sl != idx_match) continue;
#pragma unroll
          for (int t = 0; t < DM; ++t) rv[j][t] = max(rv[j][t], oobs[t]);
          pres[j] = is_present<DM>(el[j], av[j], rv[j]);
        }
      } else if (idx_match >= 0 || idx_free >= 0) {
        const bool fresh = idx_match < 0;
        const int idx = fresh ? idx_free : idx_match;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          if (j * W + sl != idx) continue;
          if (fresh) {
            el[j] = oh;
#pragma unroll
            for (int t = 0; t < DM; ++t) av[j][t] = rv[j][t] = 0;
          }
#pragma unroll
          for (int t = 0; t < DM; ++t)
            if (t == oorg) av[j][t] = max(av[j][t], oown);
          pres[j] = is_present<DM>(el[j], av[j], rv[j]);
        }
      } else {
        ++n_ovf;
      }
    }
  }

  // ---- every output element once
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    if (!valid[j]) continue;
    const int64_t at = key * e + j * W + sl;
    a.elems[at] = el[j];
    store_row<DM>(a.addvc + at * d, d, vec, av[j]);
    store_row<DM>(a.rmvc + at * d, d, vec, rv[j]);
  }
  if (live && sl == 0) {
    a.ovf[key] = n_ovf;
    a.applied[key] = n_applied;
  }
}

// The widths the register kernel cannot hold: one warp per key, the state
// in global memory; the inclusion test spreads the D clock lanes over the
// warp (__all_sync) and first match / first free scan the E slots in
// chunks of 32 (__ballot_sync + __ffs).  Needs D <= 32.
__global__ void set_aw_fold_wide_kernel(const SetAwArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t key = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (key >= a.n_keys) return;  // uniform across the warp
  const int k = a.k, e = a.e, d = a.d;

  int64_t* el = a.elems + key * e;
  int32_t* av = a.addvc + key * e * d;
  int32_t* rv = a.rmvc + key * e * d;
  for (int i = lane; i < e; i += 32) el[i] = a.elems0[key * e + i];
  for (int i = lane; i < e * d; i += 32) {
    av[i] = a.addvc0[key * e * d + i];
    rv[i] = a.rmvc0[key * e * d + i];
  }
  __syncwarp();

  const int32_t* bv = a.base_vc + key * d;
  const int32_t* rdv = a.read_vc + key * d;
  const int n = min(a.n_ops[key], k);
  int32_t n_ovf = a.ovf0[key];
  int32_t n_applied = 0;
  for (int s = 0; s < n; ++s) {
    const int64_t op = key * k + s;
    const int32_t* v = a.ops_vc + op * d;
    const int32_t vl = lane < d ? v[lane] : 0;
    const bool in_base = __all_sync(kFullMask, lane >= d || vl <= bv[lane]);
    const bool visible = __all_sync(kFullMask, lane >= d || vl <= rdv[lane]);
    if (in_base || !visible) continue;
    ++n_applied;
    const int64_t h = a.ops_a[op * a.a_w];
    const int32_t* ob = a.ops_b + op * a.b_w;
    const bool is_rm = ob[0] == 1;

    int idx_match = -1, idx_free = -1;
    for (int c = 0; c < e; c += 32) {
      const int i = c + lane;
      bool match = false, free_slot = false;
      if (i < e) {
        const int64_t x = el[i];
        const bool occupied = x != 0;
        bool present = false;
        for (int j = 0; j < d; ++j) present |= av[i * d + j] > rv[i * d + j];
        match = occupied && x == h;
        free_slot = !(present && occupied);
      }
      const unsigned mm = __ballot_sync(kFullMask, match);
      const unsigned fm = __ballot_sync(kFullMask, free_slot);
      if (mm) {
        idx_match = c + __ffs(mm) - 1;
        break;
      }
      if (idx_free < 0 && fm) idx_free = c + __ffs(fm) - 1;
    }

    if (is_rm) {
      if (idx_match >= 0 && lane < d) {
        int32_t* r = rv + idx_match * d + lane;
        *r = max(*r, ob[1 + lane]);
      }
    } else if (idx_match < 0 && idx_free < 0) {
      ++n_ovf;
    } else {
      const bool fresh = idx_match < 0;
      const int idx = fresh ? idx_free : idx_match;
      if (lane < d) {
        int32_t x = fresh ? 0 : av[idx * d + lane];
        const int32_t r = fresh ? 0 : rv[idx * d + lane];
        if (lane == a.origin[op]) x = max(x, vl);
        av[idx * d + lane] = x;
        rv[idx * d + lane] = r;
      }
      if (lane == 0) el[idx] = h;
    }
    __syncwarp();
  }
  if (lane == 0) {
    a.ovf[key] = n_ovf;
    a.applied[key] = n_applied;
  }
}

template <int W, int SPL, int DM>
void launch_reg(const SetAwArgs& a, cudaStream_t st) {
  const int64_t warps = (a.n_keys + 32 / W - 1) / (32 / W);
  set_aw_fold_reg_kernel<W, SPL, DM>
      <<<blocks_for(warps * 32, kFoldThreads), kFoldThreads, 0, st>>>(a);
}

void launch_wide(const SetAwArgs& a, cudaStream_t st) {
  set_aw_fold_wide_kernel<<<blocks_for(a.n_keys * 32, kFoldThreads),
                            kFoldThreads, 0, st>>>(a);
}

// The fold's variants, the first whose widths hold (E, D) is taken.
struct FoldVariant {
  int max_e, max_d;
  const char* name;
  void (*launch)(const SetAwArgs&, cudaStream_t);
};
const FoldVariant kFoldVariants[] = {
    {8, 4, "reg_w8_s1_d4", launch_reg<8, 1, 4>},
    {16, 4, "reg_w16_s1_d4", launch_reg<16, 1, 4>},
    {32, 4, "reg_w32_s1_d4", launch_reg<32, 1, 4>},
    {64, 4, "reg_w32_s2_d4", launch_reg<32, 2, 4>},
    {256, 4, "reg_w32_s8_d4", launch_reg<32, 8, 4>},
    {1 << 30, 32, "wide", launch_wide},
};

const FoldVariant* pick_fold(int e, int d) {
  for (const FoldVariant& v : kFoldVariants)
    if (e <= v.max_e && d <= v.max_d) return &v;
  return nullptr;
}

// ---------------------------------------------------------------------------
// stable_min
//
// Replaces pallas_kernels.py::_stable_min_kernel (stable_min): the
// column-wise minimum of a clock matrix int32[N, D], the stable-time merge
// over every member's per-shard clock rows.  INT32_MAX is the identity.
// Bound: bytes — N * D int32 read once against one compare each; at the
// cluster path's 2048 x 4 (32 KiB) the launch itself dominates.
// Design: one launch, no fill, no atomics; every output is stored once.
// * Given no partials buffer (the wrapper's choice up to
//   STABLE_MIN_ONE_BLOCK elements, the path's 2048 x 4 among them), one
//   block does it all (stable_min_block_kernel, a plain launch).  With D in
//   {1, 2, 4} and an aligned matrix it reads 16 bytes a thread (for D = 4
//   an int4 is one row; each lane of an int4 keeps its column), reduces
//   each of the four lanes over the warp (__reduce_min_sync), folds the
//   warps through shared memory and stores the D words.  Other D:
//   threads are grouped by column (a thread keeps one column); for D
//   dividing 32 a __shfl_xor_sync butterfly over the offsets >= D folds the
//   lanes of one column, else the block folds through shared memory; D
//   larger than the block gives each thread whole columns.
// * Larger matrices (stable_min_grid_kernel): a cooperative grid of at
//   most the co-resident block count; each block writes its D column
//   minima into a per-call partials buffer (the caller's torch.empty), one
//   grid-wide sync, and block 0 folds the partials the same way.  Nothing
//   is shared between calls, so two threads may launch at once on
//   different streams.  The two paths are two kernels: in one kernel the
//   one-block path carried the grid path's 8-byte stack frame (ptxas:
//   spill stores and loads), which neither has alone.
// ---------------------------------------------------------------------------
constexpr int kMinOneThreads = 512;     // the single block
constexpr int kMinGridThreads = 256;    // each block of a grid
constexpr int kMaxDevices = 64;

template <bool NC>
__device__ __forceinline__ int32_t load1(const int32_t* p) {
  if constexpr (NC) return __ldg(p);
  return *p;
}

template <bool NC>
__device__ __forceinline__ int4 load4(const int4* p) {
  if constexpr (NC) return __ldg(p);
  return *p;
}

// Column minima of the rows of x[n_rows, d] that fall to part `part` of
// `n_parts` (a grid-stride split over rows or int4s), stored to dst[0, d).
// Every thread of the block calls it; `sm` holds blockDim.x words.  NC:
// read through the read-only cache (not for data written in this launch).
template <bool NC>
__device__ void block_colmin(const int32_t* x, int64_t n_rows, int d,
                             bool vec, int64_t part, int64_t n_parts,
                             int32_t* sm, int32_t* dst) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  if (vec) {
    // d divides 4, so element i is in column (i % 4) % d: lane r of every
    // int4 stays in column r % d
    const int64_t n_el = n_rows * d, n4 = n_el >> 2, stride = n_parts * nt;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int32_t m[4] = {INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX};
    int64_t q = part * nt + tid;
    for (; q + 3 * stride < n4; q += 4 * stride) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = load4<NC>(x4 + q + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m[0] = min(m[0], v[u].x);
        m[1] = min(m[1], v[u].y);
        m[2] = min(m[2], v[u].z);
        m[3] = min(m[3], v[u].w);
      }
    }
    for (; q < n4; q += stride) {
      const int4 v = load4<NC>(x4 + q);
      m[0] = min(m[0], v.x);
      m[1] = min(m[1], v.y);
      m[2] = min(m[2], v.z);
      m[3] = min(m[3], v.w);
    }
    if (part == 0 && tid < (n_el & 3)) {  // the ragged tail, lane = tid
      const int32_t t = load1<NC>(x + (n4 << 2) + tid);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r == tid) m[r] = min(m[r], t);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = __reduce_min_sync(kFullMask, m[r]);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) sm[warp * 4 + r] = m[r];
    __syncthreads();
    if (tid < d) {
      int32_t res = INT32_MAX;
      for (int w = 0; w < n_warps; ++w)
        for (int r = tid; r < 4; r += d) res = min(res, sm[w * 4 + r]);
      dst[tid] = res;
    }
    return;
  }
  if (d > nt) {  // more columns than threads: whole columns a thread
    for (int c = tid; c < d; c += nt) {
      int32_t m = INT32_MAX;
      for (int64_t r = part; r < n_rows; r += n_parts)
        m = min(m, load1<NC>(x + r * d + c));
      dst[c] = m;
    }
    return;
  }
  // threads grouped by column: per threads a column, rows strided
  const int per = nt / d;
  const int col = tid % d;
  int32_t m = INT32_MAX;
  if (tid < per * d) {
    const int64_t stride = n_parts * per;
#pragma unroll 4
    for (int64_t r = part * per + tid / d; r < n_rows; r += stride)
      m = min(m, load1<NC>(x + r * d + col));
  }
  if (32 % d == 0) {
    // lanes of one column are d apart: a butterfly over the offsets >= d
    for (int o = 16; o >= d; o >>= 1)
      m = min(m, __shfl_xor_sync(kFullMask, m, o));
    if (lane < d) sm[warp * d + lane] = m;
    __syncthreads();
    if (tid < d) {
      int32_t res = INT32_MAX;
      for (int w = 0; w < n_warps; ++w) res = min(res, sm[w * d + tid]);
      dst[tid] = res;
    }
  } else {
    sm[tid] = m;
    __syncthreads();
    if (tid < d) {
      int32_t res = INT32_MAX;
      for (int j = tid; j < per * d; j += d) res = min(res, sm[j]);
      dst[tid] = res;
    }
  }
}

// The one-block path: no grid, so no cooperative launch.
__global__ void __launch_bounds__(kMinOneThreads)
    stable_min_block_kernel(const int32_t* __restrict__ x, int64_t n_rows,
                            int d, bool vec, int32_t* __restrict__ out) {
  __shared__ int32_t sm[kMinOneThreads];
  block_colmin<true>(x, n_rows, d, vec, 0, 1, sm, out);
}

// A cooperative grid with a partials buffer int32[gridDim, d].
__global__ void __launch_bounds__(kMinGridThreads)
    stable_min_grid_kernel(const int32_t* __restrict__ x, int64_t n_rows,
                           int d, bool vec, int32_t* partials,
                           bool vec_parts, int32_t* __restrict__ out) {
  __shared__ int32_t sm[kMinGridThreads];
  block_colmin<true>(x, n_rows, d, vec, blockIdx.x, gridDim.x, sm,
                     partials + blockIdx.x * (int64_t)d);
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0)
    block_colmin<false>(partials, gridDim.x, d, vec_parts, 0, 1, sm, out);
}

}  // namespace

extern "C" {

const char* materializer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// orset_presence, mask form: out uint8[n_keys, e]
int orset_presence_launch(const void* addvc, const void* rmvc,
                          const void* elems, void* out, long long n_keys,
                          int e, int d, void* stream) {
  const OrsetArgs a = {(const int32_t*)addvc, (const int32_t*)rmvc,
                       (const int64_t*)elems, (uint8_t*)out, nullptr,
                       nullptr, n_keys, e, d, 0, log_group(e)};
  return launch_orset<false>(a, (cudaStream_t)stream);
}

// orset_presence, compacted form: top int64[n_keys, t] (t <= e), count
// int32[n_keys]
int orset_resolve_launch(const void* addvc, const void* rmvc,
                         const void* elems, void* top, void* count,
                         long long n_keys, int e, int d, int t,
                         void* stream) {
  const OrsetArgs a = {(const int32_t*)addvc, (const int32_t*)rmvc,
                       (const int64_t*)elems, nullptr, (int64_t*)top,
                       (int32_t*)count, n_keys, e, d, t, log_group(e)};
  return launch_orset<true>(a, (cudaStream_t)stream);
}

// deltas[b, s] at deltas + b * row_stride + s * el_stride (int64 words)
int counter_fold_launch(const void* base_cnt, const void* deltas,
                        const void* ops_vc, const void* n_ops,
                        const void* base_vc, const void* read_vc,
                        void* out_cnt, void* applied, long long n_keys,
                        long long row_stride, long long el_stride, int k,
                        int d, void* stream) {
  const CounterArgs a = {
      (const int64_t*)base_cnt, (const int64_t*)deltas,
      (const int32_t*)ops_vc,   (const int32_t*)n_ops,
      (const int32_t*)base_vc,  (const int32_t*)read_vc,
      (int64_t*)out_cnt,        (int32_t*)applied,
      n_keys, row_stride, el_stride, k, d,
      log_group((k + kCounterSlots - 1) / kCounterSlots)};
  const bool vec = d == 4 && aligned16(ops_vc) && aligned16(base_vc) &&
                   aligned16(read_vc);
  const unsigned blocks =
      blocks_for(group_threads(n_keys, a.log_g), kCounterThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    counter_fold_kernel<true><<<blocks, kCounterThreads, 0, st>>>(a);
  else
    counter_fold_kernel<false><<<blocks, kCounterThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// One launch of an empty one-warp kernel (counted by no path).
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The name of the set_aw_fold variant the launcher takes for (E, D), and
// the names of them all, comma-separated.
const char* set_aw_fold_variant(int e, int d) {
  const FoldVariant* v = pick_fold(e, d);
  return v ? v->name : "";
}

const char* set_aw_fold_variant_names() {
  static const std::string names = [] {  // built once, thread-safe
    std::string s;
    for (const FoldVariant& v : kFoldVariants) {
      if (!s.empty()) s += ',';
      s += v.name;
    }
    return s;
  }();
  return names.c_str();
}

int set_aw_fold_launch(const void* elems0, const void* addvc0,
                       const void* rmvc0, const void* ovf0, const void* ops_a,
                       const void* ops_b, const void* ops_vc,
                       const void* origin, const void* n_ops,
                       const void* base_vc, const void* read_vc, void* elems,
                       void* addvc, void* rmvc, void* ovf, void* applied,
                       long long n_keys, int k, int e, int d, int a_w,
                       int b_w, void* stream) {
  const FoldVariant* v = pick_fold(e, d);
  if (!v) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(addvc0) && aligned16(rmvc0) &&
                   aligned16(ops_vc) && aligned16(base_vc) &&
                   aligned16(read_vc) && aligned16(addvc) && aligned16(rmvc);
  const SetAwArgs a = {
      (const int64_t*)elems0, (const int32_t*)addvc0, (const int32_t*)rmvc0,
      (const int32_t*)ovf0,   (const int64_t*)ops_a,  (const int32_t*)ops_b,
      (const int32_t*)ops_vc, (const int32_t*)origin, (const int32_t*)n_ops,
      (const int32_t*)base_vc, (const int32_t*)read_vc, (int64_t*)elems,
      (int32_t*)addvc,        (int32_t*)rmvc,         (int32_t*)ovf,
      (int32_t*)applied,      n_keys, k, e, d, a_w, b_w, vec};
  v->launch(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// n_rows >= 1, d >= 1.  partials == nullptr: one block.  Else a
// cooperative grid of at most min(max_parts, co-resident blocks) blocks,
// partials holding max_parts * d int32.
int stable_min_launch(const void* clocks, void* out, void* partials,
                      int max_parts, long long n_rows, int d, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* x = (const int32_t*)clocks;
  int32_t* o = (int32_t*)out;
  const bool vec = (d == 1 || d == 2 || d == 4) && aligned16(clocks);
  if (partials == nullptr) {
    stable_min_block_kernel<<<1, kMinOneThreads, 0, st>>>(
        x, (int64_t)n_rows, d, vec, o);
    return (int)cudaGetLastError();
  }
  // co-resident blocks of the grid, read once per device
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int cap = dev < kMaxDevices ? __atomic_load_n(&resident[dev],
                                                __ATOMIC_RELAXED) : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stable_min_grid_kernel, kMinGridThreads, 0);
    if (err != cudaSuccess) return (int)err;
    cap = sms * per_sm;
    if (dev < kMaxDevices)
      __atomic_store_n(&resident[dev], cap, __ATOMIC_RELAXED);
  }
  // about four 16-byte loads (or four words) a thread
  const int64_t units = vec ? n_rows * d / 4 : n_rows * d;
  int64_t blocks = (units + kMinGridThreads * 4 - 1) / (kMinGridThreads * 4);
  if (blocks > cap) blocks = cap;
  if (blocks > max_parts) blocks = max_parts;
  if (blocks < 1) blocks = 1;
  int64_t rows = n_rows;
  bool vec_parts = (d == 1 || d == 2 || d == 4) && aligned16(partials);
  int32_t* parts = (int32_t*)partials;
  void* args[] = {(void*)&x,    (void*)&rows,      (void*)&d, (void*)&vec,
                  (void*)&parts, (void*)&vec_parts, (void*)&o};
  err = cudaLaunchCooperativeKernel((const void*)stable_min_grid_kernel,
                                    dim3((unsigned)blocks),
                                    dim3(kMinGridThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

// Materializer kernels for Hopper (sm_90a): the OR-set presence test, the
// counter_pn ring fold, the set_aw ring fold and the stable-time column min.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------------
// orset_presence
//
// Replaces antidote_tpu/materializer/pallas_kernels.py::_presence_kernel
// (orset_presence).  present[b, e] = (exists d: addvc > rmvc) && elems != 0.
// Bound: bytes — per slot it reads 2*D int32 clocks and one int64 handle and
// writes one byte, against D compares.  Design: one thread per (b, e) slot;
// neighbouring threads read neighbouring slots, so each warp's loads cover
// contiguous rows of addvc / rmvc / elems.
// ---------------------------------------------------------------------------
__global__ void orset_presence_kernel(const int32_t* __restrict__ addvc,
                                      const int32_t* __restrict__ rmvc,
                                      const int64_t* __restrict__ elems,
                                      uint8_t* __restrict__ out,
                                      int64_t n_slots, int d) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int32_t* a = addvc + i * d;
  const int32_t* r = rmvc + i * d;
  bool present = false;
  for (int j = 0; j < d; ++j) present |= a[j] > r[j];
  out[i] = (present && elems[i] != 0) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// counter_fold
//
// Replaces pallas_kernels.py::_counter_fold_kernel (counter_fold /
// counter_fold_local).  cnt[b] = base_cnt[b] + sum of deltas[b, s] over the
// ring slots s < n_ops[b] with !(ops_vc <= base_vc) && ops_vc <= read_vc;
// applied[b] counts them.  The sum is int64, so no delta bound applies (the
// TPU kernel summed in int32 and refused |delta| > INT32_MAX / K).
// Bound: bytes — each slot is D clock lanes plus one int64 delta against
// 2*D compares.  Design: one thread per key walks only its n_ops written
// slots (the work a key's data needs), keeping the sum in a register.
// ---------------------------------------------------------------------------
__global__ void counter_fold_kernel(const int64_t* __restrict__ base_cnt,
                                    const int64_t* __restrict__ deltas,
                                    const int32_t* __restrict__ ops_vc,
                                    const int32_t* __restrict__ n_ops,
                                    const int32_t* __restrict__ base_vc,
                                    const int32_t* __restrict__ read_vc,
                                    int64_t* __restrict__ out_cnt,
                                    int32_t* __restrict__ applied,
                                    int64_t n_keys, int k, int d) {
  const int64_t key = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (key >= n_keys) return;
  const int32_t* bv = base_vc + key * d;
  const int32_t* rv = read_vc + key * d;
  const int n = min(n_ops[key], k);
  int64_t sum = 0;
  int32_t count = 0;
  for (int s = 0; s < n; ++s) {
    const int32_t* v = ops_vc + (key * k + s) * d;
    bool in_base = true, visible = true;
    for (int j = 0; j < d; ++j) {
      in_base &= v[j] <= bv[j];
      visible &= v[j] <= rv[j];
    }
    if (!in_base && visible) {
      sum += deltas[key * k + s];
      ++count;
    }
  }
  out_cnt[key] = base_cnt[key] + sum;
  applied[key] = count;
}

// ---------------------------------------------------------------------------
// set_aw_fold
//
// Replaces pallas_kernels.py::_set_aw_fold_kernel (set_aw_fold /
// set_aw_fold_local): the add-wins observed-remove rule of SetAW.apply
// replayed over each key's ring in slot order, for the slots the inclusion
// test admits.
//   add h:    take the first slot with elems == h (h != 0); else the first
//             slot that is not present, zeroing both of its clock rows; then
//             addvc[origin] = max(addvc[origin], ops_vc[origin]).  With no
//             such slot, ovf += 1 and nothing else changes.
//   remove h: the first matching slot's rmvc = max(rmvc, observed add VC);
//             with no match nothing changes.
// Every included op counts in `applied`.
// Keys are independent; the slots of one key are serial.  Bound: bytes for
// the state and ring, but each included op rescans the key's E slots, which
// stay in L1 across the key's ring.  Design: one warp per key.  The state is
// copied from the base into the output buffers, then updated in place.  The
// inclusion test spreads the D clock lanes over the warp's lanes and
// reduces with __all_sync; first-match and first-free scan the E slots in
// chunks of 32 with __ballot_sync + __ffs, so any tier width E = 16 * 4^t
// works; the chosen slot's D clock lanes are written by D lanes of the warp.
// ---------------------------------------------------------------------------
__global__ void set_aw_fold_kernel(
    const int64_t* __restrict__ elems0, const int32_t* __restrict__ addvc0,
    const int32_t* __restrict__ rmvc0, const int32_t* __restrict__ ovf0,
    const int64_t* __restrict__ ops_a, const int32_t* __restrict__ ops_b,
    const int32_t* __restrict__ ops_vc, const int32_t* __restrict__ origin,
    const int32_t* __restrict__ n_ops, const int32_t* __restrict__ base_vc,
    const int32_t* __restrict__ read_vc, int64_t* elems, int32_t* addvc,
    int32_t* rmvc, int32_t* __restrict__ ovf, int32_t* __restrict__ applied,
    int64_t n_keys, int k, int e, int d, int a_w, int b_w) {
  const int lane = threadIdx.x & 31;
  const int64_t key = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (key >= n_keys) return;  // uniform across the warp

  int64_t* el = elems + key * e;
  int32_t* av = addvc + key * e * d;
  int32_t* rv = rmvc + key * e * d;
  for (int i = lane; i < e; i += 32) el[i] = elems0[key * e + i];
  for (int i = lane; i < e * d; i += 32) {
    av[i] = addvc0[key * e * d + i];
    rv[i] = rmvc0[key * e * d + i];
  }
  __syncwarp();

  const int32_t* bv = base_vc + key * d;
  const int32_t* rdv = read_vc + key * d;
  const int n = min(n_ops[key], k);
  int32_t n_ovf = ovf0[key];
  int32_t n_applied = 0;
  for (int s = 0; s < n; ++s) {
    const int64_t op = key * k + s;
    const int32_t* v = ops_vc + op * d;
    const int32_t vl = lane < d ? v[lane] : 0;
    const bool in_base = __all_sync(kFullMask, lane >= d || vl <= bv[lane]);
    const bool visible = __all_sync(kFullMask, lane >= d || vl <= rdv[lane]);
    if (in_base || !visible) continue;
    ++n_applied;
    const int64_t h = ops_a[op * a_w];
    const int32_t* ob = ops_b + op * b_w;
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
        int32_t a = fresh ? 0 : av[idx * d + lane];
        const int32_t r = fresh ? 0 : rv[idx * d + lane];
        if (lane == origin[op]) a = max(a, vl);
        av[idx * d + lane] = a;
        rv[idx * d + lane] = r;
      }
      if (lane == 0) el[idx] = h;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ovf[key] = n_ovf;
    applied[key] = n_applied;
  }
}

// ---------------------------------------------------------------------------
// stable_min
//
// Replaces pallas_kernels.py::_stable_min_kernel (stable_min): the
// column-wise minimum of a clock matrix int32[N, D], the stable-time merge
// over every member's per-shard clock rows.  INT32_MAX is the identity; the
// output arrives filled with it, so N == 0 leaves it untouched.
// Bound: bytes — N * D int32 read once against one compare each; at the
// cluster path's 2048 x 4 (32 KiB) the launch itself dominates.  Design: a
// grid-stride loop whose stride S is a multiple of D, so each thread stays
// on one column while a warp's loads cover contiguous words; each block
// then folds its threads' minima per column through shared memory (the
// first thread of each column class scans its class), and issues one
// integer atomicMin per column — exact and order-free.  Nothing of the TPU
// kernel's (block, D) tiling or INT32_MAX padding is kept: the ragged tail
// is just the loop's bound.
// ---------------------------------------------------------------------------
constexpr int kMinThreads = 256;

__global__ void stable_min_kernel(const int32_t* __restrict__ clocks,
                                  int32_t* __restrict__ out, int64_t n_elems,
                                  int d, int64_t stride) {
  __shared__ int32_t part[kMinThreads];
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int32_t m = INT32_MAX;
  if (t < stride)
    for (int64_t i = t; i < n_elems; i += stride) m = min(m, __ldg(clocks + i));
  part[threadIdx.x] = m;
  __syncthreads();
  // threads tid < D of a block hold D distinct columns; each folds the
  // block's other threads of its column (tid + k * D)
  if ((int)threadIdx.x < d) {
    for (int j = threadIdx.x + d; j < (int)blockDim.x; j += d)
      m = min(m, part[j]);
    const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (m != INT32_MAX && first < stride) atomicMin(out + first % d, m);
  }
}

inline unsigned blocks_for(int64_t threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

const char* materializer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int orset_presence_launch(const void* addvc, const void* rmvc,
                          const void* elems, void* out, long long n_slots,
                          int d, void* stream) {
  orset_presence_kernel<<<blocks_for(n_slots, 256), 256, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)addvc, (const int32_t*)rmvc, (const int64_t*)elems,
      (uint8_t*)out, n_slots, d);
  return (int)cudaGetLastError();
}

int counter_fold_launch(const void* base_cnt, const void* deltas,
                        const void* ops_vc, const void* n_ops,
                        const void* base_vc, const void* read_vc,
                        void* out_cnt, void* applied, long long n_keys, int k,
                        int d, void* stream) {
  counter_fold_kernel<<<blocks_for(n_keys, 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (const int64_t*)base_cnt, (const int64_t*)deltas,
      (const int32_t*)ops_vc, (const int32_t*)n_ops, (const int32_t*)base_vc,
      (const int32_t*)read_vc, (int64_t*)out_cnt, (int32_t*)applied, n_keys,
      k, d);
  return (int)cudaGetLastError();
}

int set_aw_fold_launch(const void* elems0, const void* addvc0,
                       const void* rmvc0, const void* ovf0, const void* ops_a,
                       const void* ops_b, const void* ops_vc,
                       const void* origin, const void* n_ops,
                       const void* base_vc, const void* read_vc, void* elems,
                       void* addvc, void* rmvc, void* ovf, void* applied,
                       long long n_keys, int k, int e, int d, int a_w,
                       int b_w, void* stream) {
  set_aw_fold_kernel<<<blocks_for(n_keys * 32, 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const int64_t*)elems0, (const int32_t*)addvc0, (const int32_t*)rmvc0,
      (const int32_t*)ovf0, (const int64_t*)ops_a, (const int32_t*)ops_b,
      (const int32_t*)ops_vc, (const int32_t*)origin, (const int32_t*)n_ops,
      (const int32_t*)base_vc, (const int32_t*)read_vc, (int64_t*)elems,
      (int32_t*)addvc, (int32_t*)rmvc, (int32_t*)ovf, (int32_t*)applied,
      n_keys, k, e, d, a_w, b_w);
  return (int)cudaGetLastError();
}

// `out` must hold D int32 set to INT32_MAX; n_rows >= 1, d >= 1.
int stable_min_launch(const void* clocks, void* out, long long n_rows, int d,
                      void* stream) {
  const int64_t n = n_rows * (int64_t)d;
  // ~8 elements a thread, at most 8 blocks an SM, and at least D threads
  int64_t blocks = blocks_for(n, kMinThreads * 8);
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < blocks_for(d, kMinThreads)) blocks = blocks_for(d, kMinThreads);
  const int64_t stride = blocks * kMinThreads / d * d;
  stable_min_kernel<<<(unsigned)blocks, kMinThreads, 0,
                      (cudaStream_t)stream>>>((const int32_t*)clocks,
                                              (int32_t*)out, n, d, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"

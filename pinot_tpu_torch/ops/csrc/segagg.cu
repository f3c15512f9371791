// Partition aggregate of the window stage (sum, count, avg, min or max of
// int64 or float64 values per segment, gathered back to the rows) for
// Hopper (sm_90a).
//
// Replaces the traced partition aggregate of the window stage,
// pinot_tpu/multistage/window.py:451 (_segment_agg_jit: segment_sum /
// segment_min / segment_max into `segs` segments, then jnp.take of the
// rows' segments). out[i] = per[ids[i]], per[s] the op over the values
// of the rows whose id is s; ids lie in [0, segs). count counts rows and
// reads no values (the caller passes ones, so this is the reference's
// segment_sum of them); avg is a float64 sum (or an int64 sum, converted)
// over a float64 count. int64 sums wrap. min and max order float64 values
// as IEEE totalOrder does for zeros: min keeps -0.0 over +0.0 and max
// keeps +0.0 over -0.0, whichever came first, as the reference's
// segment_min / segment_max do (NaN never arrives: the caller keeps NaN
// columns on the host). A segment no row names is never gathered.
//
// What bounds it: bytes. A call must read each id (8 B) and each value
// (8 B; none for count) once and write each result (8 B) once: 24 B a row,
// a few operations each. The design reads the ids twice (once to reduce,
// once to gather; the values are streamed past the L2, so the ids the
// reduce read are mostly still there for the gather) and every other
// byte once.
//
// Shared-memory route, segs <= CAP (4,096): a reduce launch writes one
// partial (an accumulator word a segment) per block of a grid of as many
// blocks as are resident (fewer for small n), each over a contiguous span
// of rows; the last block to finish (a ticket) folds the partials in
// block order into per, or, when blocks x words exceed
// COMBINE_IN_BLOCK_MAX, a small second launch (segagg_combine) does; then
// segagg_gather writes out[i] = per[ids[i]]. Two device operations a call
// (three with the combine launch). The reduce takes one of three forms:
//   * segagg_reduce_private, up to PRIVATE_WORDS words (64: 64 segments,
//     32 for avg; the window stage's partitions are usually this few):
//     every thread owns its bins in shared memory (word k of thread t at
//     k * blockDim + t, so a warp's updates never share a bank), takes its
//     rows in order and updates them with plain loads and stores; the
//     bins are then folded across each warp by a fixed shuffle tree and
//     across the warps in warp order. No atomics and no contention, for
//     every op.
//   * segagg_reduce_atomic, the exact ops (integer sums, counts, min and
//     max) past that: bins in shared memory updated by shared-memory
//     atomics, whose result does not depend on their order, in as many
//     copies as ATOMIC_SMEM holds (warp w updates copy w % copies, so fewer
//     lanes contend for a bin), folded at the end.
//   * segagg_reduce_rounds, float64 sums and averages past that: each warp
//     owns bins in shared memory and takes 32-row steps of its block's
//     span; a step's rows go into the bins in rounds, the lowest pending
//     lane of each id (__match_any_sync) updating its bin, so a bin sees
//     its rows in row order and no update races another. Then the warps'
//     bins are folded in warp order. This form is the slowest (a round
//     costs a match and a shared-memory round trip).
// Every association of a float64 sum is fixed by n, segs and the card, so
// the route gives the same bits on every launch; they differ from the
// plain version's (ops/segagg.py) by rounding only. The scratch (ticket
// counter, partials) is the wrapper's per (device, stream) buffer: the
// counter is zeroed when allocated and set back to 0 by the last block,
// and every partial is written before it is read, so no call clears it.
//
// Global route, segs > CAP (up to one segment a row): a memset of per,
// segagg_atomic (64-bit atomics into per: integer adds, which wrap as the
// plain version's do, float64 adds, and for min and max an unsigned max
// over order-preserving keys, so both stay exact), then the gather. The
// float64 sums of this route are held to the plain version to a relative
// 1e-12 and may differ in their last bits between launches, as
// index_add_ on the card does.
//
// Every accumulator is one 64-bit word whose identity is 0: integer and
// float64 (+0.0) sums, counts, and for max the key of the value (keys
// order as the values do, -0.0 below +0.0), for min the complement of its
// key, both combined by an unsigned max. avg keeps its sums in the first
// segs words and its counts in the next segs.
//
// Plain C interface, bound from Python with ctypes
// (pinot_tpu_torch/ops/segagg.py). Nothing is allocated here: the wrapper
// passes the output, per (2 segs words for avg, segs otherwise) and the
// scratch. Every launch is checked and the first CUDA error code is
// returned (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define CAP 4096
#define PRIVATE_WORDS 64
#define PRIVATE_THREADS 256
#define PRIVATE_BYTES (32 * 1024)
#define ATOMIC_BLOCK 1024
#define ATOMIC_SMEM (64 * 1024)
#define MAX_WARPS 8
#define SMEM_MAX (200 * 1024)
#define PF 8
#define MIN_ROWS_A_THREAD 8
#define COMBINE_IN_BLOCK_MAX (1 << 15)
#define GATHER_THREADS 256
#define ATOMIC_THREADS 256
#define FULL 0xffffffffu
#define NO_KEY 0xffffffffu
#define SIGN 0x8000000000000000ull
#define MAX_DEVICES 16

enum { OP_SUM = 0, OP_COUNT = 1, OP_AVG = 2, OP_MIN = 3, OP_MAX = 4 };
// how two accumulator words combine
enum { K_IADD = 0, K_DADD = 1, K_UMAX = 2 };

__device__ __forceinline__ unsigned long long dbits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}

// order-preserving keys: a < b as values iff key(a) < key(b) as unsigned
template <typename T>
__device__ __forceinline__ unsigned long long order_key(unsigned long long b);
template <>
__device__ __forceinline__ unsigned long long order_key<long long>(
    unsigned long long b) {
  return b ^ SIGN;
}
template <>
__device__ __forceinline__ unsigned long long order_key<double>(
    unsigned long long b) {
  return (b & SIGN) ? ~b : b ^ SIGN;
}

template <typename T>
__device__ __forceinline__ unsigned long long from_key(unsigned long long k);
template <>
__device__ __forceinline__ unsigned long long from_key<long long>(
    unsigned long long k) {
  return k ^ SIGN;
}
template <>
__device__ __forceinline__ unsigned long long from_key<double>(
    unsigned long long k) {
  return (k & SIGN) ? k ^ SIGN : ~k;
}

template <typename T>
struct is_double { static constexpr bool value = false; };
template <>
struct is_double<double> { static constexpr bool value = true; };

// how the first segs words (the sums, counts or keys) combine
template <typename T, int OP>
__device__ __forceinline__ constexpr int first_kind() {
  return (OP == OP_MIN || OP == OP_MAX)
             ? K_UMAX
             : ((OP != OP_COUNT && is_double<T>::value) ? K_DADD : K_IADD);
}

template <typename T, int OP>
__device__ __forceinline__ int kind_at(int k, int segs) {
  return (OP == OP_AVG && k >= segs) ? K_IADD : first_kind<T, OP>();
}

__device__ __forceinline__ unsigned long long comb(int kind,
                                                   unsigned long long a,
                                                   unsigned long long b) {
  if (kind == K_IADD) return a + b;
  if (kind == K_DADD) {
    return dbits(__longlong_as_double((long long)a) +
                 __longlong_as_double((long long)b));
  }
  return a > b ? a : b;
}

// a row's value as an accumulator word (the first half's)
template <typename T, int OP>
__device__ __forceinline__ unsigned long long lift(unsigned long long v) {
  if (OP == OP_COUNT) return 1ull;
  if (OP == OP_MIN) return ~order_key<T>(v);
  if (OP == OP_MAX) return order_key<T>(v);
  return v;
}

// One 32-row step into a warp's bins, in rounds: in each, the lowest
// pending lane of every id updates that id's bin, so a bin takes its rows
// in lane (row) order and no two lanes touch one bin at once.
template <typename T, int OP>
__device__ __forceinline__ void add_step(unsigned long long* bins, int segs,
                                         unsigned key, unsigned long long v,
                                         int lane) {
  constexpr int kind = first_kind<T, OP>();
  const unsigned long long x = lift<T, OP>(v);
  unsigned pending = __ballot_sync(FULL, key != NO_KEY);
  while (pending) {
    const unsigned peers = __match_any_sync(FULL, key) & pending;
    const bool go = ((pending >> lane) & 1u) && __ffs(peers) - 1 == lane;
    if (go) {
      bins[key] = comb(kind, bins[key], x);
      if (OP == OP_AVG) bins[segs + key] += 1ull;
    }
    __syncwarp();
    pending &= ~__ballot_sync(FULL, go);
  }
}

// per[k] for k in [0, words): the blocks' partials folded in block order,
// by the calling block (the last of the reduce), with `spare` (>= the
// block's threads words of shared memory) for the chunks.
template <typename T, int OP>
__device__ void combine_in_block(const unsigned long long* partials, int G,
                                 int words, int segs,
                                 unsigned long long* per,
                                 unsigned long long* spare) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (words >= nt) {
    for (int k = t; k < words; k += nt) {
      const int kind = kind_at<T, OP>(k, segs);
      unsigned long long a = 0;
      for (int b = 0; b < G; ++b) {
        a = comb(kind, a, __ldcg(partials + (int64_t)b * words + k));
      }
      per[k] = a;
    }
    return;
  }
  // fewer words than threads: C chunks of blocks a word, then the chunks
  // in order
  const int C = nt / words;
  const int k = t % words, c = t / words;
  const int kind = kind_at<T, OP>(k, segs);
  if (c < C) {
    unsigned long long a = 0;
    const int b1 = (int)((int64_t)(c + 1) * G / C);
    for (int b = (int)((int64_t)c * G / C); b < b1; ++b) {
      a = comb(kind, a, __ldcg(partials + (int64_t)b * words + k));
    }
    spare[c * words + k] = a;
  }
  __syncthreads();
  if (t < words) {
    unsigned long long a = 0;
    for (int j = 0; j < C; ++j) a = comb(kind, a, spare[j * words + t]);
    per[t] = a;
  }
}

// After a block has written its partial: the last block to finish (a
// ticket) folds every block's partial into per when combine_here, and
// sets the counter back to 0 for the next call.
template <typename T, int OP>
__device__ void finish_block(const unsigned long long* partials, int words,
                             int segs, unsigned long long* counter,
                             unsigned long long* per, int combine_here,
                             unsigned long long* spare) {
  __shared__ int s_last;
  if (!combine_here) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1ull) == (unsigned long long)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x == 0) *counter = 0;  // every block has drawn
  __threadfence();
  combine_in_block<T, OP>(partials, gridDim.x, words, segs, per, spare);
}

// The rows of block b: [b * span, min(n, (b + 1) * span)).
__device__ __forceinline__ void block_rows(int64_t n, int64_t span,
                                           int64_t* lo, int64_t* hi) {
  *lo = (int64_t)blockIdx.x * span;
  *hi = n - *lo < span ? n : *lo + span;
}

__device__ __forceinline__ unsigned key_of(long long id, int segs) {
  return (unsigned long long)id < (unsigned long long)segs ? (unsigned)id
                                                           : NO_KEY;
}

// Up to PRIVATE_WORDS accumulator words (segments, twice for avg): every
// thread owns a set of bins in shared memory (word k of thread t at
// k * blockDim + t, so a warp's updates never share a bank; blocks of
// PRIVATE_BYTES / (8 words) threads, 64 to 256) and takes the rows t,
// t + blockDim, ... of its block's span in order, PF at a time; then each
// word is folded across the warp by a shuffle tree and across the warps in
// warp order. No atomics, and a fixed order for every op.
template <typename T, int OP>
__global__ void __launch_bounds__(PRIVATE_THREADS)
segagg_reduce_private(const long long* __restrict__ ids,
                      const unsigned long long* __restrict__ vals, int64_t n,
                      int segs, int64_t span,
                      unsigned long long* __restrict__ partials,
                      unsigned long long* __restrict__ counter,
                      unsigned long long* __restrict__ per,
                      int combine_here) {
  constexpr int kind = first_kind<T, OP>();
  constexpr int BW = OP == OP_AVG ? 2 : 1;
  extern __shared__ __align__(16) unsigned long long bins[];
  __shared__ unsigned long long red[PRIVATE_THREADS / 32][PRIVATE_WORDS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nt = blockDim.x;
  const int words = BW * segs;
  for (int k = 0; k < words; ++k) bins[k * nt + t] = 0;
  int64_t lo, hi;
  block_rows(n, span, &lo, &hi);
  for (int64_t r0 = lo + t; r0 < hi; r0 += (int64_t)PF * nt) {
    unsigned key[PF];
    unsigned long long v[PF];
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int64_t row = r0 + (int64_t)j * nt;
      key[j] = NO_KEY;
      v[j] = 0;
      if (row < hi) {
        key[j] = key_of(ids[row], segs);
        if (OP != OP_COUNT) v[j] = __ldcs(vals + row);
      }
    }
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      if (key[j] == NO_KEY) continue;
      unsigned long long* b = bins + key[j] * nt + t;
      *b = comb(kind, *b, lift<T, OP>(v[j]));
      if (OP == OP_AVG) b[segs * nt] += 1ull;
    }
  }
  // each word across the warp (a fixed shuffle tree), then the warps
  for (int k = 0; k < words; ++k) {
    const int kk = kind_at<T, OP>(k, segs);
    unsigned long long a = bins[k * nt + t];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a = comb(kk, a, __shfl_down_sync(FULL, a, d));
    }
    if (lane == 0) red[warp][k] = a;
  }
  __syncthreads();
  unsigned long long* mine = partials + (int64_t)blockIdx.x * words;
  for (int k = t; k < words; k += nt) {
    const int kk = kind_at<T, OP>(k, segs);
    unsigned long long a = 0;
    for (int w = 0; w < nt / 32; ++w) a = comb(kk, a, red[w][k]);
    mine[k] = a;
  }
  finish_block<T, OP>(partials, words, segs, counter, per, combine_here,
                      bins);
}

// Exact ops (integer sums, counts, min and max), up to CAP segments: bins
// in shared memory updated by shared-memory atomics (the result does not
// depend on their order), `copies` sets of them a block (warp w updates
// set w % copies, so fewer lanes contend for one bin), folded at the end.
template <typename T, int OP>
__global__ void __launch_bounds__(ATOMIC_BLOCK)
segagg_reduce_atomic(const long long* __restrict__ ids,
                     const unsigned long long* __restrict__ vals, int64_t n,
                     int segs, int64_t span, int copies,
                     unsigned long long* __restrict__ partials,
                     unsigned long long* __restrict__ counter,
                     unsigned long long* __restrict__ per, int combine_here) {
  extern __shared__ __align__(16) unsigned long long bins[];
  constexpr int kind = first_kind<T, OP>();
  constexpr int BW = OP == OP_AVG ? 2 : 1;
  const int t = threadIdx.x;
  const int words = BW * segs;
  for (int k = t; k < copies * words; k += blockDim.x) bins[k] = 0;
  __syncthreads();
  unsigned long long* mine_bins = bins + ((t >> 5) % copies) * words;
  int64_t lo, hi;
  block_rows(n, span, &lo, &hi);
  for (int64_t r0 = lo + t; r0 < hi; r0 += (int64_t)PF * blockDim.x) {
    unsigned key[PF];
    unsigned long long v[PF];
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int64_t row = r0 + (int64_t)j * blockDim.x;
      key[j] = NO_KEY;
      v[j] = 0;
      if (row < hi) {
        key[j] = key_of(ids[row], segs);
        if (OP != OP_COUNT) v[j] = __ldcs(vals + row);
      }
    }
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      if (key[j] == NO_KEY) continue;
      const unsigned long long x = lift<T, OP>(v[j]);
      if (kind == K_UMAX) {
        atomicMax(mine_bins + key[j], x);
      } else {
        atomicAdd(mine_bins + key[j], x);
      }
      if (OP == OP_AVG) atomicAdd(mine_bins + segs + key[j], 1ull);
    }
  }
  __syncthreads();
  unsigned long long* mine = partials + (int64_t)blockIdx.x * words;
  for (int k = t; k < words; k += blockDim.x) {
    const int kk = kind_at<T, OP>(k, segs);
    unsigned long long a = 0;
    for (int c = 0; c < copies; ++c) a = comb(kk, a, bins[c * words + k]);
    mine[k] = a;
  }
  finish_block<T, OP>(partials, words, segs, counter, per, combine_here,
                      bins);
}

// float64 sums (and averages) over more than PRIVATE_WORDS words: each warp
// owns a set of bins in shared memory and takes 32-row steps of its
// block's span (warp w: steps w, w + W, ...), PF steps of loads at a time,
// each step in rounds (add_step); then the warps' bins in warp order.
template <typename T, int OP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
segagg_reduce_rounds(const long long* __restrict__ ids,
                     const unsigned long long* __restrict__ vals, int64_t n,
                     int segs, int64_t span,
                     unsigned long long* __restrict__ partials,
                     unsigned long long* __restrict__ counter,
                     unsigned long long* __restrict__ per, int combine_here) {
  extern __shared__ __align__(16) unsigned long long bins[];
  constexpr int BW = OP == OP_AVG ? 2 : 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = blockDim.x >> 5;
  const int words = BW * segs;
  for (int k = t; k < W * words; k += blockDim.x) bins[k] = 0;
  __syncthreads();

  unsigned long long* wb = bins + warp * words;
  int64_t lo, hi;
  block_rows(n, span, &lo, &hi);
  const int64_t steps = (hi - lo + 31) / 32;
  for (int64_t s0 = warp; s0 < steps; s0 += (int64_t)W * PF) {
    unsigned key[PF];
    unsigned long long v[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int64_t row = lo + (s0 + (int64_t)k * W) * 32 + lane;
      key[k] = NO_KEY;
      v[k] = 0;
      if (row < hi) {
        key[k] = key_of(ids[row], segs);
        v[k] = __ldcs(vals + row);
      }
    }
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      if (s0 + (int64_t)k * W < steps) {
        add_step<T, OP>(wb, segs, key[k], v[k], lane);
      }
    }
  }
  __syncthreads();

  unsigned long long* mine = partials + (int64_t)blockIdx.x * words;
  for (int k = t; k < words; k += blockDim.x) {
    const int kind = kind_at<T, OP>(k, segs);
    unsigned long long a = 0;
    for (int w = 0; w < W; ++w) a = comb(kind, a, bins[w * words + k]);
    mine[k] = a;
  }
  finish_block<T, OP>(partials, words, segs, counter, per, combine_here,
                      bins);
}

// per from the blocks' partials when there are too many for the last
// block: a block takes 8 words, 32 chunks of the blocks each, the chunks
// folded in order.
template <typename T, int OP>
__global__ void __launch_bounds__(256)
segagg_combine(const unsigned long long* __restrict__ partials, int G,
               int words, int segs, unsigned long long* __restrict__ per) {
  __shared__ unsigned long long part[32][8];
  const int kw = threadIdx.x & 7, c = threadIdx.x >> 3;
  const int k = blockIdx.x * 8 + kw;
  const int kind = kind_at<T, OP>(k, segs);
  unsigned long long a = 0;
  if (k < words) {
    const int b1 = (int)((int64_t)(c + 1) * G / 32);
    for (int b = (int)((int64_t)c * G / 32); b < b1; ++b) {
      a = comb(kind, a, partials[(int64_t)b * words + k]);
    }
  }
  part[c][kw] = a;
  __syncthreads();
  if (threadIdx.x < 8 && k < words) {
    a = 0;
    for (int j = 0; j < 32; ++j) a = comb(kind, a, part[j][kw]);
    per[k] = a;
  }
}

template <typename T, int OP>
__global__ void segagg_atomic(const long long* __restrict__ ids,
                              const unsigned long long* __restrict__ vals,
                              int64_t n, int segs,
                              unsigned long long* __restrict__ per) {
  constexpr int kind = first_kind<T, OP>();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long id = ids[i];
    if ((unsigned long long)id >= (unsigned long long)segs) continue;
    const unsigned long long x =
        lift<T, OP>(OP == OP_COUNT ? 0ull : __ldcs(vals + i));
    if (kind == K_IADD) {
      atomicAdd(per + id, x);
    } else if (kind == K_DADD) {
      atomicAdd(reinterpret_cast<double*>(per + id),
                __longlong_as_double((long long)x));
    } else {
      atomicMax(per + id, x);
    }
    if (OP == OP_AVG) atomicAdd(per + segs + id, 1ull);
  }
}

// the result of a row in segment id, from per's accumulators
template <typename T, int OP>
__device__ __forceinline__ unsigned long long result(
    const unsigned long long* __restrict__ per, int segs, long long id) {
  if ((unsigned long long)id >= (unsigned long long)segs) return 0;
  const unsigned long long a = __ldg(per + id);
  if (OP == OP_MIN) return from_key<T>(~a);
  if (OP == OP_MAX) return from_key<T>(a);
  if (OP == OP_AVG) {
    const double c = (double)__ldg(per + segs + id);
    return dbits((is_double<T>::value ? __longlong_as_double((long long)a)
                                      : (double)(long long)a) / c);
  }
  if (OP == OP_COUNT && is_double<T>::value) return dbits((double)a);
  return a;
}

template <typename T, int OP>
__global__ void segagg_gather(const long long* __restrict__ ids,
                              const unsigned long long* __restrict__ per,
                              unsigned long long* __restrict__ out, int64_t n,
                              int segs, int vec16) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec16) {
    const longlong2* ids2 = reinterpret_cast<const longlong2*>(ids);
    ulonglong2* out2 = reinterpret_cast<ulonglong2*>(out);
    for (int64_t p = g; p < n / 2; p += stride) {
      const longlong2 id = __ldcs(ids2 + p);
      ulonglong2 r;
      r.x = result<T, OP>(per, segs, id.x);
      r.y = result<T, OP>(per, segs, id.y);
      __stcs(out2 + p, r);
    }
    if (g == 0 && (n & 1)) out[n - 1] = result<T, OP>(per, segs, ids[n - 1]);
  } else {
    for (int64_t i = g; i < n; i += stride) {
      __stcs(out + i, result<T, OP>(per, segs, __ldcs(ids + i)));
    }
  }
}

enum { R_GLOBAL = 0, R_PRIVATE = 1, R_ATOMIC = 2, R_ROUNDS = 3 };

struct Plan {
  int route;              // R_*
  int threads;            // of the reduce's blocks
  size_t smem;            // the reduce's dynamic shared memory
  int copies;             // sets of bins a block (R_ATOMIC)
  int grid;               // the reduce's blocks
  int64_t span;           // rows a block
  int combine_here;       // the last block folds the partials
  int64_t scratch_words;  // counter + partials
};

// Blocks of `kern` resident on the current device at once, with `smem`
// bytes of dynamic shared memory (the occupancy API; the answers are kept,
// since the host issues a call in microseconds). Lifts the kernel's
// dynamic shared memory limit to SMEM_MAX the first time it asks for more
// than the default 48 KB.
static cudaError_t resident_blocks(const void* kern, int threads,
                                   size_t smem, int* blocks) {
  struct Entry {
    const void* kern;
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static std::mutex lock;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  bool lifted = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.kern == kern && e.dev == dev) {
      lifted = lifted || e.smem > 48 * 1024;
      if (e.threads == threads && e.smem == smem) {
        *blocks = e.blocks;
        return cudaSuccess;
      }
    }
  }
  if (smem > 48 * 1024 && !lifted) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  cache[used < 64 ? used++ : 63] = Entry{kern, dev, threads, smem, *blocks};
  return cudaSuccess;
}

template <typename T, int OP>
static const void* reduce_kernel(int route) {
  if (route == R_PRIVATE) return (const void*)segagg_reduce_private<T, OP>;
  if constexpr (first_kind<T, OP>() != K_DADD) {
    return (const void*)segagg_reduce_atomic<T, OP>;
  } else {
    return (const void*)segagg_reduce_rounds<T, OP>;
  }
}

template <typename T, int OP>
static cudaError_t make_plan(int64_t n, int segs, Plan* p) {
  constexpr int BW = OP == OP_AVG ? 2 : 1;
  constexpr bool exact = first_kind<T, OP>() != K_DADD;
  *p = Plan{R_GLOBAL, 0, 0, 1, 0, 0, 0, 0};
  if (segs > CAP) return cudaSuccess;
  const int words = BW * segs;
  if (words <= PRIVATE_WORDS) {
    p->route = R_PRIVATE;
    int threads = PRIVATE_THREADS;
    while (threads > 64 && threads * words * 8 > PRIVATE_BYTES) threads /= 2;
    p->threads = threads;
    p->smem = (size_t)threads * words * 8;
  } else if (exact) {
    p->route = R_ATOMIC;
    p->threads = ATOMIC_BLOCK;
    int copies = ATOMIC_SMEM / (words * 8);
    copies = copies < ATOMIC_BLOCK / 32 ? copies : ATOMIC_BLOCK / 32;
    p->copies = copies > 1 ? copies : 1;
    // the bins, and at least a word a thread for the last block's chunks
    const int bin_words = p->copies * words;
    p->smem = (size_t)(bin_words > ATOMIC_BLOCK ? bin_words : ATOMIC_BLOCK)
              * 8;
  } else {
    p->route = R_ROUNDS;
    int warps = SMEM_MAX / (words * 8);
    warps = warps < MAX_WARPS ? warps : MAX_WARPS;
    p->threads = warps * 32;
    // the bins, and at least a word a thread for the last block's chunks
    p->smem = (size_t)warps * (words > 32 ? words : 32) * 8;
  }
  int resident = 0;
  const cudaError_t err = resident_blocks(reduce_kernel<T, OP>(p->route),
                                          p->threads, p->smem, &resident);
  if (err != cudaSuccess) return err;
  const int64_t rows_min = (int64_t)p->threads * MIN_ROWS_A_THREAD;
  int64_t g = (n + rows_min - 1) / rows_min;
  g = g < resident ? g : resident;
  g = g > 0 ? g : 1;
  p->span = ((n + g - 1) / g + 31) / 32 * 32;
  p->grid = (int)((n + p->span - 1) / p->span);
  p->combine_here = (int64_t)p->grid * words <= COMBINE_IN_BLOCK_MAX;
  p->scratch_words = 1 + (int64_t)p->grid * words;
  return cudaSuccess;
}

static int blocks_for(int64_t items, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t want = (items + threads * 4 - 1) / (threads * 4);
  const int64_t most = (int64_t)sms * 8;
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

// 0, a CUDA error code, or minus the scratch words the call needs when
// the wrapper passed fewer (nothing launched)
template <typename T, int OP>
static int launch(const void* vals, const void* ids, void* out, int64_t n,
                  int segs, void* per_, void* scratch_, int64_t scratch_words,
                  cudaStream_t s) {
  constexpr int BW = OP == OP_AVG ? 2 : 1;
  const long long* id = static_cast<const long long*>(ids);
  const unsigned long long* v = static_cast<const unsigned long long*>(vals);
  unsigned long long* per = static_cast<unsigned long long*>(per_);
  unsigned long long* scratch = static_cast<unsigned long long*>(scratch_);
  Plan p;
  cudaError_t err = make_plan<T, OP>(n, segs, &p);
  if (err != cudaSuccess) return err;
  if (p.route != R_GLOBAL) {
    if (scratch_words < p.scratch_words) return -(int)p.scratch_words;
    unsigned long long* partials = scratch + 1;
    if (p.route == R_PRIVATE) {
      segagg_reduce_private<T, OP><<<p.grid, p.threads, p.smem, s>>>(
          id, v, n, segs, p.span, partials, scratch, per, p.combine_here);
    } else if constexpr (first_kind<T, OP>() != K_DADD) {
      segagg_reduce_atomic<T, OP><<<p.grid, p.threads, p.smem, s>>>(
          id, v, n, segs, p.span, p.copies, partials, scratch, per,
          p.combine_here);
    } else {
      segagg_reduce_rounds<T, OP><<<p.grid, p.threads, p.smem, s>>>(
          id, v, n, segs, p.span, partials, scratch, per, p.combine_here);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!p.combine_here) {
      const int words = BW * segs;
      segagg_combine<T, OP><<<(words + 7) / 8, 256, 0, s>>>(
          partials, p.grid, words, segs, per);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  } else {
    err = cudaMemsetAsync(per, 0, (size_t)BW * segs * 8, s);
    if (err != cudaSuccess) return err;
    segagg_atomic<T, OP><<<blocks_for(n, ATOMIC_THREADS), ATOMIC_THREADS, 0,
                           s>>>(id, v, n, segs, per);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int vec16 = (uintptr_t)ids % 16 == 0 && (uintptr_t)out % 16 == 0;
  segagg_gather<T, OP><<<blocks_for(vec16 ? n / 2 + 1 : n, GATHER_THREADS),
                         GATHER_THREADS, 0, s>>>(
      id, per, static_cast<unsigned long long*>(out), n, segs, vec16);
  return cudaGetLastError();
}

static bool bad_args(int64_t n, int segs, int dtype, int op) {
  return n < 0 || segs < 1 || dtype < 0 || dtype > 1 || op < 0 || op > 4;
}

extern "C" {

// The largest segment count the shared-memory route takes.
int pinot_segagg_cap(void) { return CAP; }

// vals: n 8-byte values (dtype 0: int64, 1: float64; not read for count);
// ids: n int64 segment ids in [0, segs); out: n 8-byte results (float64
// for avg, else vals' type); op 0: sum, 1: count, 2: avg, 3: min, 4: max;
// per: (2 for avg, else 1) * segs 64-bit words; scratch: scratch_words
// 64-bit words, its first word zero when the call starts (the reduce
// leaves it so). Returns 0, a CUDA error code, or minus the scratch words
// the call needs when scratch_words is short (nothing is launched then).
int pinot_segagg(const void* vals, const void* ids, void* out, int64_t n,
                 int segs, int dtype, int op, void* per, void* scratch,
                 int64_t scratch_words, void* stream) {
  if (bad_args(n, segs, dtype, op)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype * 5 + op) {
    case 0: err = launch<long long, OP_SUM>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 1: err = launch<long long, OP_COUNT>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 2: err = launch<long long, OP_AVG>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 3: err = launch<long long, OP_MIN>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 4: err = launch<long long, OP_MAX>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 5: err = launch<double, OP_SUM>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 6: err = launch<double, OP_COUNT>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 7: err = launch<double, OP_AVG>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    case 8: err = launch<double, OP_MIN>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
    default: err = launch<double, OP_MAX>(vals, ids, out, n, segs, per, scratch, scratch_words, s); break;
  }
  return err;
}

}  // extern "C"

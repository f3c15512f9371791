// Segmented inclusive scan (sum, min or max over int64 or float64) for
// Hopper (sm_90a), in one streaming pass with decoupled look-back.
//
// Replaces the traced scan of the window stage,
// pinot_tpu/multistage/window.py:154 (_seg_scan_jit: a
// jax.lax.associative_scan). The element is (reset flag, value) and
//   combine((fa, va), (fb, vb)) = (fa | fb, fb ? vb : op(va, vb)),
// so a set flag starts a new partition: out[i] = op over the values from
// the last set flag at or before i through i. min and max keep the older
// value on ties (b < a ? b : a), so the result is the same bits in any
// association order; the additive identity is -0.0, so a lone -0.0 stays
// -0.0. Sums of float64 are taken in another order than the plain
// version's (ops/segscan.py), so they agree to rounding only.
//
// What bounds it: bytes. A call reads each value (8 B) and flag (1 B)
// once and writes each result (8 B) once; there are n - 1 combines, far
// under the card's rate. So the design reads and writes every element
// once with coalesced accesses and keeps the cross-tile carry off the
// critical path:
//
//   * One block of THREADS threads per tile of TILE = THREADS * ITEMS rows,
//     taken by an atomic ticket (not blockIdx), so a tile only ever waits
//     on tiles whose blocks have already started.
//   * Values are loaded striped (thread t: rows t, t + THREADS, ...; a
//     warp's load is 256 contiguous bytes) into shared memory padded by
//     one element per ITEMS rows, then each thread scans its ITEMS
//     consecutive rows from there (the padding keeps those 8-byte reads
//     free of bank conflicts). Flags are loaded as 32-bit words.
//   * A warp scan (shuffles) and a pass over the WARPS warp totals give
//     each thread its exclusive prefix in the tile and the tile's
//     aggregate.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", NVIDIA 2016), after compact.cu's:
//     each tile publishes its aggregate (ST_AGG, with ST_RESET when the
//     tile holds a set flag) and later its inclusive prefix (ST_PREFIX).
//     A status is one 64-bit word; the 8-byte aggregate and prefix values
//     live beside it and are stored before the status with release
//     ordering and loaded after it with acquire ordering (the value and
//     its flag do not fit one word, as compact.cu's count does). Warp 0
//     reads 32 predecessors at a time, nearest first, and combines them
//     down to the nearest one that ends the look-back: a prefix, or an
//     aggregate holding a reset, since nothing before a reset reaches
//     this tile. Many partitions therefore cut the look-back short.
//   * Results go back through the same shared buffer and are stored
//     striped.
//
// A call is two device operations: one cudaMemsetAsync of the ticket and
// the status words, and segscan_pass.
//
// Plain C interface, bound from Python with ctypes
// (pinot_tpu_torch/ops/segscan.py). Nothing is allocated here: the wrapper
// passes the output and the scratch. Every launch is checked and the
// first CUDA error code is returned (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 16
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)
// scratch, in 64-bit words: [0] ticket, [1, 1 + nb) status words,
// [1 + nb, 1 + 2 nb) aggregate values, [1 + 2 nb, 1 + 3 nb) prefix values
#define HEADER_WORDS 1
#define ST_AGG 1ull
#define ST_PREFIX 2ull
#define ST_RESET 4ull
#define FULL 0xffffffffu
// Every predecessor's block is running, so a wait in the look-back ends
// unless the kernel is broken: after SPIN_LIMIT rounds it traps rather
// than hang the card.
#define SPIN_LIMIT (1 << 26)

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

static_assert(ITEMS == 16, "a thread reads its flags as one 16-byte word");

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long to_bits(long long v) {
  return (unsigned long long)v;
}
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ long long from_bits<long long>(
    unsigned long long b) {
  return (long long)b;
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

template <typename T, int OP>
__device__ __forceinline__ T identity();
template <>
__device__ __forceinline__ long long identity<long long, OP_SUM>() {
  return 0;
}
template <>
__device__ __forceinline__ long long identity<long long, OP_MIN>() {
  return (long long)0x7fffffffffffffffLL;
}
template <>
__device__ __forceinline__ long long identity<long long, OP_MAX>() {
  return (long long)(-0x7fffffffffffffffLL - 1);
}
template <>
__device__ __forceinline__ double identity<double, OP_SUM>() {
  return -0.0;
}
template <>
__device__ __forceinline__ double identity<double, OP_MIN>() {
  return __longlong_as_double(0x7ff0000000000000LL);   // +inf
}
template <>
__device__ __forceinline__ double identity<double, OP_MAX>() {
  return __longlong_as_double((long long)0xfff0000000000000ULL);  // -inf
}

// op(older, newer); min and max keep the older value on ties
template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// (fa, va) := combine((fa, va), (fb, vb)), (fa, va) the older
template <typename T, int OP>
__device__ __forceinline__ void combine(bool& fa, T& va, bool fb, T vb) {
  va = fb ? vb : apply<T, OP>(va, vb);
  fa = fa || fb;
}

// The exclusive prefix of `tile` from its predecessors' statuses (warp 0,
// every lane returns it).
template <typename T, int OP>
__device__ void look_back(const unsigned long long* status,
                          const unsigned long long* agg,
                          const unsigned long long* pre, int64_t tile,
                          bool& xf, T& xv) {
  const int lane = threadIdx.x & 31;
  xf = false;
  xv = identity<T, OP>();
  int64_t end = tile - 1;
  for (int round = 0;; ++round) {
    if (round == SPIN_LIMIT) __trap();
    const int64_t i = end - lane;
    const unsigned long long s = i >= 0 ? ld_acquire(status + i) : ST_PREFIX;
    const bool ready = (s & (ST_AGG | ST_PREFIX)) != 0;
    const bool stop = (s & (ST_PREFIX | ST_RESET)) != 0;
    const unsigned stops = __ballot_sync(FULL, ready && stop);
    // lanes up to and including the nearest one that ends the look-back
    const unsigned need = stops ? ((stops & (0u - stops)) << 1) - 1u : FULL;
    if (__ballot_sync(FULL, !ready) & need) {
      __nanosleep(64);
      continue;
    }
    bool lf = false;
    T lv = identity<T, OP>();
    if ((need >> lane) & 1u) {
      if (i < 0) {
        lf = true;
      } else if (s & ST_PREFIX) {
        lf = true;  // nothing older matters
        lv = from_bits<T>(ld_relaxed(pre + i));
      } else {
        lf = (s & ST_RESET) != 0;
        lv = from_bits<T>(ld_relaxed(agg + i));
      }
    }
    // lane l := combine(lanes l+1.., lane l): higher lanes are older
    for (int d = 1; d < 32; d <<= 1) {
      const T ov = __shfl_down_sync(FULL, lv, d);
      const int of = __shfl_down_sync(FULL, (int)lf, d);
      if (lane + d < 32) {
        lv = lf ? lv : apply<T, OP>(ov, lv);
        lf = lf || of;
      }
    }
    const T wv = __shfl_sync(FULL, lv, 0);
    const int wf = __shfl_sync(FULL, (int)lf, 0);
    // the window is older than what was gathered so far
    xv = xf ? xv : apply<T, OP>(wv, xv);
    xf = xf || wf;
    if (stops) return;
    end -= 32;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
segscan_pass(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
             T* __restrict__ out, int64_t n, int64_t nb,
             unsigned long long* __restrict__ scratch) {
  __shared__ T sv[TILE + TILE / ITEMS];  // row r at r + r / ITEMS
  __shared__ __align__(16) uint8_t sf[TILE];
  __shared__ T warp_v[WARPS];
  __shared__ int warp_f[WARPS];
  __shared__ T s_prev_v;
  __shared__ int s_prev_f;
  __shared__ unsigned s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* status = scratch + HEADER_WORDS;
  unsigned long long* agg = status + nb;
  unsigned long long* pre = agg + nb;

  if (t == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * TILE;
  const int rows = (int)(n - base < TILE ? n - base : TILE);

  // 1. striped loads into shared memory; rows past n read as a reset
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int r = k * THREADS + t;
    sv[r + r / ITEMS] = r < rows ? __ldcs(vals + base + r) : T(0);
  }
  const uint8_t* fl = flags + base;
  if (rows == TILE && ((uintptr_t)fl & 3) == 0) {
#pragma unroll
    for (int k = 0; k < TILE / 4 / THREADS; ++k) {
      const int w = k * THREADS + t;
      reinterpret_cast<uint32_t*>(sf)[w] =
          __ldcs(reinterpret_cast<const unsigned*>(fl) + w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = k * THREADS + t;
      sf[r] = r < rows ? fl[r] : 1;
    }
  }
  __syncthreads();

  // 2. each thread scans its ITEMS consecutive rows
  const uint4 fw = reinterpret_cast<const uint4*>(sf)[t];
  const uint32_t fwords[4] = {fw.x, fw.y, fw.z, fw.w};
  T x[ITEMS];
  bool f = false;
  T v = identity<T, OP>();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    x[k] = sv[t * (ITEMS + 1) + k];
    const bool fk = ((fwords[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0;
    combine<T, OP>(f, v, fk, x[k]);
  }

  // 3. block scan of the threads' aggregates
  bool wf = f;
  T wv = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(FULL, wv, d);
    const int of = __shfl_up_sync(FULL, (int)wf, d);
    if (lane >= d) {
      wv = wf ? wv : apply<T, OP>(ov, wv);
      wf = wf || of;
    }
  }
  T ev = __shfl_up_sync(FULL, wv, 1);
  int ef = __shfl_up_sync(FULL, (int)wf, 1);
  if (lane == 0) {
    ev = identity<T, OP>();
    ef = 0;
  }
  if (lane == 31) {
    warp_v[warp] = wv;
    warp_f[warp] = wf;
  }
  __syncthreads();
  bool pf = false;
  T pv = identity<T, OP>();
  bool tf = false;
  T tv = identity<T, OP>();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) combine<T, OP>(pf, pv, warp_f[w] != 0, warp_v[w]);
    combine<T, OP>(tf, tv, warp_f[w] != 0, warp_v[w]);
  }
  combine<T, OP>(pf, pv, ef != 0, ev);  // this thread's exclusive prefix

  // 4. publish the aggregate, look back, publish the inclusive prefix
  if (warp == 0) {
    bool xf = false;
    T xv = identity<T, OP>();
    if (tile == 0) {
      if (t == 0) {
        st_relaxed(pre, to_bits(tv));
        st_release(status, ST_PREFIX);
      }
    } else {
      if (t == 0) {
        st_relaxed(agg + tile, to_bits(tv));
        st_release(status + tile, ST_AGG | (tf ? ST_RESET : 0ull));
      }
      look_back<T, OP>(status, agg, pre, tile, xf, xv);
      if (t == 0) {
        bool inf = xf;
        T inv = xv;
        combine<T, OP>(inf, inv, tf, tv);
        st_relaxed(pre + tile, to_bits(inv));
        st_release(status + tile, ST_PREFIX);
      }
    }
    if (t == 0) {
      s_prev_v = xv;
      s_prev_f = xf;
    }
  }
  __syncthreads();

  // 5. the rows' results, back through shared memory, stored striped
  bool rf = s_prev_f != 0;
  T rv = s_prev_v;
  combine<T, OP>(rf, rv, pf, pv);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool fk = ((fwords[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0;
    combine<T, OP>(rf, rv, fk, x[k]);
    sv[t * (ITEMS + 1) + k] = rv;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int r = k * THREADS + t;
    if (r < rows) __stcs(out + base + r, sv[r + r / ITEMS]);
  }
}

template <typename T, int OP>
static cudaError_t launch(const void* vals, const void* flags, void* out,
                          int64_t n, int64_t nb, unsigned long long* words,
                          cudaStream_t s) {
  segscan_pass<T, OP><<<(unsigned)nb, THREADS, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(flags),
      static_cast<T*>(out), n, nb, words);
  return cudaGetLastError();
}

extern "C" {

// Rows per tile: the wrapper sizes the scratch as
// HEADER_WORDS + 3 * ceil(n / tile) 64-bit words.
int pinot_segscan_tile(void) { return TILE; }

int pinot_segscan_header_words(void) { return HEADER_WORDS; }

// vals, out: n 8-byte elements (dtype 0: int64, 1: float64), 8-byte
// aligned; flags: n bytes (non-zero: the row starts a partition);
// op 0: sum, 1: min, 2: max.
int pinot_segscan(const void* vals, const void* flags, void* out, int64_t n,
                  int dtype, int op, void* scratch, int64_t scratch_words,
                  void* stream) {
  const int64_t nb = (n + TILE - 1) / TILE;
  if (n < 0 || nb > 0xffffffffLL || dtype < 0 || dtype > 1 || op < 0 ||
      op > 2 || scratch_words < HEADER_WORDS + 3 * nb) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err =
      cudaMemsetAsync(words, 0, (size_t)(HEADER_WORDS + nb) * 8, s);
  if (err != cudaSuccess) return (int)err;
  switch (dtype * 3 + op) {
    case 0: err = launch<long long, OP_SUM>(vals, flags, out, n, nb, words, s); break;
    case 1: err = launch<long long, OP_MIN>(vals, flags, out, n, nb, words, s); break;
    case 2: err = launch<long long, OP_MAX>(vals, flags, out, n, nb, words, s); break;
    case 3: err = launch<double, OP_SUM>(vals, flags, out, n, nb, words, s); break;
    case 4: err = launch<double, OP_MIN>(vals, flags, out, n, nb, words, s); break;
    default: err = launch<double, OP_MAX>(vals, flags, out, n, nb, words, s); break;
  }
  return (int)err;
}

}  // extern "C"

// Segmented inclusive scan (sum, min or max over int64 or float64) for
// Hopper (sm_90a): one launch a call, a persistent grid, decoupled
// look-back with the next tile's loads in flight.
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
// under the card's rate. The design keeps HBM busy from the first load to
// the last store:
//
//   * One device operation a call. The scratch (ticket counter, one status
//     word, aggregate and prefix a tile) is zeroed once, when the wrapper
//     allocates it for a (device, stream), and reused by every later call
//     on that stream (calls on one stream run in order). Each call passes
//     a 32-bit epoch (never 0) that the wrapper bumps under a lock; a
//     status word carries it in its high half, so a word left by an
//     earlier call reads as "not ready". The block that draws the call's
//     last ticket (every block draws exactly one past the tiles) sets the
//     counter back to 0: nobody draws after it, and the next call on the
//     stream starts after this one ends. The status, aggregate and
//     prefix arrays sit at offsets fixed by the scratch's capacity, so a
//     status word only ever holds a status.
//   * A persistent grid: as many blocks as are resident (the occupancy
//     API, at most MAX_BLOCKS_PER_SM an SM: 5 fit at 256 threads and 41 KB
//     of shared memory), each taking tiles of TILE = THREADS * ITEMS rows
//     by atomic ticket. Thread 0 starts drawing the next ticket as a tile
//     starts and the block reads it once the tile's aggregate is out, so
//     the draw's latency hides under the scan. Tickets keep the
//     look-back's guarantee: a tile waits only on older tickets, and the
//     oldest unfinished tile's block is running it. While one block waits
//     in its look-back, the SM's other blocks keep their loads in flight.
//   * One shared-memory stage a block, filled by cp.async. Values go in
//     16-byte copies when vals and out are 16-byte aligned (8-byte copies
//     otherwise: a slice like vals[1:]), flags in 16-byte copies when
//     they are 16-byte aligned (byte loads otherwise, and for the last
//     tile). Row r of the stage sits at r + 2 (r / ITEMS): every copy
//     stays 16-byte aligned and a thread's 16-byte reads of its ITEMS
//     consecutive rows are free of bank conflicts. Results go back into
//     the stage and out as striped 16-byte (or 8-byte) streaming stores,
//     and the next tile's copies start once they are issued. Two stages
//     a block (the next tile's loads in flight during the look-back), and
//     tickets drawn a tile ahead (those loads in flight during the scan
//     too), measured slower on the H100 at the window path's 4.2M rows:
//     two stages halve the blocks an SM holds, and a tile drawn early
//     holds its successors' look-backs longer (PERF.md, PR 9).
//   * A thread scans its ITEMS rows, a warp scan (shuffles) and a pass
//     over the warp totals give its exclusive prefix in the tile and the
//     tile's aggregate, which thread 0 publishes (ST_AGG, with ST_RESET
//     when the tile holds a set flag) before the look-back.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel
//     Prefix Scan with Decoupled Look-back", NVIDIA 2016): warp 0 reads 32
//     predecessors' status words at a time, nearest first, until one ends
//     the look-back (a prefix, or an aggregate holding a reset). The
//     value and its status do not fit one word: the value is stored
//     before the status with release ordering and loaded after it with
//     acquire ordering.
//
// Why a float64 sum is the same bits on every launch: the look-back folds
// what it read strictly oldest first (one lane, from the stop through the
// nearest tile), so a tile's exclusive prefix is the left fold of the
// aggregates since the last reset however far back the stop was (a
// published prefix is itself that left fold), and everything inside a
// tile is in a fixed order. Windows are kept in shared memory
// (LOOKBACK_WINDOWS of 32); past them the warp re-reads the oldest window
// until a stop shows. The route (16- or 8-byte copies) changes where data
// comes from, not the arithmetic, so both give the same bits.
//
// Plain C interface, bound from Python with ctypes
// (pinot_tpu_torch/ops/segscan.py). Nothing is allocated here: the wrapper
// passes the output and the scratch. Every launch is checked and the
// first CUDA error code is returned (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 16
#define MAX_BLOCKS_PER_SM 8
#define LOOKBACK_WINDOWS 8
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)
// the stage: TILE values (8 B) padded by 2 every ITEMS rows, then TILE flags
#define STAGE_WORDS (TILE + 2 * (TILE / ITEMS))
#define SMEM_BYTES (STAGE_WORDS * 8 + TILE)
// scratch, in 64-bit words: [0] ticket counter, then for a capacity of
// cap tiles: [1, 1 + cap) status words, [1 + cap, 1 + 2 cap) aggregate
// values, [1 + 2 cap, 1 + 3 cap) prefix values
#define HEADER_WORDS 1
#define ST_AGG 1ull
#define ST_PREFIX 2ull
#define ST_RESET 4ull
#define EPOCH_MASK 0xffffffff00000000ull
#define FULL 0xffffffffu
#define MAX_DEVICES 16
// Every predecessor's block is running, so a wait in the look-back ends
// unless the kernel is broken: after SPIN_LIMIT rounds it traps rather
// than hang the card.
#define SPIN_LIMIT (1 << 26)

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

static_assert(ITEMS % 8 == 0, "a thread reads its flags in 8-byte words");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");

__device__ __forceinline__ int pad_row(int r) { return r + 2 * (r / ITEMS); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_cs16(void* p, unsigned long long a,
                                        unsigned long long b) {
  asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(a), "l"(b) : "memory");
}

__device__ __forceinline__ void st_cs8(void* p, unsigned long long a) {
  asm volatile("st.global.cs.u64 [%0], %1;" :: "l"(p), "l"(a) : "memory");
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

template <typename T>
struct is_double { static constexpr bool value = false; };
template <>
struct is_double<double> { static constexpr bool value = true; };

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

struct Stage {
  unsigned long long* v;  // STAGE_WORDS value bits, padded
  uint8_t* f;             // TILE flags
};

__device__ __forceinline__ Stage stage_at(unsigned char* smem) {
  return {reinterpret_cast<unsigned long long*>(smem), smem + STAGE_WORDS * 8};
}

// A thread's ITEMS flags as ITEMS / 4 words (16-byte reads when ITEMS is
// a multiple of 16, else 8-byte ones).
__device__ __forceinline__ void load_flag_words(const uint8_t* p,
                                                uint32_t* fw) {
  if (ITEMS % 16 == 0) {
#pragma unroll
    for (int k = 0; k < ITEMS / 16; ++k) {
      const uint4 w4 = reinterpret_cast<const uint4*>(p)[k];
      fw[4 * k] = w4.x;
      fw[4 * k + 1] = w4.y;
      fw[4 * k + 2] = w4.z;
      fw[4 * k + 3] = w4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS / 8; ++k) {
      const uint2 w2 = reinterpret_cast<const uint2*>(p)[k];
      fw[2 * k] = w2.x;
      fw[2 * k + 1] = w2.y;
    }
  }
}

__device__ __forceinline__ bool flag_at(const uint32_t* fw, int k) {
  return ((fw[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0;
}

// Start the copies of tile `tile` into stage st (cp.async; the byte loads
// of flags off a 16-byte boundary and of the last tile are plain). Rows
// past n read as value 0 with a reset.
__device__ __forceinline__ void issue_loads(
    const unsigned long long* __restrict__ vals,
    const uint8_t* __restrict__ flags, int64_t n, int64_t tile, Stage st,
    bool vec16, bool flags16) {
  const int t = threadIdx.x;
  const int64_t base = tile * TILE;
  const int rows = (int)(n - base < TILE ? n - base : TILE);
  const unsigned long long* src = vals + base;
  if (vec16) {
#pragma unroll 4
    for (int c = t; c < TILE / 2; c += THREADS) {
      const int r = 2 * c;
      unsigned long long* dst = st.v + pad_row(r);
      if (r + 1 < rows) {
        cp_async16(dst, src + r);
      } else if (r < rows) {
        cp_async8(dst, src + r);
        dst[1] = 0;
      } else {
        dst[0] = dst[1] = 0;
      }
    }
  } else {
#pragma unroll 4
    for (int r = t; r < TILE; r += THREADS) {
      unsigned long long* dst = st.v + pad_row(r);
      if (r < rows) {
        cp_async8(dst, src + r);
      } else {
        *dst = 0;
      }
    }
  }
  const uint8_t* fl = flags + base;
  if (rows == TILE && flags16) {
    for (int c = t; c < TILE / 16; c += THREADS) {
      cp_async16(st.f + 16 * c, fl + 16 * c);
    }
  } else {
#pragma unroll 4
    for (int r = t; r < TILE; r += THREADS) {
      st.f[r] = r < rows ? fl[r] : 1;
    }
  }
}

// The exclusive prefix of `tile` from its predecessors' statuses (warp 0;
// every lane returns it). Reads 32 predecessors at a time, nearest first,
// until the nearest one that ends the look-back. Integer sums, min and max
// are exact in any association: each window is combined by a shuffle tree
// and the windows newest first. A float64 sum keeps what it read in
// (win_v, win_f) and folds it oldest first, from the stop to the nearest
// tile, on one lane.
template <typename T, int OP>
__device__ void look_back(const unsigned long long* status,
                          const unsigned long long* agg,
                          const unsigned long long* pre, int64_t tile,
                          unsigned long long tag, T* win_v, bool* win_f,
                          bool& xf, T& xv) {
  constexpr bool ordered =
      OP == OP_SUM && is_double<T>::value;
  const int lane = threadIdx.x & 31;
  int64_t end = tile - 1;
  int w = 0;
  xf = false;
  xv = identity<T, OP>();
  for (int round = 0;; ++round) {
    if (round == SPIN_LIMIT) __trap();
    const int64_t i = end - lane;
    const unsigned long long s =
        i >= 0 ? ld_acquire(status + i) : (tag | ST_PREFIX);
    const bool ready =
        (s & EPOCH_MASK) == tag && (s & (ST_AGG | ST_PREFIX)) != 0;
    const bool stop = ready && (s & (ST_PREFIX | ST_RESET)) != 0;
    const unsigned stops = __ballot_sync(FULL, stop);
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
    if (!ordered) {
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
      continue;
    }
    win_v[w * 32 + lane] = lv;
    win_f[w * 32 + lane] = lf;
    if (stops) {
      __syncwarp();
      bool af = false;
      T av = identity<T, OP>();
      if (lane == 0) {
        // oldest first: window w from the stop down to lane 0 (its
        // nearest tile), then the newer windows
        for (int k = w * 32 + __ffs(stops) - 1; k >= 0; --k) {
          combine<T, OP>(af, av, win_f[k], win_v[k]);
        }
      }
      xv = __shfl_sync(FULL, av, 0);
      xf = __shfl_sync(FULL, (int)af, 0) != 0;
      return;
    }
    if (w + 1 < LOOKBACK_WINDOWS) {
      ++w;
      end -= 32;
    }
    // else: read the oldest window again until a stop shows in it
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
segscan_pass(const unsigned long long* __restrict__ vals,
             const uint8_t* __restrict__ flags,
             unsigned long long* __restrict__ out, int64_t n, int64_t nb,
             int64_t cap, unsigned long long* __restrict__ scratch,
             unsigned epoch, int vec16, int flags16) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T warp_v[WARPS];
  __shared__ int warp_f[WARPS];
  __shared__ T s_prev_v;
  __shared__ int s_prev_f;
  __shared__ unsigned long long s_ticket;
  __shared__ T win_v[LOOKBACK_WINDOWS * 32];
  __shared__ bool win_f[LOOKBACK_WINDOWS * 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* counter = scratch;
  unsigned long long* status = scratch + HEADER_WORDS;
  unsigned long long* agg = status + cap;
  unsigned long long* pre = agg + cap;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  const unsigned long long last_ticket = (unsigned long long)nb +
                                         gridDim.x - 1;

  if (t == 0) s_ticket = atomicAdd(counter, 1ull);
  __syncthreads();
  unsigned long long tile = s_ticket;
  if (tile >= (unsigned long long)nb) {
    if (t == 0 && tile == last_ticket) *counter = 0;
    return;
  }
  const Stage st = stage_at(smem);
  issue_loads(vals, flags, n, (int64_t)tile, st, vec16, flags16);
  cp_async_commit();

  for (;;) {
    cp_async_wait<0>();
    __syncthreads();
    // the next ticket, drawn now and read once the aggregate is out
    unsigned long long nt = 0;
    if (t == 0) nt = atomicAdd(counter, 1ull);

    const int64_t base = (int64_t)tile * TILE;
    const int rows = (int)(n - base < TILE ? n - base : TILE);

    // 1. each thread's ITEMS consecutive rows: its aggregate
    uint32_t fw[ITEMS / 4];
    load_flag_words(st.f + t * ITEMS, fw);
    unsigned long long* mine = st.v + t * (ITEMS + 2);
    bool f = false;
    T v = identity<T, OP>();
#pragma unroll
    for (int k = 0; k < ITEMS; k += 2) {
      const ulonglong2 p = reinterpret_cast<const ulonglong2*>(mine)[k / 2];
      combine<T, OP>(f, v, flag_at(fw, k), from_bits<T>(p.x));
      combine<T, OP>(f, v, flag_at(fw, k + 1), from_bits<T>(p.y));
    }

    // 2. block scan of the threads' aggregates
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

    // 3. publish the aggregate (tile 0: its prefix)
    if (t == 0) {
      if (tile == 0) {
        st_relaxed(pre, to_bits(tv));
        st_release(status, tag | ST_PREFIX);
      } else {
        st_relaxed(agg + tile, to_bits(tv));
        st_release(status + tile, tag | ST_AGG | (tf ? ST_RESET : 0ull));
      }
    }
    if (t == 0) s_ticket = nt;
    __syncthreads();
    const unsigned long long next = s_ticket;
    const bool has_next = next < (unsigned long long)nb;

    // 4. look back, publish the inclusive prefix
    if (warp == 0) {
      bool xf = false;
      T xv = identity<T, OP>();
      if (tile != 0) {
        look_back<T, OP>(status, agg, pre, (int64_t)tile, tag, win_v, win_f,
                         xf, xv);
        if (t == 0) {
          bool inf = xf;
          T inv = xv;
          combine<T, OP>(inf, inv, tf, tv);
          st_relaxed(pre + tile, to_bits(inv));
          st_release(status + tile, tag | ST_PREFIX);
        }
      }
      if (t == 0) {
        s_prev_v = xv;
        s_prev_f = xf;
      }
    }
    __syncthreads();

    // 5. the rows' results, back into the stage
    bool rf = s_prev_f != 0;
    T rv = s_prev_v;
    combine<T, OP>(rf, rv, pf, pv);
#pragma unroll
    for (int k = 0; k < ITEMS; k += 2) {
      ulonglong2 p = reinterpret_cast<const ulonglong2*>(mine)[k / 2];
      combine<T, OP>(rf, rv, flag_at(fw, k), from_bits<T>(p.x));
      p.x = to_bits(rv);
      combine<T, OP>(rf, rv, flag_at(fw, k + 1), from_bits<T>(p.y));
      p.y = to_bits(rv);
      reinterpret_cast<ulonglong2*>(mine)[k / 2] = p;
    }
    __syncthreads();

    // 6. striped streaming stores
    unsigned long long* dst = out + base;
    if (vec16) {
#pragma unroll 4
      for (int c = t; c < TILE / 2; c += THREADS) {
        const int r = 2 * c;
        const unsigned long long* src = st.v + pad_row(r);
        if (r + 1 < rows) {
          st_cs16(dst + r, src[0], src[1]);
        } else if (r < rows) {
          st_cs8(dst + r, src[0]);
        }
      }
    } else {
#pragma unroll 4
      for (int r = t; r < rows; r += THREADS) {
        st_cs8(dst + r, st.v[pad_row(r)]);
      }
    }
    if (!has_next) {
      if (t == 0 && next == last_ticket) *counter = 0;
      return;
    }
    __syncthreads();  // the stage is free: load the next tile into it
    issue_loads(vals, flags, n, (int64_t)next, st, vec16, flags16);
    cp_async_commit();
    tile = next;
  }
}

// Blocks of one instance resident on a device at once (the persistent
// grid), found once per device; also lifts the instance's dynamic shared
// memory limit above the default 48 KB.
template <typename T, int OP>
static int resident_blocks(cudaError_t* err) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  *err = cudaFuncSetAttribute(segscan_pass<T, OP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segscan_pass<T, OP>, THREADS, SMEM_BYTES);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const int blocks =
      (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM) * sms;
  if (dev < MAX_DEVICES) cached[dev] = blocks;
  return blocks;
}

template <typename T, int OP>
static cudaError_t launch(const void* vals, const void* flags, void* out,
                          int64_t n, int64_t nb, int64_t cap,
                          unsigned long long* words, unsigned epoch,
                          cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks<T, OP>(&err);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      (unsigned)(nb < resident ? nb : resident);
  const int vec16 = ((uintptr_t)vals % 16 == 0 && (uintptr_t)out % 16 == 0);
  const int flags16 = (uintptr_t)flags % 16 == 0;
  segscan_pass<T, OP><<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const unsigned long long*>(vals),
      static_cast<const uint8_t*>(flags),
      static_cast<unsigned long long*>(out), n, nb, cap, words, epoch, vec16,
      flags16);
  return cudaGetLastError();
}

extern "C" {

// Rows per tile: the wrapper sizes the scratch for a capacity of cap >=
// ceil(n / tile) tiles as HEADER_WORDS + 3 * cap 64-bit words.
int pinot_segscan_tile(void) { return TILE; }

int pinot_segscan_header_words(void) { return HEADER_WORDS; }

// vals, out: n 8-byte elements (dtype 0: int64, 1: float64), 8-byte
// aligned; flags: n bytes (non-zero: the row starts a partition);
// op 0: sum, 1: min, 2: max. scratch: scratch_words 64-bit words, zeroed
// when allocated and used only by calls on this stream since; epoch: this
// call's, never 0 and never one an earlier call on this scratch used.
int pinot_segscan(const void* vals, const void* flags, void* out, int64_t n,
                  int dtype, int op, void* scratch, int64_t scratch_words,
                  unsigned epoch, void* stream) {
  const int64_t nb = (n + TILE - 1) / TILE;
  const int64_t cap = (scratch_words - HEADER_WORDS) / 3;
  if (n < 0 || nb > 0xffffffffLL || dtype < 0 || dtype > 1 || op < 0 ||
      op > 2 || nb > cap || epoch == 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err;
  switch (dtype * 3 + op) {
    case 0: err = launch<long long, OP_SUM>(vals, flags, out, n, nb, cap, words, epoch, s); break;
    case 1: err = launch<long long, OP_MIN>(vals, flags, out, n, nb, cap, words, epoch, s); break;
    case 2: err = launch<long long, OP_MAX>(vals, flags, out, n, nb, cap, words, epoch, s); break;
    case 3: err = launch<double, OP_SUM>(vals, flags, out, n, nb, cap, words, epoch, s); break;
    case 4: err = launch<double, OP_MIN>(vals, flags, out, n, nb, cap, words, epoch, s); break;
    default: err = launch<double, OP_MAX>(vals, flags, out, n, nb, cap, words, epoch, s); break;
  }
  return (int)err;
}

}  // extern "C"

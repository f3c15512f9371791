// Hash-bucket partition of the mesh exchanges, for sm_90a: one pass with
// decoupled look-back over every partition at once, and a tail fill.
//
// Replaces the per-device step that pinot_tpu/ops/join.py
// _shuffle_exchange_jit (:92-115) and pinot_tpu/multistage/fused.py
// _fused_program._exchange (:333-347) trace for XLA: each row's int32 key
// code is hashed with _splitmix32 to a partition in [0, n_dev) (a code
// below 0 goes nowhere), each row takes its STABLE rank within its
// partition (input order, as jnp.argsort's stable sort gives it), and the
// code and every payload column (int32 or int64) of a row whose rank is
// below cap land in slot [partition][rank] of (n_dev, cap) buckets.
// Unwritten slots hold -1; overflow is set when a live partition holds
// more than cap rows.
//
// What bounds it: bytes. Each code and payload is read once and each
// bucket slot written once (ops/hashpart.partition_bytes) over 3.35 TB/s;
// the work per row is a hash and a few integer operations. The design
// touches each byte once and writes whole runs:
//
//   * hp_pass, one block a tile of TILE = THREADS * ITEMS rows. A block
//     draws its tile by an atomic ticket, not by blockIdx, so a tile only
//     waits on tiles whose blocks have already started: forward progress
//     does not depend on the order in which blocks are scheduled. The
//     block that draws the last ticket sets the counter back to 0.
//   * Each warp owns a contiguous run of WARP_ROWS rows and reads its
//     codes 32 at a time, ITEMS loads in flight a thread. Each code is
//     hashed once; __match_any_sync groups a round's lanes by partition,
//     so a row's rank within its warp's run is the warp's count of the
//     partition so far plus the lanes of its partition below it, and the
//     round's first lane of a partition adds the group's size. The
//     partition and rank stay in a register; the codes stay in shared
//     memory for the scatter. Warp 0 then turns the warps' counts into
//     each warp's first rank in the tile and the tile's count per
//     partition, and scans those into each partition's first position in
//     the tile's partition-major order.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", NVIDIA 2016) over n_dev sums at once.
//     The status words are laid out [tile][partition], one 64-bit word
//     each: the call's epoch in the high half (a word of an earlier call
//     reads as not ready), bit 31 set for an inclusive prefix (clear: the
//     tile's own count), the value in bits 0-30 (rows of one partition,
//     at most n < 2^31). Nothing else is read on the strength of a
//     status, so relaxed gpu-scope loads and stores suffice. A tile
//     publishes its counts, stages its rows (time in which its
//     predecessors publish theirs), then the block reads THREADS words a
//     round, nearest first, so a round covers THREADS / n_dev
//     predecessors of every partition; per partition the nearest ready
//     prefix in the round stops it (a shared atomicMax), the words nearer
//     than the stop are summed (shared atomicAdd), and a word nearer than
//     the stop that is not ready yet makes the block read the round again.
//     Tile 0 publishes prefixes at once, so every walk ends there at the
//     latest. Then the tile publishes its prefixes.
//   * The staged order: each row's tile-local index at its partition's
//     first position plus its warp's first rank plus its rank in the warp,
//     so each partition's rows form one run in input order. The run of
//     partition p goes to slots [prefix_p, prefix_p + count_p) of bucket
//     p, those below cap only. For each column, consecutive threads take
//     consecutive positions of the staged order: each reads its row's
//     value (the codes from shared memory, a payload by a load GATHER in
//     flight a thread) and writes it to the next slot of its run, so a
//     warp's stores cover whole runs. The element-size branch is taken
//     once per column per warp. On the mesh path's widest shape, tiles
//     of 1,024, 4,096 and 8,192 rows took 7-37% more device time than
//     these 2,048 (4,096 took 4% less at 64 partitions), and copying each
//     payload's tile to shared memory before its scatter took 5% more
//     than these loads (tools/hashpart_variants.py; PERF.md).
//   * hp_fill sets [min(total_p, cap), cap) of every partition of every
//     column to -1 (16-byte stores; bytes only at an unaligned head and
//     tail), reading the totals from the last tile's prefixes, and writes
//     the overflow flag. So every bucket slot is written exactly once and
//     nothing is set by a memset.
//
// A call is two device operations, hp_pass and hp_fill (only hp_fill
// when n = 0). The scratch (ticket counter, status words) belongs to the
// caller's stream (ops/stream_scratch.py): zeroed once when allocated,
// left by each call fit for the next (the counter back at 0, the status
// words tagged with this call's epoch).
//
// Plain C interface, bound from Python with ctypes (ops/hashpart.py).
// Nothing is allocated here: the wrapper passes the buckets, the flag and
// the scratch in one argument block. Every launch is checked and the
// first CUDA error code is returned (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 8                    // rows a thread
#define TILE (THREADS * ITEMS)     // rows a block
#define WARP_ROWS (TILE / WARPS)   // a warp's contiguous run
#define GATHER 8                   // payload loads in flight a thread
#define MAX_DEV 64
#define MAX_COLS 17                // the codes and 16 payloads
// scratch, in 64-bit words: [0] ticket counter, then one status word a
// (tile, partition)
#define HEADER_WORDS 1
// the argument block, in 64-bit words: n, n_dev, cap, n_cols, the flag's
// address, the scratch's address, its words, the epoch; then n_cols
// sources (the codes first), n_cols bucket addresses, n_cols widths
#define ARG_HEADER 8
#define ARG_WORDS (ARG_HEADER + 3 * MAX_COLS)
#define ST_PREFIX 0x80000000ull
#define VALUE_MASK 0x7fffffffull
#define EPOCH_MASK 0xffffffff00000000ull
#define FULL 0xffffffffu
#define FILL_BLOCKS (132 * 8)
#define MAX_DEVICES 16
// Every predecessor's block is running, so a wait in the look-back ends
// unless the kernel is broken: after SPIN_LIMIT rounds it traps rather
// than hang the card.
#define SPIN_LIMIT (1 << 26)
// dynamic shared memory: the staged order, then the tile's codes (4
// bytes a row each)
#define SMEM_BYTES (TILE * 8)

static_assert(TILE <= 65536, "tile-local rows are 16-bit");
static_assert(WARP_ROWS < 65536, "ranks in a warp's run are 16-bit");
static_assert(MAX_DEV <= 64, "warp 0 takes the partitions two a lane");

struct Cols {
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int width[MAX_COLS];  // bytes: 4 or 8
  int n;
};

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The shared state of the look-back, one entry a partition.
struct LookBack {
  int stop[MAX_DEV];  // the nearest prefix word read this round, or -1
  int acc[MAX_DEV];   // this round's sum up to the stop
  int done[MAX_DEV];  // the walk has met a prefix
  int wait;           // a word nearer than a stop was not ready
};

// pre[p] := rows of partition p in the tiles before `tile`. Thread t
// reads word end - t, so a round covers THREADS words, nearest first;
// each partition stops at its nearest ready prefix. Three barriers a
// round: after the stops, after the sums (with the all-found vote), after
// the partitions' updates.
__device__ void look_back(const unsigned long long* status, int64_t tile,
                          int n_dev, unsigned long long tag, LookBack& lb,
                          int* pre) {
  const int t = threadIdx.x;
  if (t < n_dev) {
    lb.stop[t] = -1;
    lb.acc[t] = 0;
    lb.done[t] = 0;
    pre[t] = 0;
  }
  __syncthreads();
  int64_t end = tile * n_dev - 1;
  for (int round = 0;; ++round) {
    if (round == SPIN_LIMIT) __trap();
    if (t == 0) lb.wait = 0;
    const int64_t i = end - t;
    int p = -1;
    unsigned long long s = 0;
    if (i >= 0) {
      p = (int)((uint32_t)i % (uint32_t)n_dev);
      if (lb.done[p]) {
        p = -1;
      } else {
        s = ld_status(status + i);
      }
    }
    const bool ready = p >= 0 && (s & EPOCH_MASK) == tag;
    if (ready && (s & ST_PREFIX)) atomicMax(&lb.stop[p], (int)i);
    __syncthreads();
    if (p >= 0 && (int)i >= lb.stop[p]) {
      if (!ready) {
        lb.wait = 1;
      } else {
        atomicAdd(&lb.acc[p], (int)(s & VALUE_MASK));
      }
    }
    const int all = __syncthreads_and(t >= n_dev || lb.done[t] ||
                                      lb.stop[t] >= 0);
    const bool waited = lb.wait != 0;
    if (t < n_dev) {
      if (!waited && !lb.done[t]) {
        pre[t] += lb.acc[t];
        lb.done[t] = lb.stop[t] >= 0;
      }
      lb.stop[t] = -1;
      lb.acc[t] = 0;
    }
    __syncthreads();
    if (waited) {
      __nanosleep(64);
    } else if (all) {
      return;
    } else {
      end -= THREADS;
    }
  }
}

// For staged positions q = threadIdx.x, + THREADS, ... < live: the row
// order[q] names (partition in the high half, tile-local row in the low)
// goes to out[dbase[p] + q] when q < lim[p] (its slot below cap). GATHER
// loads in flight a thread before their stores.
template <typename T>
__device__ __forceinline__ void scatter_col(const T* __restrict__ in,
                                            T* __restrict__ out,
                                            const uint32_t* order,
                                            const int* lim,
                                            const long long* dbase,
                                            int live) {
  for (int q0 = threadIdx.x; q0 < live; q0 += GATHER * THREADS) {
    T v[GATHER];
    long long d[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int q = q0 + u * THREADS;
      d[u] = -1;
      if (q < live) {
        const uint32_t e = order[q];
        const int p = (int)(e >> 16);
        if (q < lim[p]) {
          d[u] = dbase[p] + q;
          v[u] = in[e & 0xffffu];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      if (d[u] >= 0) out[d[u]] = v[u];
    }
  }
}


__global__ void __launch_bounds__(THREADS)
hp_pass(int64_t n, int n_dev, int64_t cap, int64_t nb, Cols cols,
        unsigned long long* __restrict__ scratch, unsigned epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* order = reinterpret_cast<uint32_t*>(smem);
  int32_t* scode = reinterpret_cast<int32_t*>(smem + TILE * 4);
  __shared__ int whist[WARPS][MAX_DEV];  // counts, then first ranks
  __shared__ int cnt[MAX_DEV];           // the tile's rows a partition
  __shared__ int soff[MAX_DEV];          // first staged position
  __shared__ int pre[MAX_DEV];           // rows in earlier tiles
  __shared__ int lim[MAX_DEV];           // staged positions below cap
  __shared__ long long dbase[MAX_DEV];   // bucket index of position 0
  __shared__ LookBack lb;
  __shared__ int s_live;
  __shared__ unsigned long long s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* status = scratch + HEADER_WORDS;
  const unsigned long long tag = (unsigned long long)epoch << 32;

  if (t == 0) {
    const unsigned long long tk = atomicAdd(scratch, 1ull);
    if (tk == (unsigned long long)nb - 1) *scratch = 0;  // all drawn
    s_tile = tk;
  }
  for (int k = t; k < WARPS * MAX_DEV; k += THREADS) (&whist[0][0])[k] = 0;
  __syncthreads();
  const int64_t tile = (int64_t)s_tile;
  const int64_t row0 = tile * TILE;
  const int wbase = warp * WARP_ROWS;

  // 1. the codes, read once: partition and rank in the warp's run
  const int32_t* __restrict__ codes =
      static_cast<const int32_t*>(cols.src[0]) + row0;
  const int64_t rows = n - row0 < TILE ? n - row0 : TILE;
  int32_t c[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = wbase + i * 32 + lane;
    c[i] = r < rows ? __ldcs(codes + r) : -1;
  }
  uint32_t pk[ITEMS];  // partition << 16 | rank in the warp's run
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    scode[wbase + i * 32 + lane] = c[i];
    const int p = c[i] < 0 ? n_dev
                           : (int)(splitmix32((uint32_t)c[i]) %
                                   (uint32_t)n_dev);
    const unsigned peers = __match_any_sync(FULL, p);
    const int rank =
        p < n_dev ? whist[warp][p] + __popc(peers & ((1u << lane) - 1u)) : 0;
    __syncwarp();
    if (p < n_dev && lane == __ffs(peers) - 1) whist[warp][p] += __popc(peers);
    __syncwarp();
    pk[i] = ((uint32_t)p << 16) | (uint32_t)rank;
  }
  __syncthreads();

  // 2. warp 0: each warp's first rank a partition, the tile's counts,
  // their exclusive scan (partitions lane and lane + 32)
  if (warp == 0) {
    int tot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      int run = 0;
      if (p < n_dev) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int x = whist[w][p];
          whist[w][p] = run;
          run += x;
        }
        cnt[p] = run;
      }
      tot[h] = run;
    }
    int incl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      incl[h] = tot[h];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl[h], d);
        if (lane >= d) incl[h] += y;
      }
    }
    const int first = __shfl_sync(FULL, incl[0], 31);
    if (lane < n_dev) soff[lane] = incl[0] - tot[0];
    if (lane + 32 < n_dev) soff[lane + 32] = first + incl[1] - tot[1];
    if (lane == 31) s_live = first + incl[1];
  }
  __syncthreads();

  // 3. publish the counts (thread p publishes partition p's words, so
  // its prefix lands after its count); stage the rows partition-major, in
  // input order within a partition
  if (t < n_dev) {
    st_status(status + tile * n_dev + t,
              tag | (tile == 0 ? ST_PREFIX : 0ull) |
                  (unsigned long long)cnt[t]);
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = (int)(pk[i] >> 16);
    if (p < n_dev) {
      const int pos = soff[p] + whist[warp][p] + (int)(pk[i] & 0xffffu);
      order[pos] = ((uint32_t)p << 16) | (uint32_t)(wbase + i * 32 + lane);
    }
  }

  // 4. rows of each partition in earlier tiles; publish the prefixes
  if (tile > 0) {
    look_back(status, tile, n_dev, tag, lb, pre);
    if (t < n_dev) {
      st_status(status + tile * n_dev + t,
                tag | ST_PREFIX | (unsigned long long)(pre[t] + cnt[t]));
    }
  } else if (t < n_dev) {
    pre[t] = 0;
  }
  bool keep_any = false;
  if (t < n_dev) {
    const int64_t room = cap - pre[t];
    const int keep = room <= 0 ? 0 : (room < cnt[t] ? (int)room : cnt[t]);
    lim[t] = soff[t] + keep;
    dbase[t] = (long long)t * cap + pre[t] - soff[t];
    keep_any = keep > 0;
  }
  if (!__syncthreads_or(keep_any)) return;  // every run past cap

  // 5. the coalesced scatter, column by column
  const int live = s_live;
  scatter_col<uint32_t>(reinterpret_cast<const uint32_t*>(scode),
                        static_cast<uint32_t*>(cols.dst[0]), order, lim,
                        dbase, live);
  for (int k = 1; k < cols.n; ++k) {
    if (cols.width[k] == 8) {
      scatter_col<unsigned long long>(
          static_cast<const unsigned long long*>(cols.src[k]) + row0,
          static_cast<unsigned long long*>(cols.dst[k]), order, lim, dbase,
          live);
    } else {
      scatter_col<uint32_t>(static_cast<const uint32_t*>(cols.src[k]) + row0,
                            static_cast<uint32_t*>(cols.dst[k]), order, lim,
                            dbase, live);
    }
  }
}

// Sets [min(total_p, cap), cap) of partition p of column k to -1, for
// blockIdx.y = k * n_dev + p: single bytes up to the first 16-byte
// boundary and after the last, 16-byte stores between. `last`: the last
// tile's prefixes (the totals), or null when there are no rows. Block
// (0, 0) also writes the flag.
__global__ void __launch_bounds__(THREADS)
hp_fill(const unsigned long long* __restrict__ last, int n_dev, int64_t cap,
        Cols cols, uint8_t* __restrict__ overflow) {
  const int y = blockIdx.y;
  const int k = y / n_dev, p = y % n_dev;
  if (blockIdx.x == 0 && y == 0) {
    const bool over = last != nullptr && threadIdx.x < n_dev &&
                      (int64_t)(last[threadIdx.x] & VALUE_MASK) > cap;
    const int any = __syncthreads_or(over);
    if (threadIdx.x == 0) *overflow = any ? 1 : 0;
  }
  const int64_t total = last ? (int64_t)(last[p] & VALUE_MASK) : 0;
  const int64_t es = cols.width[k];
  const uintptr_t base =
      (uintptr_t)cols.dst[k] + (uintptr_t)((int64_t)p * cap * es);
  const uintptr_t lo = base + (uintptr_t)((total < cap ? total : cap) * es);
  const uintptr_t hi = base + (uintptr_t)(cap * es);
  if (lo >= hi) return;
  const uintptr_t up = (lo + 15) & ~(uintptr_t)15;
  const uintptr_t body_lo = up < hi ? up : hi;
  const uintptr_t down = hi & ~(uintptr_t)15;
  const uintptr_t body_hi = down > body_lo ? down : body_lo;
  if (blockIdx.x == 0 && threadIdx.x < 16) {
    const uintptr_t h = lo + threadIdx.x;
    if (h < body_lo) *reinterpret_cast<uint8_t*>(h) = 0xff;
    const uintptr_t e = body_hi + threadIdx.x;
    if (e < hi) *reinterpret_cast<uint8_t*>(e) = 0xff;
  }
  const uint4 ones = make_uint4(FULL, FULL, FULL, FULL);
  const uintptr_t stride = (uintptr_t)gridDim.x * THREADS * 16;
  for (uintptr_t a =
           body_lo + ((uintptr_t)blockIdx.x * THREADS + threadIdx.x) * 16;
       a < body_hi; a += stride) {
    *reinterpret_cast<uint4*>(a) = ones;
  }
}

// Lets hp_pass take SMEM_BYTES of dynamic shared memory beside its
// static arrays (past the default 48 KB in all), once per device.
static cudaError_t allow_smem() {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(hp_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

extern "C" {

// Rows per tile of hp_pass: the wrapper sizes the scratch as
// HEADER_WORDS + ceil(n / tile) * n_dev 64-bit words.
int pinot_hashpart_tile(void) { return TILE; }

int pinot_hashpart_max_cols(void) { return MAX_COLS; }

int pinot_hashpart_header_words(void) { return HEADER_WORDS; }

int pinot_hashpart_arg_words(void) { return ARG_WORDS; }

// args: the argument block (ARG_HEADER words, then the columns'; see
// ARG_WORDS). The codes are (n,) int32, each payload (n,) of its width
// (4 or 8 bytes); each column's buckets are (n_dev, cap) of its width;
// the flag is one byte; the scratch is zeroed when allocated and used
// only by calls on this stream since, and the epoch (never 0) is one no
// earlier call on it used.
int pinot_hashpart(const int64_t* args, void* stream) {
  const int64_t n = args[0], cap = args[2], words = args[6];
  const int64_t n_dev = args[1], n_cols = args[3], epoch = args[7];
  if (n < 0 || n > INT32_MAX - TILE || n_dev < 1 || n_dev > MAX_DEV ||
      cap < 1 || n_cols < 1 || n_cols > MAX_COLS || epoch < 1 ||
      epoch > 0xffffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = (n + TILE - 1) / TILE;
  if (words < HEADER_WORDS + nb * n_dev) return (int)cudaErrorInvalidValue;
  Cols cols;
  cols.n = (int)n_cols;
  int max_width = 4;
  for (int k = 0; k < MAX_COLS; ++k) {
    const bool in = k < n_cols;
    cols.src[k] = in ? (const void*)args[ARG_HEADER + k] : nullptr;
    cols.dst[k] = in ? (void*)args[ARG_HEADER + n_cols + k] : nullptr;
    cols.width[k] = in ? (int)args[ARG_HEADER + 2 * n_cols + k] : 0;
    if (in && cols.width[k] != 4 && cols.width[k] != 8) {
      return (int)cudaErrorInvalidValue;
    }
    if (cols.width[k] > max_width) max_width = cols.width[k];
  }
  if (cols.width[0] != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* scratch = reinterpret_cast<unsigned long long*>(args[5]);
  cudaError_t err;
  if (nb > 0) {
    if ((err = allow_smem()) != cudaSuccess) return (int)err;
    hp_pass<<<(unsigned)nb, THREADS, SMEM_BYTES, s>>>(
        n, (int)n_dev, cap, nb, cols, scratch, (unsigned)epoch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int64_t rows = n_dev * n_cols;
  int64_t fb = (cap * max_width + THREADS * 16 - 1) / (THREADS * 16);
  const int64_t most = FILL_BLOCKS / rows > 1 ? FILL_BLOCKS / rows : 1;
  if (fb > most) fb = most;
  hp_fill<<<dim3((unsigned)fb, (unsigned)rows), THREADS, 0, s>>>(
      nb > 0 ? scratch + HEADER_WORDS + (nb - 1) * n_dev : nullptr,
      (int)n_dev, cap, cols, reinterpret_cast<uint8_t*>(args[4]));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"

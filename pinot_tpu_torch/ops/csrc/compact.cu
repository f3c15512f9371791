// Exact, order-preserving masked row compaction for Hopper (sm_90a), in
// one streaming pass with decoupled look-back.
//
// Replaces the TPU kernel pinot_tpu/ops/compact.py:252 (_kernel, launched
// by _compact_pallas). That kernel compacts lane-wise with one-hot
// placement matmuls because the TPU cannot scatter; its output is loose
// and unordered. On the H100 a scatter is cheap, so this one computes
// exactly what the JAX package's exact fallback (_compact_xla) computes:
// the matched rows of a mask and of up to MAX_COLS columns of 4 or 8
// bytes, moved to the front in their original order, with every slot in
// [matched, cap) zeroed.
//
// What bounds it: bytes. The least a call must move is the mask once, the
// kept rows' column values once and the valid flags and output columns
// over the capacity once (compact_bytes in ops/compact.py). The kept rows
// are gathered, so when the mask is sparse each one costs a 32-byte
// sector of every column: that sector-granular read is the practical
// floor above the bound. There is no arithmetic worth counting. A pass
// whose blocks each take one small tile is bound by latency instead: a
// block's life is a chain of round trips (ticket, mask, look-back) with
// its loads in flight for a small part of it. So the design puts many
// bytes behind each round trip and touches each input once:
//
//   * One block per tile of TILE = SUBTILES * SUB rows (64 Ki). A block
//     takes its tile by an atomic ticket, not by blockIdx, so a tile only
//     ever waits on tiles whose blocks have already started: forward
//     progress does not depend on the order in which the hardware
//     schedules blocks.
//   * The mask is read once with 16-byte loads, a sub-tile at a time, the
//     next sub-tile's loads in flight while the current one is folded
//     (round j of sub-tile s: thread t reads bytes (j * THREADS + t) * 16
//     of it, so a warp's load covers 512 contiguous bytes). A torch bool
//     is one byte per row; each 32-bit word is folded into 4 row bits
//     (any non-zero byte is a set row) and __popc counts them; the row
//     bits wait in shared memory for the scatter. Tiles of 4 sub-tiles
//     were faster than tiles of 2 or 1 (compact_variants.py). A mask
//     whose data_ptr() is not 16-byte aligned (a slice)
//     is addressed from the aligned address below it: rows shift by
//     `mis` = data_ptr() % 16, and only the partial 16-byte chunks at the
//     head and the tail are read a byte at a time.
//   * A sub-tile's per-thread round counts are packed into 16-bit fields
//     of one 64-bit word, so one block scan (warp shuffles plus one pass
//     over the warp totals) ranks every row of the tile.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", NVIDIA 2016): each tile has a 64-bit
//     status word, its flag in the high half and its count in the low
//     half, so one store publishes both and one load reads both. Nothing
//     else is read on the strength of a status, so relaxed (gpu-scope)
//     loads and stores are enough; acquire/release would order nothing
//     that is needed, and on the H100 it cost up to 2 us a call
//     (pinot_tpu_torch/tools/compact_variants.py times both; PERF.md has
//     the numbers). A tile publishes its count (FLAG_AGG), stages its
//     matched rows (time in which its predecessors publish theirs), then
//     the whole block reads THREADS predecessors at a time, nearest
//     first, until it meets an inclusive prefix (FLAG_PREFIX), and
//     publishes its own.
//   * The scatter is coalesced: the tile-local indices of the matched
//     rows are staged in shared memory in row order (the whole tile when
//     they fit, STAGE rows, else a sub-tile at a time); the warps split
//     the columns among them, and for its column a warp's consecutive
//     threads read col[idx[q]] and write out[start + q] for start + q <
//     cap, GATHER loads in flight per thread. The element-size branch is
//     taken once per column per warp. `valid` is a run of ones. A tile
//     whose offset is already >= cap publishes its count and skips the
//     scatter.
//   * The last tile writes n_valid, matched and overflow.
//   * compact_fill zeroes [matched, cap) of `valid` and every column with
//     16-byte streaming stores (single bytes only at an unaligned head).

// A call is three device operations: one cudaMemsetAsync of the scratch
// (ticket, scalars, status words), compact_pass and compact_fill. Clearing
// the outputs with memsets before the pass instead of the fill after it
// was slower in total (compact_variants.py).
//
// Plain C interface, bound from Python with ctypes
// (pinot_tpu_torch/ops/compact.py). Nothing is allocated here: the
// wrapper passes outputs and scratch. Every launch is checked and the
// first CUDA error code is returned (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 8
#define THREADS 256
#define WARPS (THREADS / 32)
#define LOADS 4  // 16-byte mask loads per thread per sub-tile
#define SUB (THREADS * 16 * LOADS)  // rows per sub-tile
#define SUBTILES 4  // sub-tiles per tile
#define TILE (SUB * SUBTILES)
#define STAGE SUB  // staged row indices
#define LANES 128
// scratch, in 64-bit words: [0] ticket, [1..2] scalars (int32 n_valid,
// matched, overflow, spare), [3] spare, [HEADER_WORDS..] one status word
// per tile
#define HEADER_WORDS 4
#define FLAG_AGG 1ull
#define FLAG_PREFIX 2ull
#define FULL 0xffffffffu
// Every predecessor's block is running, so a wait in the look-back ends
// unless the kernel is broken: after SPIN_LIMIT rounds it traps rather
// than hang the card.
#define SPIN_LIMIT (1 << 26)

static_assert(LOADS <= 4, "a sub-tile's round counts fill one 64-bit word");
static_assert(TILE <= 65536, "tile-local row indices are 16-bit");
static_assert(MAX_COLS <= WARPS, "every column has a warp in the scatter");

struct ColArgs {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  int esize[MAX_COLS];
  int ncols;
};

// Status words hold their flag and count in one 64-bit word, so a relaxed
// (but strong, gpu-scope) load sees a whole status and nothing else is read
// on the strength of it: no acquire or release ordering is needed.
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

// The 16 mask bytes of virtual rows [v0, v0 + 16); rows outside [lo, hi)
// read as 0. `base` is 16-byte aligned, so a chunk wholly inside the
// range is one vector load.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ base,
                                            int64_t v0, int64_t lo,
                                            int64_t hi) {
  if (v0 >= lo && v0 + 16 <= hi) {
    return __ldcs(reinterpret_cast<const uint4*>(base + v0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int k = 0; k < 16; ++k) {
    const int64_t v = v0 + k;
    if (v >= lo && v < hi) w[k >> 2] |= (uint32_t)base[v] << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The chunks thread t reads of the sub-tile at virtual row v_sub.
__device__ __forceinline__ void load_sub(uint4 (&raw)[LOADS],
                                         const uint8_t* __restrict__ mask,
                                         int64_t v_sub, int mis, int64_t n) {
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    raw[j] = load_chunk(mask,
                        v_sub + (int64_t)(j * THREADS + threadIdx.x) * 16,
                        mis, mis + n);
  }
}

// Four mask bytes -> four row bits (bit k set when byte k is non-zero).
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  w = __vcmpne4(w, 0u) & 0x01010101u;
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xfu;
}

__device__ __forceinline__ uint32_t row_bits(uint4 c) {
  return nibble(c.x) | nibble(c.y) << 4 | nibble(c.z) << 8 | nibble(c.w) << 12;
}

__device__ __forceinline__ uint32_t field(unsigned long long w, int j) {
  return (uint32_t)(w >> (16 * j)) & 0xffffu;
}

// The whole block: the sum of the counts of every tile before `tile`.
// Thread t reads the status of tile end - t, so one round trip covers
// THREADS predecessors (nearest first); tiles before 0 read as a prefix
// of 0. Each warp reduces its 32 statuses up to its nearest prefix; the
// warps' results meet in shared memory (double-buffered by round parity,
// so one barrier a round suffices).
__device__ int64_t look_back(const unsigned long long* status, int64_t tile,
                             unsigned long long (*lb_sum)[WARPS],
                             int (*lb_state)[WARPS]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int64_t prefix = 0;
  int64_t end = tile - 1;
  for (int round = 0;; ++round) {
    if (round == SPIN_LIMIT) __trap();
    const int64_t i = end - t;
    const unsigned long long s =
        i >= 0 ? ld_status(status + i) : (FLAG_PREFIX << 32);
    const unsigned long long flag = s >> 32;
    const unsigned have = __ballot_sync(FULL, flag == FLAG_PREFIX);
    // lanes up to and including the warp's nearest inclusive prefix
    const unsigned need = have ? ((have & (0u - have)) << 1) - 1u : FULL;
    const unsigned waiting = __ballot_sync(FULL, flag == 0) & need;
    unsigned long long v = ((need >> lane) & 1u) ? (s & 0xffffffffull) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    const int b = round & 1;
    if (lane == 0) {
      lb_sum[b][warp] = v;
      lb_state[b][warp] = (have ? 1 : 0) | (waiting ? 2 : 0);
    }
    __syncthreads();
    unsigned long long sum = 0;
    int found = 0;  // 1: prefix reached; 2: a needed tile is not ready
    for (int w = 0; w < WARPS && !found; ++w) {
      const int st = lb_state[b][w];
      if (st & 2) {
        found = 2;
      } else {
        sum += lb_sum[b][w];
        if (st & 1) found = 1;
      }
    }
    if (found == 2) {
      __nanosleep(64);
      continue;
    }
    prefix += (int64_t)sum;
    if (found == 1) return prefix;
    end -= THREADS;
  }
}

// out[q] = in[idx[q]] for q = first, first + stride, ... < m (consecutive
// threads on consecutive q), GATHER independent loads in flight per thread
// before their stores.
#define GATHER 8
template <typename T>
__device__ __forceinline__ void gather_column(const void* in_v, void* out_v,
                                              const uint16_t* idx, int m,
                                              int first, int stride) {
  const T* __restrict__ in = static_cast<const T*>(in_v);
  T* __restrict__ out = static_cast<T*>(out_v);
  for (int q0 = first; q0 < m; q0 += GATHER * stride) {
    T v[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int q = q0 + u * stride;
      if (q < m) v[u] = __ldg(in + idx[q]);
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int q = q0 + u * stride;
      if (q < m) out[q] = v[u];
    }
  }
}

// Staged rows idx[0, cnt) go to output slots [dst, dst + cnt), those
// below cap only; row0 is the real row of tile-local row 0. The warps are
// split among the columns (warp w moves column w % ncols), so every
// column's gathers are in flight at once and each warp takes the element
// size branch once.
__device__ __forceinline__ void scatter_rows(const ColArgs& cols,
                                             const uint16_t* idx,
                                             int64_t row0, int64_t dst,
                                             uint32_t cnt, int64_t cap,
                                             uint8_t* __restrict__ valid) {
  if (dst >= cap || cnt == 0) return;
  const int m = (int)(cap - dst < (int64_t)cnt ? cap - dst : cnt);
  for (int q = threadIdx.x; q < m; q += THREADS) valid[dst + q] = 1;
  const int nc = cols.ncols;
  if (nc == 0) return;
  const int warp = threadIdx.x >> 5;
  const int c = warp % nc;
  const int first = (warp / nc) * 32 + (threadIdx.x & 31);
  const int stride = ((WARPS - c + nc - 1) / nc) * 32;  // column c's threads
  if (cols.esize[c] == 8) {
    gather_column<unsigned long long>(
        static_cast<const unsigned long long*>(cols.in[c]) + row0,
        static_cast<unsigned long long*>(cols.out[c]) + dst, idx, m, first,
        stride);
  } else {
    gather_column<unsigned>(static_cast<const unsigned*>(cols.in[c]) + row0,
                            static_cast<unsigned*>(cols.out[c]) + dst, idx, m,
                            first, stride);
  }
}

// Stage the matched rows of sub-tile s at ranks base.. (in row order);
// returns base + the sub-tile's count. excl: this thread's exclusive
// round counts, total: the block's, both packed in 16-bit fields.
__device__ __forceinline__ uint32_t stage_sub(
    int s, uint32_t base, unsigned long long excl, unsigned long long total,
    uint16_t (*sbits)[THREADS], uint16_t* idx) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    uint32_t r = base + field(excl, j);
    const uint32_t row = (uint32_t)(s * SUB + (j * THREADS + t) * 16);
    for (uint32_t b = sbits[s * LOADS + j][t]; b; b &= b - 1) {
      idx[r++] = (uint16_t)(row + __ffs(b) - 1);
    }
    base += field(total, j);
  }
  return base;
}

// mask: the 16-byte aligned address `mis` bytes below the mask's first
// row; one block per tile of the nb that cover mis + n virtual rows.
__global__ void __launch_bounds__(THREADS)
compact_pass(const uint8_t* __restrict__ mask, int mis, int64_t n,
             int64_t nb, ColArgs cols, uint8_t* __restrict__ valid,
             int64_t slots_cap, unsigned long long* __restrict__ scratch) {
  __shared__ uint16_t idx[STAGE];
  __shared__ uint16_t sbits[SUBTILES * LOADS][THREADS];
  __shared__ unsigned long long warp_tot[SUBTILES][WARPS];
  __shared__ unsigned long long lb_sum[2][WARPS];
  __shared__ int lb_state[2][WARPS];
  __shared__ unsigned s_tile;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t cap = slots_cap * LANES;
  unsigned long long* status = scratch + HEADER_WORDS;

  if (t == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t v_base = tile * TILE;

  // 1. the tile's mask, a sub-tile's loads in flight while the one before
  // it folds into row bits (kept in shared memory) and packed counts
  unsigned long long packed[SUBTILES];
  {
    uint4 cur[LOADS], nxt[LOADS];
    load_sub(cur, mask, v_base, mis, n);
#pragma unroll
    for (int s = 0; s < SUBTILES; ++s) {
      if (s + 1 < SUBTILES) {
        load_sub(nxt, mask, v_base + (s + 1) * SUB, mis, n);
      }
      packed[s] = 0;
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const uint32_t b = row_bits(cur[j]);
        sbits[s * LOADS + j][t] = (uint16_t)b;
        packed[s] |= (unsigned long long)__popc(b) << (16 * j);
      }
      if (s + 1 < SUBTILES) {
#pragma unroll
        for (int j = 0; j < LOADS; ++j) cur[j] = nxt[j];
      }
    }
  }

  // 2. block scan of the packed counts (no field exceeds THREADS * 16)
  unsigned long long excl[SUBTILES], total[SUBTILES];
#pragma unroll
  for (int s = 0; s < SUBTILES; ++s) {
    unsigned long long incl = packed[s];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_tot[s][warp] = incl;
    excl[s] = incl - packed[s];
  }
  __syncthreads();
  uint32_t agg = 0;
#pragma unroll
  for (int s = 0; s < SUBTILES; ++s) {
    total[s] = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned long long v = warp_tot[s][w];
      if (w < warp) excl[s] += v;
      total[s] += v;
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) agg += field(total[s], j);
  }

  // 3. publish the count; stage the first group of matched rows (time in
  // which the predecessors publish theirs); look back; publish the prefix.
  // A group is the whole tile when its rows fit in idx, else a sub-tile.
  if (t == 0) {
    st_status(status + tile,
              ((tile == 0 ? FLAG_PREFIX : FLAG_AGG) << 32) | agg);
  }
  const bool whole = agg <= STAGE;
  uint32_t staged = 0;
  if (whole) {
#pragma unroll
    for (int s = 0; s < SUBTILES; ++s) {
      staged = stage_sub(s, staged, excl[s], total[s], sbits, idx);
    }
  } else {
    staged = stage_sub(0, 0, excl[0], total[0], sbits, idx);
  }
  __syncthreads();
  const int64_t start =
      tile == 0 ? 0 : look_back(status, tile, lb_sum, lb_state);
  if (t == 0) {
    if (tile > 0) {
      st_status(status + tile, (FLAG_PREFIX << 32) | (uint32_t)(start + agg));
    }
    if (tile == nb - 1) {
      const int64_t matched = start + agg;
      int64_t slots = (matched + LANES - 1) / LANES;
      if (slots > slots_cap) slots = slots_cap;
      int32_t* scalars = reinterpret_cast<int32_t*>(scratch + 1);
      scalars[0] = (int32_t)(slots * LANES);
      scalars[1] = (int32_t)matched;
      scalars[2] = matched > cap ? 1 : 0;
    }
  }

  // 4. coalesced scatter, group by group (a tile past cap skips it)
  const int64_t row0 = v_base - mis;  // real row of tile-local row 0
  scatter_rows(cols, idx, row0, start, staged, cap, valid);
  if (!whole) {
    int64_t dst = start + staged;
#pragma unroll
    for (int s = 1; s < SUBTILES; ++s) {
      if (dst >= cap) break;  // uniform across the block
      __syncthreads();        // every thread is done with idx
      staged = stage_sub(s, 0, excl[s], total[s], sbits, idx);
      __syncthreads();
      scatter_rows(cols, idx, row0, dst, staged, cap, valid);
      dst += staged;
    }
  }
}

// Zero [min(matched, cap), cap) of array blockIdx.y (0: valid, c + 1:
// column c): single bytes up to the first 16-byte boundary and after the
// last, 16-byte stores between.
__global__ void __launch_bounds__(THREADS)
compact_fill(const unsigned long long* __restrict__ scratch, ColArgs cols,
             uint8_t* __restrict__ valid, int64_t cap) {
  const int a = blockIdx.y;
  uint8_t* base = a == 0 ? valid : static_cast<uint8_t*>(cols.out[a - 1]);
  const int64_t es = a == 0 ? 1 : cols.esize[a - 1];
  const int64_t matched =
      reinterpret_cast<const int32_t*>(scratch + 1)[1];
  const uintptr_t lo = (uintptr_t)base + (matched < cap ? matched : cap) * es;
  const uintptr_t hi = (uintptr_t)base + cap * es;
  if (lo >= hi) return;
  const uintptr_t up = (lo + 15) & ~(uintptr_t)15;
  const uintptr_t body_lo = up < hi ? up : hi;
  const uintptr_t down = hi & ~(uintptr_t)15;
  const uintptr_t body_hi = down > body_lo ? down : body_lo;
  if (blockIdx.x == 0 && threadIdx.x < 16) {
    const uintptr_t h = lo + threadIdx.x;
    if (h < body_lo) *reinterpret_cast<uint8_t*>(h) = 0;
    const uintptr_t e = body_hi + threadIdx.x;
    if (e < hi) *reinterpret_cast<uint8_t*>(e) = 0;
  }
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t stride = (uintptr_t)gridDim.x * THREADS * 16;
  for (uintptr_t p = body_lo + ((uintptr_t)blockIdx.x * THREADS + threadIdx.x)
                                   * 16;
       p < body_hi; p += stride) {
    __stcs(reinterpret_cast<uint4*>(p), z);  // the tail is not read soon
  }
}

extern "C" {

// Rows per tile of compact_pass: the wrapper sizes the scratch as
// HEADER_WORDS + ceil((n + 15) / tile) 64-bit words (a misaligned mask
// shifts its rows by up to 15).
int pinot_compact_tile(void) { return TILE; }

int pinot_compact_max_cols(void) { return MAX_COLS; }

int pinot_compact_header_words(void) { return HEADER_WORDS; }

// mask: n bytes (non-zero: row kept), any alignment;
// in_ptrs/out_ptrs/esizes: host arrays of ncols entries (esize 4 or 8);
// valid_out: slots_cap*128 bytes;
// out_ptrs[c]: slots_cap*128 elements, 16-byte aligned like valid_out;
// scratch: scratch_words 64-bit words, whose words 1..2 receive the int32
// scalars [n_valid, matched, overflow].
int pinot_compact(const void* mask, int64_t n, int ncols,
                  const void* const* in_ptrs, void* const* out_ptrs,
                  const int* esizes, void* valid_out, int64_t slots_cap,
                  void* scratch, int64_t scratch_words, void* stream) {
  const int mis = (int)((uintptr_t)mask & 15);
  const int64_t nb = n > 0 ? (n + mis + TILE - 1) / TILE : 0;
  if (ncols < 0 || ncols > MAX_COLS || n < 0 || n > INT32_MAX - TILE ||
      slots_cap < 1 || slots_cap > INT32_MAX / LANES ||
      scratch_words < HEADER_WORDS + nb) {
    return (int)cudaErrorInvalidValue;
  }
  ColArgs cols;
  cols.ncols = ncols;
  for (int c = 0; c < MAX_COLS; ++c) {
    cols.in[c] = c < ncols ? in_ptrs[c] : nullptr;
    cols.out[c] = c < ncols ? out_ptrs[c] : nullptr;
    cols.esize[c] = c < ncols ? esizes[c] : 0;
    if (c < ncols && esizes[c] != 4 && esizes[c] != 8) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cap = slots_cap * LANES;
  uint8_t* valid = static_cast<uint8_t*>(valid_out);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err;

  err = cudaMemsetAsync(words, 0, (size_t)(HEADER_WORDS + nb) * 8, s);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0) {
    compact_pass<<<(unsigned)nb, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(mask) - mis, mis, n, nb, cols, valid,
        slots_cap, words);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  int64_t fb = (cap * 8 / 16 + THREADS - 1) / THREADS;
  if (fb > 132 * 8) fb = 132 * 8;
  compact_fill<<<dim3((unsigned)fb, (unsigned)(ncols + 1)), THREADS, 0, s>>>(
      words, cols, valid, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // extern "C"

// Vector search (K15) for Hopper (sm_90a): similarity scoring of a dense
// matrix or of IVF pages against a batch of queries, then an exact top-k.
//
// Replaces the two traced device programs of the JAX package's vector
// index, pinot_tpu/index/vector.py:284 (_batched_flat_kernel: sims = M.q,
// or 2 M.q - |m|^2 - |q|^2 for l2, then lax.top_k) and :316
// (_batched_ivf_kernel: centroid scores, top-nprobe lists, the ragged
// page-run expansion, a gather of whole (page, dim) blocks from the
// page-major copy of the matrix, masked scores, top-k). Both ran under
// lax.map, so the TPU read the matrix once per query.
//
// What bounds it: bytes. The flat scan reads the matrix (n x dim float32,
// 256 MiB for a 2^19 x 128 segment: 80 us at 3.35 TB/s) and does 2 n dim B
// flops, which at B = 16 queries and dim 128 is 4 flops a byte, under the
// card's float32 rate (67 TFLOP/s, 20 a byte: the 2^30 FMAs take 32 us).
// The IVF probe reads only the probed pages. So the design keeps the
// matrix streaming at the memory rate and everything else on chip:
//
//   * Scoring (scan): a block of 128 threads walks tiles of 128 rows. Each
//     tile comes into shared memory in k-slices of 32 floats (128 bytes of
//     every row, and the same slice of each of the launch's up to 16
//     queries) through a ring of 3 stages (2 at 16 queries, to fit more
//     blocks) filled by cp.async (16-byte copies, cp.async.cg, straight to
//     shared memory; a thread finds its copies' source rows once a tile):
//     the block issues the copies of slice i + ST - 1 before it computes
//     slice i, so they are in flight while it runs its FMAs. The rows'
//     squared norms come the same way beside the first slice. Grids are
//     persistent: 2 blocks per SM (3 for the flat scan's small top-k),
//     each walking every grid-th tile. More blocks on an SM, not a deeper
//     ring, is what kept the SMs busy (tools/vec_variants.py).
//   * The tile: thread (row group rg, query group qg) of a warp holds the
//     dot products of 4 rows x 4 queries in registers (for 16 queries;
//     fewer rows or queries for smaller batches) and reads one float4 of
//     each per 4 dims: 8 shared loads for 64 FMAs. There is no cross-lane
//     reduction: each (row, query) dot product is one chain of fmaf over
//     d = 0, 1, ..., dim - 1 from +0.0 in one thread, kept across the
//     k-slices. Full float32 FMAs (no TF32, no bf16, no tensor cores).
//   * Bank conflicts: a slice row is stored at a stride of 36 floats, not
//     32. 36 / 4 = 9 is odd, so the 16-byte units of 8 consecutive rows
//     (the 8 row groups of one load instruction) fall in 8 distinct groups
//     of 4 banks; the 4 query groups read 4 consecutive query rows, each a
//     broadcast. (A 128-byte-swizzled TMA tensor map would do the same;
//     the padded layout needs no tensor map, no driver entry point and no
//     16-byte alignment of the slice ends, and cp.async's zero fill gives
//     the ragged last tile and the slice past dim for free.)
//   * Batched == solo, bitwise: the chain depends on the row's and the
//     query's values alone, not on B, on the query's slot, on the row's
//     place in a tile or on the route. Rows whose dim is not a multiple of
//     4 (or whose base is not 16-byte aligned) are staged by 4-byte copies
//     into the same layout and scored by the same code. Padding is +0.0,
//     and fmaf(0, 0, acc) == acc for every acc the chain can hold (it never
//     holds -0.0: it starts at +0.0 and x + -x rounds to +0.0). |q|^2 is
//     the same chain of q with itself. The IVF page kernel scores with the
//     same code, and paged rows and norms are copies of the matrix's, so a
//     document scores the same bits in the flat scan and in the probe; the
//     centroids are scored by it too.
//   * Top-k fused into the scoring pass (k2 <= 128 = KCAP): each block
//     keeps, per query, a buffer of 192 keys (k2 <= 32) or 384 and a
//     threshold. After each tile a thread appends its keys above the
//     threshold (one shared atomic per query and warp); a buffer that
//     could overflow on the next tile is cut to its top k by one warp (an
//     8-bit radix select in registers and a 256-word shared histogram),
//     which raises the threshold. Each cut also raises the query's shared
//     threshold in global memory (atomicMax), which every block reads with
//     each tile (a 16-byte cp.async beside the first slice): a key at or
//     below any block's threshold is below k keys of the search, so a
//     block appends only keys above both. At the end a block cuts its
//     buffer to k and appends the keys not below the shared threshold to
//     the query's candidate list (an atomic count beside the threshold).
//     The (B, n) score matrix is never written. The flat scan then merges
//     the candidates in one block per query (vec_select_block<true>): the
//     thresholds' memset, the scan and the merge, three device operations
//     a search. Larger k takes the scores route: the same scan writes the
//     scores, then the select below.
//   * IVF in two launches. vec_probe, one block per query: the centroid
//     scores (by the scan, into shared memory), the top nprobe by the
//     block's radix select, the lists ordered by rank, and the ragged
//     expansion of their page runs into the query's page slots (a
//     block-wide scan of the lists' page counts, then a binary search per
//     slot), written once; it zeroes the query's ticket, threshold and
//     count.
//     vec_ivf_topk, grid (blocks per query, B): each block scans a run of
//     the query's slots, two 64-row pages per tile, with the fused top-k,
//     and the last block of each query to finish (a ticket counter that
//     vec_probe zeroes) merges the blocks' keys, sorts them and maps them
//     to documents. Sentinel documents (== n_docs) and slots past the
//     ragged total (the pad page) score -inf without being read (their
//     copies are zero fills). Positions are slots of the flattened
//     (max_pages x P) probe, so ties go to the lower slot as in lax.top_k.
//   * Top-k order (make_key, the radix selects, sort, unpack): lax.top_k's
//     order is score descending, ties to the lower position, with -0.0
//     below +0.0 and NaN above everything (XLA's total order). Each (score,
//     position) becomes one 64-bit key: the float's orderable uint32 view,
//     then 2^32 - 1 - position. Keys are unique, so the top k keys are
//     exactly lax.top_k's answer, whichever route finds them. The select
//     stage (pinot_vec_select) keeps three routes by size: one block per
//     query for rows of at most 2^17 keys with k2 <= 4096
//     (vec_select_block: histogram, threshold, candidates and sort in
//     shared memory); per-block candidates of 4096-score chunks
//     (vec_select_cand) then one block for long rows with k2 <= 1024; a
//     multi-block radix select (vec_radix: 8 bits a pass, the last block
//     of a pass picks the digit by a ticket counter, stopping once the
//     chosen bucket is taken whole; vec_emit; a bitonic sort) above that.
//
// Nothing is allocated here: the wrapper (pinot_tpu_torch/ops/vecsearch.py)
// passes outputs and scratch (sized by the *_scratch functions), and every
// launch goes on its stream with no synchronisation. Shared memory above
// 48 KB is allowed once per kernel instance. Every launch is checked and
// the first CUDA error code is returned (0 on success). Plain C interface,
// bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#define WARPS 8
#define THREADS (WARPS * 32)
#define FULL 0xffffffffu
#define MAX_SLOTS 16       // queries scored per matrix row by one launch
#define MAX_DIM_VEC 2048   // the largest dim taken (16-byte copies)
#define MAX_DIM_SCALAR 512 // ... and with 4-byte copies
#define PASSES 8           // 8-bit digits of the 64-bit key
#define SELECT_ITEMS 16    // keys per thread of a radix block
#define MAX_SELECT_BLOCKS 1024
#define SORT_CHUNK 4096    // keys sorted in one block's shared memory
#define SORT_THREADS 512
#define BLOCK_THREADS 1024 // the one-block select
#define BLOCK_SELECT_MAX_S (1 << 17)
#define CAND_CHUNK 4096    // scores per block of the two-phase select
#define CAND_THREADS 256   // its first phase: 16 scores a thread

// scoring tiles
#define TILE_ROWS 128      // rows of a tile
#define TILE_WARPS 4
#define TILE_THREADS (TILE_WARPS * 32)
#define KS 32              // floats of a row per stage (a k-slice)
#define SP 36              // the stage's row stride in floats (SP / 4 odd)
#define STAGES 3           // the cp.async ring of the scanning kernels
#define PROBE_STAGES 8     // ... of vec_probe, which holds no candidates
#define PROBE_LISTS 8192   // centroid scores vec_probe keeps in shared memory
#define PROBE_SEL 4096     // ... and chosen lists (in its freed stages)
#define BLOCKS_PER_SM 2    // persistent scoring blocks per SM, at most
#define SMALL_BLOCKS_PER_SM 3  // ... for the flat scan's small top-k
#define KCAP 128           // the largest k2 of the fused top-k
#define KSMALL 32          // ... with its smaller candidate buffers
#define MERGE_MAX 8192     // keys the last IVF block of a query merges

// a tile row's source: a matrix row >= 0, or one of
#define NO_READ (-1LL)     // a candidate scored -inf, not read
#define NO_KEY (-2LL)      // not a candidate (past the rows)

// per-query select state, in 32-bit words
#define ST_PREFIX 0        // 2 words: the key prefix found so far
#define ST_KREM 2          // keys still to take from the prefix's bucket
#define ST_RESOLVED 3      // the threshold is final
#define ST_DONE 4          // PASSES words: finished blocks of each pass
#define ST_OUT (ST_DONE + PASSES)   // keys written by vec_emit
#define STATE_WORDS 16

enum { MODE_DOT = 0, MODE_L2 = 1, MODE_L2_NOQ = 2 };

__device__ __forceinline__ float finish(float dot, int mode, float row_sq,
                                        float q_sq) {
  if (mode == MODE_DOT) return dot;
  const float s = __fsub_rn(__fmul_rn(2.0f, dot), row_sq);
  return mode == MODE_L2 ? __fsub_rn(s, q_sq) : s;
}

// cp.async: 16 or 4 bytes global -> shared, zero-filled where !ok (no
// bytes are read then; src is any valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// top-k
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long make_key(float s, long long i) {
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ unsigned long long load_prefix(const unsigned* st) {
  return ((unsigned long long)st[ST_PREFIX + 1] << 32) | st[ST_PREFIX];
}

// The digit of a radix pass, by one warp: the largest d with (keys in
// buckets above d) + h[d] >= krem. Lane l holds buckets 255 - 8l .. 248 -
// 8l; a prefix sum over the lanes finds the one lane whose buckets reach
// krem, which scans its eight. Returns d and, in *above, the keys in
// buckets above it (every lane gets them). h may be in shared or global
// memory (read through ld, which the caller picks).
template <typename Load>
__device__ __forceinline__ int pick_digit(Load ld, unsigned krem,
                                          unsigned* above, unsigned* count) {
  const int lane = threadIdx.x & 31;
  unsigned c[8], tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = ld(255 - 8 * lane - j);
    tot += c[j];
  }
  unsigned incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned excl = incl - tot;
  const bool mine = excl < krem && krem <= incl;
  int d = 0;
  unsigned cum = excl, cnt = 0;
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cum + c[j] >= krem) {
        d = 255 - 8 * lane - j;
        cnt = c[j];
        break;
      }
      cum += c[j];
    }
  }
  const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
  *above = __shfl_sync(FULL, cum, src);
  *count = __shfl_sync(FULL, cnt, src);
  return __shfl_sync(FULL, d, src);
}

// One radix digit (pass 0: bits 63..56) of the k-th largest key of each
// query's row of scores (nq, S); grid (blocks per query, nq).
__global__ void __launch_bounds__(THREADS)
    vec_radix(const float* __restrict__ scores, long long S, int k, int pass,
              unsigned* __restrict__ hist, unsigned* __restrict__ state) {
  __shared__ unsigned h[256];
  __shared__ int s_last;
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  unsigned* st = state + (long long)b * STATE_WORDS;
  unsigned long long prefix = 0;
  unsigned krem = (unsigned)k;
  if (pass > 0) {
    if (st[ST_RESOLVED]) return;
    prefix = load_prefix(st);
    krem = st[ST_KREM];
  }
  const int shift = 56 - 8 * pass;
  const unsigned long long hi = pass ? (~0ull << (64 - 8 * pass)) : 0ull;
  for (int t = threadIdx.x; t < 256; t += THREADS) h[t] = 0;
  __syncthreads();
  const float* sb = scores + (long long)b * S;
  for (long long base = (long long)blockIdx.x * THREADS; base < S;
       base += (long long)gridDim.x * THREADS) {
    const long long i = base + threadIdx.x;
    unsigned d = 0;
    bool in = false;
    if (i < S) {
      const unsigned long long key = make_key(sb[i], i);
      in = (key & hi) == prefix;
      d = (unsigned)(key >> shift) & 255u;
    }
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
      const unsigned peers = __match_any_sync(act, d);
      if (__ffs(peers) - 1 == lane) atomicAdd(&h[d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  unsigned* hb = hist + ((long long)b * PASSES + pass) * 256;
  for (int t = threadIdx.x; t < 256; t += THREADS) {
    if (h[t]) atomicAdd(&hb[t], h[t]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&st[ST_DONE + pass], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x < 32) {
    __threadfence();
    unsigned cum, c;
    const int d =
        pick_digit([&](int i) { return __ldcg(&hb[i]); }, krem, &cum, &c);
    if (threadIdx.x == 0) {
      krem -= cum;
      prefix |= (unsigned long long)d << shift;
      st[ST_PREFIX] = (unsigned)prefix;
      st[ST_PREFIX + 1] = (unsigned)(prefix >> 32);
      st[ST_KREM] = krem;
      // the bucket is taken whole: every key at or above the prefix (with
      // its lower bits 0) is in the top k, and there are exactly k of them
      st[ST_RESOLVED] = c == krem;
    }
  }
}

// Writes the k keys at or above the threshold into cand (nq, k2), in any
// order (warp-aggregated slots).
__global__ void __launch_bounds__(THREADS)
    vec_emit(const float* __restrict__ scores, long long S, int k2,
             unsigned* __restrict__ state,
             unsigned long long* __restrict__ cand) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  unsigned* st = state + (long long)b * STATE_WORDS;
  const unsigned long long thr = load_prefix(st);
  const float* sb = scores + (long long)b * S;
  unsigned long long* cb = cand + (long long)b * k2;
  for (long long base = (long long)blockIdx.x * THREADS; base < S;
       base += (long long)gridDim.x * THREADS) {
    const long long i = base + threadIdx.x;
    unsigned long long key = 0;
    bool take = false;
    if (i < S) {
      key = make_key(sb[i], i);
      take = key >= thr;
    }
    const unsigned act = __ballot_sync(FULL, take);
    if (act == 0) continue;
    const int leader = __ffs(act) - 1;
    unsigned slot = 0;
    if (lane == leader) slot = atomicAdd(&st[ST_OUT], (unsigned)__popc(act));
    slot = __shfl_sync(FULL, slot, leader);
    if (take) {
      slot += __popc(act & ((1u << lane) - 1u));
      if (slot < (unsigned)k2) cb[slot] = key;
    }
  }
}

// Bitonic network, descending overall: the pair (i, i ^ j) of sequence size
// s is ordered descending when bit s of the global index i is 0.
__device__ __forceinline__ void cmp_swap(unsigned long long* x, int i, int l,
                                         long long gi, long long s) {
  const unsigned long long a = x[i], b = x[l];
  const bool desc = (gi & s) == 0;
  if (desc ? a < b : a > b) {
    x[i] = b;
    x[l] = a;
  }
}

// Sorts (full = 1) or merges at size s the chunk of C keys of each block in
// shared memory: sizes 2..C, or strides C/2..1 of size s. The full pass
// reads the k keys vec_emit wrote and pads positions k..k2 with 0, below
// every key.
__global__ void __launch_bounds__(SORT_THREADS)
    vec_sort_chunk(unsigned long long* __restrict__ cand, int k, int k2,
                   int C, int full, long long s_merge) {
  __shared__ unsigned long long x[SORT_CHUNK];
  const long long off = (long long)blockIdx.y * k2 + (long long)blockIdx.x * C;
  const long long g0 = (long long)blockIdx.x * C;
  for (int t = threadIdx.x; t < C; t += SORT_THREADS) {
    x[t] = (!full || g0 + t < k) ? cand[off + t] : 0ull;
  }
  __syncthreads();
  for (long long s = full ? 2 : s_merge; s <= (full ? C : s_merge); s <<= 1) {
    for (int j = (int)((full ? s : C) >> 1); j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < C / 2; t += SORT_THREADS) {
        const int i = (t / j) * 2 * j + (t % j);
        cmp_swap(x, i, i + j, g0 + i, s);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < C; t += SORT_THREADS) cand[off + t] = x[t];
}

// One global stride j of bitonic size s, over every pair of every query.
__global__ void __launch_bounds__(THREADS)
    vec_sort_step(unsigned long long* __restrict__ cand, int k2, long long s,
                  int j) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= k2 / 2) return;
  const long long i = (t / j) * 2 * j + (t % j);
  cmp_swap(cand + (long long)blockIdx.y * k2, (int)i, (int)(i + j), i, s);
}

// One result from a key; with a page table, the position (slot j * P + r
// of query b's probe) becomes the document pages[page_idx[j], r].
__device__ __forceinline__ void unpack_one(
    unsigned long long key, long long b, long long t, float* vals, int* idx,
    const int* pages, const int* page_idx, int P, int max_pages) {
  const unsigned pos = 0xffffffffu - (unsigned)key;
  vals[t] = key_score(key);
  if (pages == nullptr) {
    idx[t] = (int)pos;
  } else {
    const int page = page_idx[b * max_pages + pos / P];
    idx[t] = pages[(long long)page * P + pos % P];
  }
}

// vals, idx (nq, k) from the sorted keys.
__global__ void __launch_bounds__(THREADS)
    vec_unpack(const unsigned long long* __restrict__ cand, int k2, int k,
               int nq, float* __restrict__ vals, int* __restrict__ idx,
               const int* __restrict__ pages,
               const int* __restrict__ page_idx, int P, int max_pages) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)nq * k) return;
  const long long b = t / k;
  unpack_one(cand[b * k2 + t % k], b, t, vals, idx, pages, page_idx, P,
             max_pages);
}

// The threshold of a block's own select: the k-th largest of the S keys
// get(i), 8 bits at a time with the histogram in shared memory, stopping
// as soon as the chosen bucket is taken whole. Every thread returns it.
template <int NT, typename GetKey>
__device__ unsigned long long block_threshold(GetKey get, long long S, int k,
                                              unsigned* h) {
  __shared__ unsigned long long s_prefix;
  __shared__ unsigned s_krem, s_resolved;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_prefix = 0;
    s_krem = (unsigned)k;
    s_resolved = 0;
  }
  __syncthreads();
  for (int pass = 0; pass < PASSES && !s_resolved; ++pass) {
    const unsigned long long prefix = s_prefix;
    const int shift = 56 - 8 * pass;
    const unsigned long long hi = pass ? (~0ull << (64 - 8 * pass)) : 0ull;
    for (int t = threadIdx.x; t < 256; t += NT) h[t] = 0;
    __syncthreads();
    for (long long base = 0; base < S; base += NT) {
      const long long i = base + threadIdx.x;
      unsigned d = 0;
      bool in = false;
      if (i < S) {
        const unsigned long long key = get(i);
        in = (key & hi) == prefix;
        d = (unsigned)(key >> shift) & 255u;
      }
      const unsigned act = __ballot_sync(FULL, in);
      if (in) {
        const unsigned peers = __match_any_sync(act, d);
        if (__ffs(peers) - 1 == lane) atomicAdd(&h[d], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const unsigned krem = s_krem;
      unsigned cum, c;
      const int d = pick_digit([&](int i) { return h[i]; }, krem, &cum, &c);
      if (threadIdx.x == 0) {
        s_krem = krem - cum;
        s_prefix = prefix | ((unsigned long long)d << shift);
        s_resolved = c == krem - cum;
      }
    }
    __syncthreads();
  }
  return s_prefix;
}

// Writes the keys get(i) >= thr (exactly k of them) to out[0..k), in any
// order; count is a zeroed shared counter.
template <int NT, typename GetKey>
__device__ void block_emit(GetKey get, long long S, unsigned long long thr,
                           unsigned long long* out, int k, unsigned* count) {
  const int lane = threadIdx.x & 31;
  for (long long base = 0; base < S; base += NT) {
    const long long i = base + threadIdx.x;
    unsigned long long key = 0;
    bool take = false;
    if (i < S) {
      key = get(i);
      take = key >= thr;
    }
    const unsigned act = __ballot_sync(FULL, take);
    if (act == 0) continue;
    const int leader = __ffs(act) - 1;
    unsigned slot = 0;
    if (lane == leader) slot = atomicAdd(count, (unsigned)__popc(act));
    slot = __shfl_sync(FULL, slot, leader);
    if (take) {
      slot += __popc(act & ((1u << lane) - 1u));
      if (slot < (unsigned)k) out[slot] = key;
    }
  }
}

// Sorts x[0..n) descending in shared memory (n a power of two).
template <int NT>
__device__ void block_sort(unsigned long long* x, int n) {
  for (int s = 2; s <= n; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += NT) {
        const int i = (t / j) * 2 * j + (t % j);
        cmp_swap(x, i, i + j, i, s);
      }
      __syncthreads();
    }
  }
}

// The whole select of one query in one block, for rows of at most
// BLOCK_SELECT_MAX_S keys and k2 <= SORT_CHUNK: the threshold, the k keys
// at or above it and their sort in shared memory, in one launch. The row
// (of S entries, the first counts[2 b] of them with counts) is float scores
// (keys made from score and position) or, with KEYS, 64-bit keys: the
// candidates of vec_select_cand (0 pads below every key) or of the fused
// scan.
template <bool KEYS>
__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_select_block(const void* __restrict__ in, long long S,
                     const unsigned long long* __restrict__ counts, int k,
                     int k2, float* __restrict__ vals, int* __restrict__ idx,
                     const int* __restrict__ pages,
                     const int* __restrict__ page_idx, int P,
                     int max_pages) {
  __shared__ unsigned h[256];
  __shared__ unsigned long long x[SORT_CHUNK];
  __shared__ unsigned s_count;
  const int b = blockIdx.x;
  const float* sb = static_cast<const float*>(in) + (long long)b * S;
  const unsigned long long* kb =
      static_cast<const unsigned long long*>(in) + (long long)b * S;
  const long long n = counts != nullptr ? (long long)counts[2 * b] : S;
  auto get = [&](long long i) {
    return KEYS ? kb[i] : make_key(sb[i], i);
  };
  if (threadIdx.x == 0) s_count = 0;
  const unsigned long long thr =
      block_threshold<BLOCK_THREADS>(get, n, k, h);
  block_emit<BLOCK_THREADS>(get, n, thr, x, k2, &s_count);
  __syncthreads();
  for (int t = k + threadIdx.x; t < k2; t += BLOCK_THREADS) x[t] = 0ull;
  __syncthreads();
  block_sort<BLOCK_THREADS>(x, k2);
  for (int t = threadIdx.x; t < k; t += BLOCK_THREADS) {
    unpack_one(x[t], b, (long long)b * k + t, vals, idx, pages, page_idx, P,
               max_pages);
  }
}

// First half of the two-phase select of long rows with small k: block
// (c, b) takes chunk c of CAND_CHUNK scores of query b into shared memory
// and writes its own top k keys (all of them, 0-padded, if it holds fewer)
// to cand[b][c * k2 ..). Every key of the row's top k is in its chunk's
// top k, so vec_select_block<true> over the candidates finishes the select
// with the same result.
__global__ void __launch_bounds__(CAND_THREADS)
    vec_select_cand(const float* __restrict__ scores, long long S, int k,
                    int k2, unsigned long long* __restrict__ cand) {
  __shared__ unsigned h[256];
  __shared__ unsigned long long x[CAND_CHUNK];
  __shared__ unsigned s_count;
  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * CAND_CHUNK;
  const long long n = S - c0 < CAND_CHUNK ? S - c0 : CAND_CHUNK;
  const float* sb = scores + (long long)b * S + c0;
  for (int t = threadIdx.x; t < n; t += CAND_THREADS) {
    x[t] = make_key(sb[t], c0 + t);
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  unsigned long long* out =
      cand + ((long long)b * gridDim.x + blockIdx.x) * k2;
  const int kk = n < k ? (int)n : k;
  auto get = [&](long long i) { return x[i]; };
  const unsigned long long thr =
      block_threshold<CAND_THREADS>(get, n, kk, h);
  block_emit<CAND_THREADS>(get, n, thr, out, kk, &s_count);
  for (int t = kk + threadIdx.x; t < k2; t += CAND_THREADS) out[t] = 0ull;
}

// ---------------------------------------------------------------------------
// scoring tiles
// ---------------------------------------------------------------------------

// The thread tile of a launch of NQ query slots: QG query groups x RG row
// groups per warp; a thread holds RT rows (rg + RG i) x QT queries (qg + QG
// j); a warp covers 32 rows, a block TILE_ROWS.
template <int NQ>
struct Cfg {
  static constexpr int QG = NQ >= 4 ? 4 : NQ;
  static constexpr int QT = NQ / QG;
  static constexpr int RG = 32 / QG;
  static constexpr int RT = QG;
  static_assert(RG * RT == 32 && QG * QT == NQ, "thread tile");
};
static_assert(TILE_THREADS == TILE_ROWS, "a thread per tile row");
static_assert(TILE_WARPS * 32 == TILE_ROWS, "a warp per 32 rows");

// The fused top-k's two sizes: k2 <= KSMALL keeps 192 keys a query, larger
// k2 (up to KCAP) 384, so that a buffer cut to k keys still takes one tile
// of appends. At 16 queries a block holds 2 stages, so that three small
// (or two big) blocks fit an SM.
template <bool BIG>
struct Topk {
  static constexpr int BUFN = BIG ? 384 : 192;
  static constexpr int BLOCKS = BIG ? BLOCKS_PER_SM : SMALL_BLOCKS_PER_SM;
  static_assert(BUFN - TILE_ROWS >= (BIG ? KCAP : KSMALL), "headroom");
  template <int NQ>
  __host__ __device__ static constexpr int stages() {
    return NQ == 16 ? 2 : STAGES;
  }
};

// The dynamic shared memory of a scoring block: the stages, the rows of
// the tiles in the ring, their squared norms and the queries' shared
// thresholds as the tiles started, |q|^2, and for the fused top-k the
// candidate buffers, thresholds, histograms and counts.
template <int NQ, int ST = STAGES, int BUFN = 256>
struct Smem {
  static constexpr int STAGE_FLOATS = (TILE_ROWS + NQ) * SP;
  static constexpr size_t STAGE_B = (size_t)ST * STAGE_FLOATS * 4;
  static constexpr size_t RID_B = (size_t)ST * TILE_ROWS * 8;
  static constexpr size_t GTS_B = (size_t)ST * NQ * 16;
  static constexpr size_t RSQ_B = (size_t)ST * TILE_ROWS * 4;
  static constexpr size_t QSQ_B = 16 * 4;
  static constexpr size_t BUF_B = (size_t)NQ * BUFN * 8;
  static constexpr size_t THR_B = (size_t)NQ * 8;
  static constexpr size_t HIST_B = (size_t)TILE_WARPS * 256 * 4;
  static constexpr size_t CNT_B = (size_t)NQ * 4;
  static constexpr size_t scan_bytes = STAGE_B + RID_B + GTS_B + RSQ_B + QSQ_B;
  static constexpr size_t topk_bytes =
      scan_bytes + BUF_B + THR_B + HIST_B + CNT_B;

  float* stages;
  long long* rid;
  unsigned long long* gts;
  float* rsq;
  float* qsq;
  unsigned long long* buf;
  unsigned long long* thr;
  unsigned* hist;
  unsigned* cnt;
  __device__ explicit Smem(unsigned char* p) {
    stages = reinterpret_cast<float*>(p);
    p += STAGE_B;
    rid = reinterpret_cast<long long*>(p);
    p += RID_B;
    gts = reinterpret_cast<unsigned long long*>(p);
    p += GTS_B;
    rsq = reinterpret_cast<float*>(p);
    p += RSQ_B;
    qsq = reinterpret_cast<float*>(p);
    p += QSQ_B;
    buf = reinterpret_cast<unsigned long long*>(p);
    p += BUF_B;
    thr = reinterpret_cast<unsigned long long*>(p);
    p += THR_B;
    hist = reinterpret_cast<unsigned*>(p);
    p += HIST_B;
    cnt = reinterpret_cast<unsigned*>(p);
  }
};

// The rows of a flat scan: position p is matrix row p, for p < n.
struct FlatRows {
  const float* data;
  const float* sq;
  long long n;
  int dim;
  __device__ long long row_of(long long p) const { return p < n ? p : NO_KEY; }
};

// The rows of one query's IVF probe: position p = j P + r is row r of the
// page in slot j. Sentinel documents and the pad page are NO_READ.
struct PageRows {
  const float* data;
  const float* sq;
  const int* pages;
  const int* pidx;  // this query's page slots
  long long S;      // max_pages * P
  int P, n_pages, n_docs, dim;
  __device__ long long row_of(long long p) const {
    if (p >= S) return NO_KEY;
    const unsigned j = (unsigned)p / P, r = (unsigned)p % P;  // S < 2^32
    const int page = __ldg(&pidx[j]);
    if (page == n_pages) return NO_READ;
    const long long row = (long long)page * P + r;
    return __ldg(&pages[row]) == n_docs ? NO_READ : row;
  }
};

// Issues the 4-byte copies of one stage: k-slice [d0, d0 + KS) of the
// tile's rows (rid) and of the nq queries, zero-filled past dim, past the
// rows, for NO_READ rows and for query slots past nq.
template <int NQ, class Rows>
__device__ __forceinline__ void fill_stage(float* st, const long long* rid,
                                           const Rows& R,
                                           const float* __restrict__ Q,
                                           int nq, int d0) {
  constexpr int UNITS = (TILE_ROWS + NQ) * KS;
#pragma unroll 4
  for (int u = threadIdx.x; u < UNITS; u += TILE_THREADS) {
    const int lr = u / KS, c = u % KS;
    const int d = d0 + c;
    const float* src = R.data;
    bool ok = d < R.dim;
    if (lr < TILE_ROWS) {
      const long long row = rid[lr];
      ok = ok && row >= 0;
      if (ok) src = R.data + row * R.dim + d;
    } else {
      ok = ok && lr - TILE_ROWS < nq;
      if (ok) src = Q + (long long)(lr - TILE_ROWS) * R.dim + d;
    }
    cp_async4(st + lr * SP + c, src, ok);
  }
}

// The 16-byte copies of a thread: units tid + TILE_THREADS i of a stage,
// all in column 4 (tid % 8) of rows tid / 8 + 16 i (tile rows, then the
// query rows). Their sources are found once a tile (set) and offset by
// the k-slice (fill).
template <int NQ>
struct VecUnits {
  static constexpr int UNITS = (TILE_ROWS + NQ) * (KS / 4);
  static constexpr int PER = (UNITS + TILE_THREADS - 1) / TILE_THREADS;
  static_assert(TILE_THREADS % (KS / 4) == 0, "a fixed column a thread");
  const float* src[PER];
  unsigned ok;  // bit i: unit i has a source row
  template <class Rows>
  __device__ __forceinline__ void set(const long long* rid, const Rows& R,
                                      const float* __restrict__ Q, int nq) {
    const int c = threadIdx.x % (KS / 4);
    ok = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int lr = threadIdx.x / (KS / 4) + (TILE_THREADS / (KS / 4)) * i;
      long long row = -1;
      const float* base = Q;
      if (lr < TILE_ROWS) {
        row = rid[lr];
        base = R.data;
      } else if (lr - TILE_ROWS < nq) {
        row = lr - TILE_ROWS;
      }
      src[i] = row >= 0 ? base + row * R.dim + 4 * c : R.data;
      if (row >= 0 && threadIdx.x + TILE_THREADS * i < UNITS) ok |= 1u << i;
    }
  }
  __device__ __forceinline__ void fill(float* st, int d0, int dim) const {
    const int c = threadIdx.x % (KS / 4);
    const bool in_dim = d0 + 4 * c < dim;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (threadIdx.x + TILE_THREADS * i < UNITS) {
        const int lr = threadIdx.x / (KS / 4) + (TILE_THREADS / (KS / 4)) * i;
        const bool has = in_dim && ((ok >> i) & 1u);
        cp_async16(st + lr * SP + 4 * c, has ? src[i] + d0 : src[i], has);
      }
    }
  }
};

// Adds one k-slice of the stage to the thread's dot products, 4 dims at a
// time, each (row, query) chain in dim order.
template <int NQ>
__device__ __forceinline__ void score_stage(
    const float* st, float (&acc)[Cfg<NQ>::RT][Cfg<NQ>::QT]) {
  typedef Cfg<NQ> C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* rows = st + (warp * 32 + lane % C::RG) * SP;
  const float* qs = st + (TILE_ROWS + lane / C::RG) * SP;
#pragma unroll
  for (int c = 0; c < KS; c += 4) {
    float4 m[C::RT], q[C::QT];
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
      m[i] = *reinterpret_cast<const float4*>(rows + i * C::RG * SP + c);
#pragma unroll
    for (int j = 0; j < C::QT; ++j)
      q[j] = *reinterpret_cast<const float4*>(qs + j * C::QG * SP + c);
    // dim c, c + 1, c + 2, c + 3 in turn, each over every (row, query): the
    // tile's independent chains interleave
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::QT; ++j) acc[i][j] = fmaf(m[i].x, q[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::QT; ++j) acc[i][j] = fmaf(m[i].y, q[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::QT; ++j) acc[i][j] = fmaf(m[i].z, q[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < C::RT; ++i)
#pragma unroll
      for (int j = 0; j < C::QT; ++j) acc[i][j] = fmaf(m[i].w, q[j].w, acc[i][j]);
  }
}

// The scoring loop of a block: nt tiles, t0, t0 + step, ..., through the
// ring of stages; epi(p0, rs, acc) after each tile's last k-slice, with p0
// the tile's first position and rs its slot in the ring of the tiles' rows
// (sm.rid), their squared norms (sm.rsq, copied beside the first slice for
// the l2 modes) and, with gthr, the queries' shared thresholds as the tile
// started (sm.gts, from gthr: 16 bytes a query). sm.qsq[q] is |q|^2 of
// query slot q for MODE_L2: the documents' chain over the staged query
// slices of the block's first tile. Every thread of the block calls it
// with the same arguments.
template <int NQ, bool VEC, int ST, int BUFN, class Rows, class Epi>
__device__ __forceinline__ void scan(const Rows& R,
                                     const float* __restrict__ Q, int nq,
                                     int mode, const unsigned long long* gthr,
                                     long long t0, long long nt,
                                     long long step,
                                     const Smem<NQ, ST, BUFN>& sm, Epi epi) {
  typedef Cfg<NQ> C;
  constexpr int STAGE_FLOATS = Smem<NQ, ST, BUFN>::STAGE_FLOATS;
  const int nks = (R.dim + KS - 1) / KS;
  const long long total = nt * nks;
  // the stage being filled and the stage being scored: k-slice, tile of
  // the block, ring slot of the stage and of the tile's rows (no 64-bit
  // divisions in the loop)
  struct Cursor {
    int ks, slot, rslot;
    long long lt;
  };
  Cursor f{0, 0, 0, 0}, c{0, 0, 0, 0};
  VecUnits<NQ> vu;
  auto advance = [&](Cursor& u) {
    u.slot = u.slot + 1 == ST ? 0 : u.slot + 1;
    if (++u.ks == nks) {
      u.ks = 0;
      ++u.lt;
      u.rslot = u.rslot + 1 == ST ? 0 : u.rslot + 1;
    }
  };
  auto fill = [&]() {
    long long* rr = sm.rid + f.rslot * TILE_ROWS;
    if (f.ks == 0) {  // block-uniform
      const long long row =
          R.row_of((t0 + f.lt * step) * TILE_ROWS + threadIdx.x);
      rr[threadIdx.x] = row;
      cp_async4(sm.rsq + f.rslot * TILE_ROWS + threadIdx.x,
                row >= 0 ? R.sq + row : R.sq, row >= 0 && mode != MODE_DOT);
      if (gthr != nullptr && threadIdx.x < NQ) {
        cp_async16(reinterpret_cast<float*>(sm.gts +
                                            (f.rslot * NQ + threadIdx.x) * 2),
                   reinterpret_cast<const float*>(gthr + 2 * threadIdx.x),
                   (int)threadIdx.x < nq);
      }
      __syncthreads();
      if (VEC) vu.set(rr, R, Q, nq);
    }
    if (VEC) {
      vu.fill(sm.stages + f.slot * STAGE_FLOATS, f.ks * KS, R.dim);
    } else {
      fill_stage<NQ>(sm.stages + f.slot * STAGE_FLOATS, rr, R, Q, nq,
                     f.ks * KS);
    }
    advance(f);
  };
  float acc[C::RT][C::QT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int j = 0; j < C::QT; ++j) acc[i][j] = 0.f;
  float qacc = 0.f;  // |q|^2 of query slot threadIdx.x < NQ
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < total) fill();
    cp_async_commit();
  }
  for (long long it = 0; it < total; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage it is in; stage it - 1 is free
    if (it + ST - 1 < total) fill();
    cp_async_commit();
    const float* st = sm.stages + c.slot * STAGE_FLOATS;
    score_stage<NQ>(st, acc);
    if (c.lt == 0 && mode == MODE_L2 && threadIdx.x < NQ) {
      const float* qr = st + (TILE_ROWS + threadIdx.x) * SP;
#pragma unroll
      for (int d = 0; d < KS; ++d) qacc = fmaf(qr[d], qr[d], qacc);
    }
    if (c.ks == nks - 1) {
      if (c.lt == 0) {  // block-uniform
        if (threadIdx.x < NQ) sm.qsq[threadIdx.x] = qacc;
        __syncthreads();
      }
      epi((t0 + c.lt * step) * TILE_ROWS, c.rslot, acc);
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int j = 0; j < C::QT; ++j) acc[i][j] = 0.f;
    }
    advance(c);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Writes the thread's scores of a tile: out[q * stride + p].
template <int NQ, class S>
__device__ __forceinline__ void write_scores(
    const S& sm, int nq, int mode, float* out, long long stride, long long p0,
    int rs, const float (&acc)[Cfg<NQ>::RT][Cfg<NQ>::QT]) {
  typedef Cfg<NQ> C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int lr = warp * 32 + lane % C::RG + i * C::RG;
    const long long row = sm.rid[rs * TILE_ROWS + lr];
    if (row == NO_KEY) continue;
    const float sq = sm.rsq[rs * TILE_ROWS + lr];
#pragma unroll
    for (int j = 0; j < C::QT; ++j) {
      const int q = lane / C::RG + j * C::QG;
      if (q < nq) {
        out[q * stride + p0 + lr] =
            row < 0 ? -INFINITY : finish(acc[i][j], mode, sq, sm.qsq[q]);
      }
    }
  }
}

// Keeps the k largest of the *cnt keys of buf (k <= *cnt <= BUFN) in
// buf[0..k), in any order, and sets *thr to a key t with every kept key
// >= t and every other < t: a radix select by one warp, the keys in
// registers, h its 256-word histogram. t is published to the query's
// shared threshold *gthr (a raise only), if there is one.
template <int BUFN>
__device__ void keep_top(unsigned long long* buf, unsigned* cnt,
                         unsigned long long* thr, int k, unsigned* h,
                         unsigned long long* gthr) {
  const int lane = threadIdx.x & 31;
  const int c = (int)*cnt;
  unsigned long long x[BUFN / 32];
#pragma unroll
  for (int i = 0; i < BUFN / 32; ++i)
    x[i] = lane + 32 * i < c ? buf[lane + 32 * i] : 0ull;
  unsigned long long prefix = 0;
  unsigned krem = (unsigned)k;
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = 56 - 8 * pass;
    const unsigned long long hi = pass ? (~0ull << (64 - 8 * pass)) : 0ull;
    for (int t = lane; t < 256; t += 32) h[t] = 0;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < BUFN / 32; ++i) {
      const bool in = lane + 32 * i < c && (x[i] & hi) == prefix;
      const unsigned d = (unsigned)(x[i] >> shift) & 255u;
      const unsigned act = __ballot_sync(FULL, in);
      if (in) {  // one increment per digit among the lanes
        const unsigned peers = __match_any_sync(act, d);
        if (__ffs(peers) - 1 == lane) atomicAdd(&h[d], (unsigned)__popc(peers));
      }
    }
    __syncwarp();
    unsigned above, count;
    const int d = pick_digit([&](int t) { return h[t]; }, krem, &above,
                             &count);
    krem -= above;
    prefix |= (unsigned long long)d << shift;
    __syncwarp();
    if (count == krem) break;  // the bucket is taken whole
  }
  unsigned base = 0;
#pragma unroll
  for (int i = 0; i < BUFN / 32; ++i) {
    const bool take = lane + 32 * i < c && x[i] >= prefix;
    const unsigned m = __ballot_sync(FULL, take);
    if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = x[i];
    base += __popc(m);
  }
  __syncwarp();
  if (lane == 0) {
    *thr = prefix;
    *cnt = (unsigned)k;
    if (gthr != nullptr) atomicMax(gthr, prefix);
  }
  __syncwarp();
}

template <int NQ, int ST, int BUFN>
__device__ __forceinline__ void init_topk(const Smem<NQ, ST, BUFN>& sm) {
  if (threadIdx.x < NQ) {
    sm.thr[threadIdx.x] = 0ull;  // below every key
    sm.cnt[threadIdx.x] = 0u;
  }
}

// The fused top-k after a tile: the thread's keys above their query's
// threshold (the block's own, or the shared one if higher) go to its
// buffer; then each buffer that the next tile could overflow is cut to its
// top k. A key at or below a threshold is below k keys of the search, so
// no key of the top k is dropped.
template <int NQ, int ST, int BUFN>
__device__ __forceinline__ void append_keys(
    const Smem<NQ, ST, BUFN>& sm, int nq, int mode, int k, long long p0,
    int rs, unsigned long long* gthr,
    const float (&acc)[Cfg<NQ>::RT][Cfg<NQ>::QT]) {
  typedef Cfg<NQ> C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the thread's keys and whether each beats its query's thresholds, all
  // computed before the (rare) appends
  unsigned long long key[C::RT][C::QT];
  unsigned takes = 0;
  unsigned long long lim[C::QT];
#pragma unroll
  for (int j = 0; j < C::QT; ++j) {
    const int q = lane / C::RG + j * C::QG;
    const unsigned long long g = sm.gts[(rs * NQ + q) * 2];
    const unsigned long long t = sm.thr[q];
    lim[j] = g > t ? g : t;
  }
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int lr = warp * 32 + lane % C::RG + i * C::RG;
    const long long row = sm.rid[rs * TILE_ROWS + lr];
    const float sq = sm.rsq[rs * TILE_ROWS + lr];
#pragma unroll
    for (int j = 0; j < C::QT; ++j) {
      const int q = lane / C::RG + j * C::QG;
      const float s =
          row < 0 ? -INFINITY : finish(acc[i][j], mode, sq, sm.qsq[q]);
      key[i][j] = make_key(s, p0 + lr);
      if (row != NO_KEY && q < nq && key[i][j] > lim[j])
        takes |= 1u << (i * C::QT + j);
    }
  }
  if (__any_sync(FULL, takes != 0)) {
#pragma unroll
    for (int i = 0; i < C::RT; ++i) {
#pragma unroll
      for (int j = 0; j < C::QT; ++j) {
        const bool take = (takes >> (i * C::QT + j)) & 1u;
        if (__ballot_sync(FULL, take) == 0) continue;
        // one atomic per query among the warp's lanes that take a key
        const int q = lane / C::RG + j * C::QG;
        const unsigned peers = __match_any_sync(FULL, take ? q : -1);
        if (take) {
          const int leader = __ffs(peers) - 1;
          unsigned base = 0;
          if (lane == leader) base = atomicAdd(&sm.cnt[q], __popc(peers));
          base = __shfl_sync(peers, base, leader);
          sm.buf[q * BUFN + base + __popc(peers & ((1u << lane) - 1u))] =
              key[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int q = warp; q < nq; q += TILE_WARPS) {
    if (sm.cnt[q] > BUFN - TILE_ROWS) {
      keep_top<BUFN>(sm.buf + q * BUFN, &sm.cnt[q], &sm.thr[q], k,
                     sm.hist + warp * 256, gthr + 2 * q);
    }
  }
}

// The block's candidate keys of each query (cut to its top k if it holds
// more) that are not below the query's shared threshold
// gthr[2 q] (no key of the search's top k is), appended to out[q *
// qstride ..] at the count gthr[2 q + 1].
template <int NQ, int ST, int BUFN>
__device__ __forceinline__ void flush_topk(const Smem<NQ, ST, BUFN>& sm,
                                           int nq, int k,
                                           unsigned long long* gthr,
                                           unsigned long long* out,
                                           long long qstride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < nq; q += TILE_WARPS) {
    unsigned c = sm.cnt[q];
    if (c > (unsigned)k) {
      keep_top<BUFN>(sm.buf + q * BUFN, &sm.cnt[q], &sm.thr[q], k,
                     sm.hist + warp * 256, gthr + 2 * q);
      c = (unsigned)k;
    }
    const unsigned long long g = __ldcg(gthr + 2 * q);
    for (unsigned t0 = 0; t0 < c; t0 += 32) {
      const unsigned t = t0 + lane;
      const unsigned long long key = t < c ? sm.buf[q * BUFN + t] : 0ull;
      const bool keep = t < c && key >= g;
      const unsigned m = __ballot_sync(FULL, keep);
      unsigned long long base = 0;
      if (lane == 0 && m) base = atomicAdd(gthr + 2 * q + 1, __popc(m));
      base = __shfl_sync(FULL, base, 0);
      if (keep) out[q * qstride + base + __popc(m & ((1u << lane) - 1u))] = key;
    }
  }
}

static __device__ __forceinline__ long long flat_tiles(long long n) {
  return (n + TILE_ROWS - 1) / TILE_ROWS;
}

// out[q * out_stride + r] = score of matrix row r (r < n) against query q,
// for the nq <= NQ queries of this launch; a persistent grid.
template <int NQ, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM)
    vec_flat_scores(const float* __restrict__ M, long long n, int dim,
                    const float* __restrict__ row_sq,
                    const float* __restrict__ Q, int nq, int mode,
                    float* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<NQ> sm(smem_raw);
  const FlatRows R{M, row_sq, n, dim};
  const long long tiles = flat_tiles(n);
  const long long nt = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  scan<NQ, VEC>(R, Q, nq, mode, nullptr, blockIdx.x, nt, gridDim.x, sm,
                [&](long long p0, int rs,
                    const float(&acc)[Cfg<NQ>::RT][Cfg<NQ>::QT]) {
                  write_scores<NQ>(sm, nq, mode, out, out_stride, p0, rs,
                                   acc);
                });
}

// The flat scan with the fused top-k: each block appends its candidate
// keys of query q to cand[q * gridDim.x * BUFN ..]; gthr (16 bytes a query,
// zeroed before the launch) holds the queries' shared thresholds and the
// counts of their appended keys.
template <int NQ, bool VEC, bool BIG>
__global__ void __launch_bounds__(TILE_THREADS, Topk<BIG>::BLOCKS)
    vec_flat_topk(const float* __restrict__ M, long long n, int dim,
                  const float* __restrict__ row_sq,
                  const float* __restrict__ Q, int nq, int mode, int k,
                  int k2, unsigned long long* gthr,
                  unsigned long long* __restrict__ cand) {
  typedef Topk<BIG> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<NQ, T::template stages<NQ>(), T::BUFN> sm(smem_raw);
  const FlatRows R{M, row_sq, n, dim};
  const long long tiles = flat_tiles(n);
  const long long nt = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  init_topk(sm);
  scan<NQ, VEC>(R, Q, nq, mode, gthr, blockIdx.x, nt, gridDim.x, sm,
                [&](long long p0, int rs,
                    const float(&acc)[Cfg<NQ>::RT][Cfg<NQ>::QT]) {
                  append_keys(sm, nq, mode, k, p0, rs, gthr, acc);
                });
  flush_topk(sm, nq, k, gthr, cand, (long long)gridDim.x * T::BUFN);
}

// The ragged page-run expansion of one query's nprobe lists (in their
// order) into max_pages page slots: slot j takes page pageptr[l] + j -
// (pages of the lists before l) of the list l whose run holds j, or the pad
// page n_pages past the ragged total. Lists go TILE_THREADS at a time: a
// block-wide scan of their page counts, then a binary search per slot in
// the chunk's run. Called by every thread of the block.
__device__ void expand_pages(const int* lists, int nprobe,
                             const int* __restrict__ pageptr, int max_pages,
                             int n_pages, int* __restrict__ out) {
  __shared__ int s_cum[TILE_THREADS];
  __shared__ int s_start[TILE_THREADS];
  __shared__ int s_warp[TILE_WARPS];
  __shared__ int s_end;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // pages of the lists before the chunk
  for (int base = 0; base < nprobe && carry < max_pages;
       base += TILE_THREADS) {
    const int t = base + threadIdx.x;
    const int len = nprobe - base < TILE_THREADS ? nprobe - base
                                                 : TILE_THREADS;
    int c = 0, start = 0;
    if (t < nprobe) {
      const int l = lists[t];
      start = pageptr[l];
      c = pageptr[l + 1] - start;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int off = carry;
    for (int w = 0; w < warp; ++w) off += s_warp[w];
    s_cum[threadIdx.x] = off + incl - c;
    s_start[threadIdx.x] = start;
    if (threadIdx.x == TILE_THREADS - 1) s_end = off + incl;
    __syncthreads();
    const int end = s_end < max_pages ? s_end : max_pages;
    for (int j = carry + threadIdx.x; j < end; j += TILE_THREADS) {
      int lo = 0, hi = len - 1;  // the last list of the chunk starting <= j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_cum[mid] <= j) lo = mid; else hi = mid - 1;
      }
      out[j] = s_start[lo] + (j - s_cum[lo]);
    }
    carry = s_end;
    __syncthreads();  // before s_cum and s_warp are written again
  }
  for (int j = carry + threadIdx.x; j < max_pages; j += TILE_THREADS)
    out[j] = n_pages;
}

// Stage entry: page_idx (nq, max_pages) from given lists (nq, nprobe).
__global__ void __launch_bounds__(TILE_THREADS)
    vec_expand(const int* __restrict__ lists, int nprobe,
               const int* __restrict__ pageptr, int max_pages, int n_pages,
               int* __restrict__ page_idx) {
  const int b = blockIdx.x;
  expand_pages(lists + (long long)b * nprobe, nprobe, pageptr, max_pages,
               n_pages, page_idx + (long long)b * max_pages);
}

// One block per query: the centroid scores (scan, into shared memory, or
// cscores past PROBE_LISTS lists), their top nprobe (the block's radix
// select), the lists in rank order (in shared memory, or sel and lists past
// PROBE_SEL), and their page-run expansion into page_idx. Zeroes the
// query's ticket, shared threshold and key count of vec_ivf_topk.
template <bool VEC>
__global__ void __launch_bounds__(TILE_THREADS)
    vec_probe(const float* __restrict__ cents,
              const float* __restrict__ cent_sq, int n_lists, int dim,
              const float* __restrict__ Q, int mode, int nprobe,
              const int* __restrict__ pageptr, int max_pages, int n_pages,
              float* __restrict__ cscores, unsigned long long* __restrict__ sel,
              int* __restrict__ lists, int* __restrict__ page_idx,
              unsigned* __restrict__ tickets,
              unsigned long long* __restrict__ gthr) {
  typedef Smem<1, PROBE_STAGES> S;
  static_assert(PROBE_SEL * 12 <= S::STAGE_B, "chosen lists in the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned h[256];
  __shared__ unsigned s_count;
  const S sm(smem_raw);
  const int b = blockIdx.x;
  const float* q = Q + (long long)b * dim;
  float* cs = n_lists <= PROBE_LISTS
                  ? reinterpret_cast<float*>(smem_raw + S::scan_bytes)
                  : cscores + (long long)b * n_lists;
  if (threadIdx.x == 0) {
    tickets[b] = 0;
    gthr[2 * b] = 0ull;
    gthr[2 * b + 1] = 0ull;
    s_count = 0;
  }
  const FlatRows R{cents, cent_sq, n_lists, dim};
  scan<1, VEC>(R, q, 1, mode, nullptr, 0, flat_tiles(n_lists), 1, sm,
               [&](long long p0, int rs, const float(&acc)[1][1]) {
                 write_scores<1>(sm, 1, mode, cs, 0, p0, rs, acc);
               });
  auto get = [&](long long i) { return make_key(cs[i], i); };
  const unsigned long long thr =
      block_threshold<TILE_THREADS>(get, n_lists, nprobe, h);
  // the chosen keys and lists in the (now free) stages, or in sel, lists
  const bool small = nprobe <= PROBE_SEL;
  unsigned long long* sb =
      small ? reinterpret_cast<unsigned long long*>(sm.stages)
            : sel + (long long)b * nprobe;
  block_emit<TILE_THREADS>(get, n_lists, thr, sb, nprobe, &s_count);
  __syncthreads();
  int* lb = small ? reinterpret_cast<int*>(sb + nprobe)
                  : lists + (long long)b * nprobe;
  for (int t = threadIdx.x; t < nprobe; t += TILE_THREADS) {
    const unsigned long long key = sb[t];
    int rank = 0;
    for (int u = 0; u < nprobe; ++u) rank += sb[u] > key;
    lb[rank] = (int)(0xffffffffu - (unsigned)key);
  }
  __syncthreads();
  expand_pages(lb, nprobe, pageptr, max_pages, n_pages,
               page_idx + (long long)b * max_pages);
}

// Block (c, b) scans tiles [c T / nb, (c + 1) T / nb) of query b's probe
// of S = max_pages * P slots (T tiles).
struct PageSpan {
  long long t0, nt;
  __device__ PageSpan(long long S) {
    const long long T = (S + TILE_ROWS - 1) / TILE_ROWS;
    t0 = blockIdx.x * T / gridDim.x;
    nt = (blockIdx.x + 1) * T / gridDim.x - t0;
  }
};

// Stage entry and the IVF scores route: out (nq, max_pages * P), the
// scores of each query's probe (page_idx), -inf for sentinels.
template <bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM)
    vec_ivf_scores(const float* __restrict__ paged,
                   const float* __restrict__ paged_sq,
                   const int* __restrict__ pages,
                   const int* __restrict__ page_idx, int max_pages,
                   int n_pages, int P, int dim, int n_docs,
                   const float* __restrict__ Q, int mode,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<1> sm(smem_raw);
  const int b = blockIdx.y;
  const long long S = (long long)max_pages * P;
  const float* q = Q + (long long)b * dim;
  const PageRows R{paged, paged_sq, pages, page_idx + (long long)b * max_pages,
                   S, P, n_pages, n_docs, dim};
  const PageSpan span(S);
  float* ob = out + (long long)b * S;
  scan<1, VEC>(R, q, 1, mode, nullptr, span.t0, span.nt, 1, sm,
               [&](long long p0, int rs, const float(&acc)[1][1]) {
                 write_scores<1>(sm, 1, mode, ob, 0, p0, rs, acc);
               });
}

// The IVF probe's pages with the fused top-k: block (c, b) appends its
// candidate keys to cand[b nb BUFN ..] (counted at gthr[2 b + 1]); the last
// block of
// query b to finish merges them, sorts the top k and maps them to
// documents: vals, idx (nq, k). gthr and the tickets were zeroed by
// vec_probe.
template <bool VEC, bool BIG>
__global__ void __launch_bounds__(TILE_THREADS, BLOCKS_PER_SM)
    vec_ivf_topk(const float* __restrict__ paged,
                 const float* __restrict__ paged_sq,
                 const int* __restrict__ pages,
                 const int* __restrict__ page_idx, int max_pages, int n_pages,
                 int P, int dim, int n_docs, const float* __restrict__ Q,
                 int mode, int k, int k2, unsigned long long* gthr,
                 unsigned long long* cand, unsigned* tickets,
                 float* __restrict__ vals, int* __restrict__ idx) {
  typedef Topk<BIG> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long x[KCAP];
  __shared__ unsigned s_count;
  __shared__ int s_last;
  const Smem<1, T::template stages<1>(), T::BUFN> sm(smem_raw);
  const int b = blockIdx.y, nb = gridDim.x;
  const long long S = (long long)max_pages * P;
  const float* q = Q + (long long)b * dim;
  unsigned long long* gq = gthr + 2 * b;
  const PageRows R{paged, paged_sq, pages, page_idx + (long long)b * max_pages,
                   S, P, n_pages, n_docs, dim};
  const PageSpan span(S);
  init_topk(sm);
  scan<1, VEC>(R, q, 1, mode, gq, span.t0, span.nt, 1, sm,
               [&](long long p0, int rs, const float(&acc)[1][1]) {
                 append_keys(sm, 1, mode, k, p0, rs, gq, acc);
               });
  unsigned long long* cb = cand + (long long)b * nb * T::BUFN;
  flush_topk(sm, 1, k, gq, cb, 0);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&tickets[b], 1u) == (unsigned)nb - 1;
    s_count = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  auto get = [&](long long i) { return __ldcg(cb + i); };
  const long long S2 = (long long)__ldcg(gq + 1);
  const unsigned long long thr =
      block_threshold<TILE_THREADS>(get, S2, k, sm.hist);
  block_emit<TILE_THREADS>(get, S2, thr, x, k2, &s_count);
  __syncthreads();
  for (int t = k + threadIdx.x; t < k2; t += TILE_THREADS) x[t] = 0ull;
  __syncthreads();
  block_sort<TILE_THREADS>(x, k2);
  for (int t = threadIdx.x; t < k; t += TILE_THREADS) {
    unpack_one(x[t], b, (long long)b * k + t, vals, idx, pages, page_idx, P,
               max_pages);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

static int max_dim(bool vec) { return vec ? MAX_DIM_VEC : MAX_DIM_SCALAR; }

static bool dim_ok(int dim) {
  return dim >= 1 && dim <= max_dim(dim % 4 == 0);
}

// 16-byte copies need dim % 4 == 0 and 16-byte aligned bases
static bool vec_route(int dim, const void* a, const void* b) {
  return dim % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// The current device's SM count and shared memory per SM and reserved
// per block, read once per device (the grids are sized on every call).
struct DevInfo {
  int sms, smem, reserved;
};

static DevInfo read_dev_info(int dev) {
  DevInfo d{1, 0, 0};
  if (cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || d.sms < 1) {
    d.sms = 1;
  }
  if (cudaDeviceGetAttribute(&d.smem,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&d.reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess) {
    d.smem = d.reserved = 0;
  }
  return d;
}

static DevInfo dev_info() {
  constexpr int kDevices = 64;
  static DevInfo cache[kDevices];
  static std::once_flag once[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  if (dev < 0 || dev >= kDevices) return read_dev_info(dev);
  std::call_once(once[dev], [dev] { cache[dev] = read_dev_info(dev); });
  return cache[dev];
}

static long long sm_count() { return dev_info().sms; }

static long long tiles_of(long long n) {
  return (n + TILE_ROWS - 1) / TILE_ROWS;
}

// blocks of smem bytes that fit an SM, at most limit
static long long per_sm(size_t smem, int limit = BLOCKS_PER_SM) {
  const DevInfo d = dev_info();
  const long long fit = (long long)d.smem / ((long long)smem + d.reserved);
  return fit < 1 ? 1 : fit < limit ? fit : limit;
}

// shared memory of a flat scan block: the scores kernel (k2 == 0) or the
// fused top-k's, for a launch of nqp query slots
template <int NQ>
static size_t flat_smem_nq(int k2) {
  if (k2 == 0) return Smem<NQ>::scan_bytes;
  if (k2 <= KSMALL) {
    typedef Topk<false> T;
    return Smem<NQ, T::template stages<NQ>(), T::BUFN>::topk_bytes;
  }
  typedef Topk<true> T;
  return Smem<NQ, T::template stages<NQ>(), T::BUFN>::topk_bytes;
}

static size_t flat_smem(int nqp, int k2) {
  switch (nqp) {
    case 1: return flat_smem_nq<1>(k2);
    case 2: return flat_smem_nq<2>(k2);
    case 4: return flat_smem_nq<4>(k2);
    case 8: return flat_smem_nq<8>(k2);
  }
  return flat_smem_nq<16>(k2);
}

// the persistent flat grid of a scan of up to nq queries a launch (sized
// for the widest launch, so every launch of a search has the same grid);
// k2 == 0 for the scores kernel
static long long flat_grid(long long n, int nq, int k2) {
  const int nqp = pow2_at_least(nq < MAX_SLOTS ? nq : MAX_SLOTS);
  const int limit =
      k2 > 0 && k2 <= KSMALL ? SMALL_BLOCKS_PER_SM : BLOCKS_PER_SM;
  const long long g = per_sm(flat_smem(nqp, k2), limit) * sm_count();
  const long long t = tiles_of(n);
  return t < g ? t : g;
}

// candidate keys a fused block holds per query
static int topk_bufn(int k2) {
  return k2 <= KSMALL ? Topk<false>::BUFN : Topk<true>::BUFN;
}

static size_t ivf_topk_smem(int k2) {
  return k2 <= KSMALL ? Smem<1, Topk<false>::stages<1>(),
                             Topk<false>::BUFN>::topk_bytes
                      : Smem<1, Topk<true>::stages<1>(),
                             Topk<true>::BUFN>::topk_bytes;
}

// blocks per query of the IVF page kernels: the card's persistent blocks
// over the queries, at most a block per tile, and at most MERGE_MAX keys
// for the last block to merge
static int ivf_blocks(int nq, long long S, int k2) {
  long long b = (per_sm(ivf_topk_smem(k2)) * sm_count() + nq - 1) / nq;
  if (b > tiles_of(S)) b = tiles_of(S);
  if (b > MERGE_MAX / k2) b = MERGE_MAX / k2;
  return b < 1 ? 1 : (int)b;
}

// Allows a kernel instance its dynamic shared memory, once.
template <typename Kernel>
static cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// What a flat scan launch writes: the fused top-k's keys (cand, and the
// queries' shared thresholds gthr) or the scores (out).
struct FlatOut {
  unsigned long long* cand;
  unsigned long long* gthr;
  float* out;
  long long out_stride;
};

template <int NQ, bool VEC>
static cudaError_t flat_launch(long long grid, const float* M, long long n,
                               int dim, const float* row_sq, const float* Q,
                               int nq, int mode, int k, int k2,
                               const FlatOut& o, cudaStream_t s) {
  const size_t smem = flat_smem_nq<NQ>(k2);
  if (k2 == 0) {
    static const cudaError_t attr = allow_smem(vec_flat_scores<NQ, VEC>, smem);
    if (attr != cudaSuccess) return attr;
    vec_flat_scores<NQ, VEC><<<(unsigned)grid, TILE_THREADS, smem, s>>>(
        M, n, dim, row_sq, Q, nq, mode, o.out, o.out_stride);
  } else if (k2 <= KSMALL) {
    static const cudaError_t attr =
        allow_smem(vec_flat_topk<NQ, VEC, false>, smem);
    if (attr != cudaSuccess) return attr;
    vec_flat_topk<NQ, VEC, false><<<(unsigned)grid, TILE_THREADS, smem, s>>>(
        M, n, dim, row_sq, Q, nq, mode, k, k2, o.gthr, o.cand);
  } else {
    static const cudaError_t attr =
        allow_smem(vec_flat_topk<NQ, VEC, true>, smem);
    if (attr != cudaSuccess) return attr;
    vec_flat_topk<NQ, VEC, true><<<(unsigned)grid, TILE_THREADS, smem, s>>>(
        M, n, dim, row_sq, Q, nq, mode, k, k2, o.gthr, o.cand);
  }
  return cudaGetLastError();
}

template <bool VEC>
static cudaError_t flat_nq(int nqp, long long grid, const float* M,
                           long long n, int dim, const float* row_sq,
                           const float* Q, int nq, int mode, int k, int k2,
                           const FlatOut& o, cudaStream_t s) {
#define CASE_NQ(N)                                                       \
  case N:                                                                \
    return flat_launch<N, VEC>(grid, M, n, dim, row_sq, Q, nq, mode, k, k2, \
                               o, s);
  switch (nqp) {
    CASE_NQ(1)
    CASE_NQ(2)
    CASE_NQ(4)
    CASE_NQ(8)
    CASE_NQ(16)
  }
#undef CASE_NQ
  return cudaErrorInvalidValue;
}

// The flat scan of the n rows of M for nq queries, MAX_SLOTS a launch
// (every row read once a launch): with k2 > 0 the fused top-k (the keys of
// query q at o.cand + q * flat_grid(n, nq, k2) * topk_bufn(k2), its shared
// threshold and count at o.gthr + 2 q, zeroed before), else the scores
// (o.out).
static cudaError_t flat_run(const float* M, long long n, int dim,
                            const float* row_sq, const float* Q, int nq,
                            int mode, int k, int k2, const FlatOut& o,
                            cudaStream_t s) {
  const bool vec = vec_route(dim, M, Q);
  const long long grid = flat_grid(n, nq, k2);
  for (int q0 = 0; q0 < nq; q0 += MAX_SLOTS) {
    const int g = nq - q0 < MAX_SLOTS ? nq - q0 : MAX_SLOTS;
    const int gp = pow2_at_least(g);
    const float* Qg = Q + (long long)q0 * dim;
    const FlatOut og =
        k2 ? FlatOut{o.cand + q0 * grid * topk_bufn(k2), o.gthr + 2 * q0,
                     nullptr, 0}
           : FlatOut{nullptr, nullptr, o.out + q0 * o.out_stride,
                     o.out_stride};
    const cudaError_t err =
        vec ? flat_nq<true>(gp, grid, M, n, dim, row_sq, Qg, g, mode, k, k2,
                            og, s)
            : flat_nq<false>(gp, grid, M, n, dim, row_sq, Qg, g, mode, k, k2,
                             og, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}


static long long align256(long long x) { return (x + 255) & ~255LL; }

static bool select_in_one_block(long long S, int k2) {
  return S <= BLOCK_SELECT_MAX_S && k2 <= SORT_CHUNK;
}

static long long cand_chunks(long long S) {
  return (S + CAND_CHUNK - 1) / CAND_CHUNK;
}

// the two-phase route: a chunk keeps at most a quarter of its scores,
// and the candidates fit one block's select
static bool select_in_two_phases(long long S, int k2) {
  return k2 <= SORT_CHUNK / 4 &&
         cand_chunks(S) * k2 <= BLOCK_SELECT_MAX_S;
}

// scratch of select: none for the one-block kernel; the candidates (nq,
// chunks, k2) 64-bit for the two-phase route; else the candidates (nq, k2)
// 64-bit, then the state (nq, STATE_WORDS) and the histograms (nq, PASSES,
// 256) as 32-bit words, zeroed together.
static long long select_scratch(int nq, long long S, int k2) {
  if (select_in_one_block(S, k2)) return 0;
  if (select_in_two_phases(S, k2))
    return align256((long long)nq * cand_chunks(S) * k2 * 8);
  return align256((long long)nq * k2 * 8) +
         align256((long long)nq * (STATE_WORDS + PASSES * 256) * 4);
}

static bool select_args_ok(int nq, long long S, int k, int k2,
                           const int* pages, int P, int max_pages) {
  return nq >= 1 && nq <= 65535 && S >= 1 && S <= 0xffffffffLL && k >= 1 &&
         k <= S && k <= (1 << 30) && k2 == pow2_at_least(k) &&
         (pages == nullptr || (P >= 1 && max_pages >= 1));
}

static cudaError_t select_run(const float* scores, int nq, long long S,
                              int k, int k2, void* scratch, float* vals,
                              int* idx, const int* pages,
                              const int* page_idx, int P, int max_pages,
                              cudaStream_t s) {
  cudaError_t err;
  if (select_in_one_block(S, k2)) {
    vec_select_block<false><<<(unsigned)nq, BLOCK_THREADS, 0, s>>>(
        scores, S, nullptr, k, k2, vals, idx, pages, page_idx, P, max_pages);
    return cudaGetLastError();
  }
  if (select_in_two_phases(S, k2)) {
    unsigned long long* cand = static_cast<unsigned long long*>(scratch);
    const long long chunks = cand_chunks(S);
    vec_select_cand<<<dim3((unsigned)chunks, (unsigned)nq), CAND_THREADS, 0,
                      s>>>(scores, S, k, k2, cand);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    vec_select_block<true><<<(unsigned)nq, BLOCK_THREADS, 0, s>>>(
        cand, chunks * k2, nullptr, k, k2, vals, idx, pages, page_idx, P,
        max_pages);
    return cudaGetLastError();
  }
  unsigned long long* cand = static_cast<unsigned long long*>(scratch);
  unsigned* state = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + align256((long long)nq * k2 * 8));
  unsigned* hist = state + (long long)nq * STATE_WORDS;
  err = cudaMemsetAsync(
      state, 0, (size_t)nq * (STATE_WORDS + PASSES * 256) * 4, s);
  if (err != cudaSuccess) return err;
  long long nblk = (S + (long long)THREADS * SELECT_ITEMS - 1) /
                   ((long long)THREADS * SELECT_ITEMS);
  if (nblk > MAX_SELECT_BLOCKS) nblk = MAX_SELECT_BLOCKS;
  const dim3 grid((unsigned)nblk, (unsigned)nq);
  for (int pass = 0; pass < PASSES; ++pass) {
    vec_radix<<<grid, THREADS, 0, s>>>(scores, S, k, pass, hist, state);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  vec_emit<<<grid, THREADS, 0, s>>>(scores, S, k2, state, cand);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int C = k2 < SORT_CHUNK ? k2 : SORT_CHUNK;
  const dim3 chunks((unsigned)(k2 / C), (unsigned)nq);
  vec_sort_chunk<<<chunks, SORT_THREADS, 0, s>>>(cand, k, k2, C, 1, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (long long size = 2LL * C; size <= k2; size <<= 1) {
    for (long long j = size >> 1; j >= C; j >>= 1) {
      const dim3 g((unsigned)((k2 / 2 + THREADS - 1) / THREADS), (unsigned)nq);
      vec_sort_step<<<g, THREADS, 0, s>>>(cand, k2, size, (int)j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    vec_sort_chunk<<<chunks, SORT_THREADS, 0, s>>>(cand, k, k2, C, 0, size);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long total = (long long)nq * k;
  vec_unpack<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      cand, k2, k, nq, vals, idx, pages, page_idx, P, max_pages);
  return cudaGetLastError();
}

// scratch of the fused flat route: the queries' shared thresholds (16
// bytes each), then the blocks' keys (nq, grid, k2)
static long long flat_gthr_bytes(int nq) { return align256((long long)nq * 16); }

static long long flat_cand_bytes(int nq, long long n, int k2) {
  return flat_gthr_bytes(nq) +
         align256((long long)nq * flat_grid(n, nq, k2) * topk_bufn(k2) * 8);
}

static cudaError_t score_run(const float* M, long long n, int dim,
                             const float* row_sq, const float* Q, int nq,
                             int mode, float* out, long long out_stride,
                             cudaStream_t s) {
  if (n < 0 || nq < 1 || !dim_ok(dim) || mode < 0 || mode > 2 ||
      out_stride < n) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  return flat_run(M, n, dim, row_sq, Q, nq, mode, 0, 0,
                  FlatOut{nullptr, nullptr, out, out_stride}, s);
}

static bool ivf_args_ok(int nq, int nprobe, int max_pages, int P, int dim,
                        int mode) {
  return nq >= 1 && nq <= 65535 && nprobe >= 1 && max_pages >= 1 && P >= 1 &&
         dim_ok(dim) && mode >= 0 && mode <= 2;
}

template <bool VEC>
static cudaError_t ivf_scores_launch(const float* paged, const float* paged_sq,
                                     const int* pages, const int* page_idx,
                                     int nq, int max_pages, int n_pages, int P,
                                     int dim, int n_docs, const float* Q,
                                     int mode, float* out, cudaStream_t s) {
  static const cudaError_t attr =
      allow_smem(vec_ivf_scores<VEC>, Smem<1>::scan_bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ivf_blocks(nq, (long long)max_pages * P, 1), nq);
  vec_ivf_scores<VEC><<<grid, TILE_THREADS, Smem<1>::scan_bytes, s>>>(
      paged, paged_sq, pages, page_idx, max_pages, n_pages, P, dim, n_docs, Q,
      mode, out);
  return cudaGetLastError();
}

static cudaError_t ivf_scores_run(const float* paged, const float* paged_sq,
                                  const int* pages, const int* page_idx,
                                  int nq, int max_pages, int n_pages, int P,
                                  int dim, int n_docs, const float* Q,
                                  int mode, float* out, cudaStream_t s) {
  return vec_route(dim, paged, Q)
             ? ivf_scores_launch<true>(paged, paged_sq, pages, page_idx, nq,
                                       max_pages, n_pages, P, dim, n_docs, Q,
                                       mode, out, s)
             : ivf_scores_launch<false>(paged, paged_sq, pages, page_idx, nq,
                                        max_pages, n_pages, P, dim, n_docs, Q,
                                        mode, out, s);
}

// The IVF scratch: what vec_probe writes for vec_ivf_topk (or the scores
// route) to read.
struct IvfScratch {
  float* cscores;             // (nq, n_lists) past PROBE_LISTS lists
  unsigned long long* sel;    // (nq, nprobe) keys of the chosen lists
  int* lists;                 // (nq, nprobe) in rank order
  int* page_idx;              // (nq, max_pages)
  unsigned* tickets;          // (nq)
  unsigned long long* gthr;   // (nq, 2) shared thresholds
  char* tail;                 // the blocks' keys, or the scores route's
};

template <bool VEC>
static cudaError_t probe_launch(const float* cents, const float* cent_sq,
                                int n_lists, int dim, const float* Q, int nq,
                                int mode, int nprobe, const int* pageptr,
                                int max_pages, int n_pages,
                                const IvfScratch& w, cudaStream_t s) {
  constexpr size_t smem =
      Smem<1, PROBE_STAGES>::scan_bytes + PROBE_LISTS * 4;
  static const cudaError_t attr = allow_smem(vec_probe<VEC>, smem);
  if (attr != cudaSuccess) return attr;
  vec_probe<VEC><<<(unsigned)nq, TILE_THREADS, smem, s>>>(
      cents, cent_sq, n_lists, dim, Q, mode, nprobe, pageptr, max_pages,
      n_pages, w.cscores, w.sel, w.lists, w.page_idx, w.tickets, w.gthr);
  return cudaGetLastError();
}

template <bool VEC, bool BIG>
static cudaError_t ivf_topk_launch(const float* paged, const float* paged_sq,
                                   const int* pages, int nq, int max_pages,
                                   int n_pages, int P, int dim, int n_docs,
                                   const float* Q, int mode, int k, int k2,
                                   const IvfScratch& w, float* vals, int* idx,
                                   cudaStream_t s) {
  const size_t smem = ivf_topk_smem(k2);
  static const cudaError_t attr = allow_smem(vec_ivf_topk<VEC, BIG>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ivf_blocks(nq, (long long)max_pages * P, k2), nq);
  vec_ivf_topk<VEC, BIG><<<grid, TILE_THREADS, smem, s>>>(
      paged, paged_sq, pages, w.page_idx, max_pages, n_pages, P, dim, n_docs,
      Q, mode, k, k2, w.gthr, reinterpret_cast<unsigned long long*>(w.tail),
      w.tickets, vals, idx);
  return cudaGetLastError();
}

extern "C" {

// Largest dim the kernels take: vec = 1 for dim a multiple of 4 (16-byte
// copies), 0 otherwise.
int pinot_vec_max_dim(int vec) { return max_dim(vec != 0); }

// The stages, for tests and the chip check. out (nq, n), row stride
// out_stride: the scores of the n rows of M (n, dim) against the queries
// Q (nq, dim); mode 0: dot, 1: 2 m.q - row_sq - |q|^2, 2: 2 m.q - row_sq.
// Queries go MAX_SLOTS at a time; the bits are the fused scan's.
int pinot_vec_score(const float* M, long long n, int dim, const float* row_sq,
                    const float* Q, int nq, int mode, float* out,
                    long long out_stride, void* stream) {
  return (int)score_run(M, n, dim, row_sq, Q, nq, mode, out, out_stride,
                        static_cast<cudaStream_t>(stream));
}

// out (nq, max_pages * P), page_idx (nq, max_pages): the IVF probe of the
// lists (nq, nprobe) through pageptr over the page-major matrix paged
// (n_pages + 1, P, dim) and its doc ids pages (n_pages + 1, P).
int pinot_vec_pages(const float* paged, const float* paged_sq,
                    const int* pages, const int* pageptr, const int* lists,
                    int nq, int nprobe, int max_pages, int n_pages, int P,
                    int dim, int n_docs, const float* Q, int mode, float* out,
                    int* page_idx, void* stream) {
  if (!ivf_args_ok(nq, nprobe, max_pages, P, dim, mode)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vec_expand<<<(unsigned)nq, TILE_THREADS, 0, s>>>(lists, nprobe, pageptr,
                                                   max_pages, n_pages,
                                                   page_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)ivf_scores_run(paged, paged_sq, pages, page_idx, nq, max_pages,
                             n_pages, P, dim, n_docs, Q, mode, out, s);
}

long long pinot_vec_select_scratch(int nq, long long S, int k2) {
  return select_scratch(nq, S, k2);
}

// vals, idx (nq, k): the top k of each row of scores (nq, S), score
// descending, ties to the lower position (lax.top_k's order); k2 is the
// power of two at or above k, scratch pinot_vec_select_scratch bytes. With
// pages != NULL, positions map to documents through page_idx (nq,
// max_pages) and pages (., P).
int pinot_vec_select(const float* scores, int nq, long long S, int k, int k2,
                     void* scratch, float* vals, int* idx, const int* pages,
                     const int* page_idx, int P, int max_pages,
                     void* stream) {
  if (!select_args_ok(nq, S, k, k2, pages, P, max_pages)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)select_run(scores, nq, S, k, k2, scratch, vals, idx, pages,
                         page_idx, P, max_pages,
                         static_cast<cudaStream_t>(stream));
}

// The flat scan in one call: for k2 <= KCAP the shared thresholds zeroed,
// the fused scan and the merge of the blocks' keys, else the scores of the
// first n rows and their top k.
long long pinot_vec_flat_scratch(int nq, long long n, int k2) {
  if (k2 <= KCAP) return flat_cand_bytes(nq, n, k2);
  return align256((long long)nq * n * 4) + select_scratch(nq, n, k2);
}

int pinot_vec_flat(const float* M, long long n, int dim, const float* row_sq,
                   const float* Q, int nq, int mode, int k, int k2,
                   void* scratch, float* vals, int* idx, void* stream) {
  if (!select_args_ok(nq, n, k, k2, nullptr, 0, 0) || !dim_ok(dim) ||
      mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k2 <= KCAP) {
    unsigned long long* gthr = static_cast<unsigned long long*>(scratch);
    unsigned long long* cand = reinterpret_cast<unsigned long long*>(
        static_cast<char*>(scratch) + flat_gthr_bytes(nq));
    cudaError_t err = cudaMemsetAsync(gthr, 0, (size_t)nq * 16, s);
    if (err == cudaSuccess)
      err = flat_run(M, n, dim, row_sq, Q, nq, mode, k, k2,
                     FlatOut{cand, gthr, nullptr, 0}, s);
    if (err != cudaSuccess) return (int)err;
    vec_select_block<true><<<(unsigned)nq, BLOCK_THREADS, 0, s>>>(
        cand, flat_grid(n, nq, k2) * topk_bufn(k2), gthr + 1, k, k2, vals,
        idx, nullptr, nullptr, 0, 0);
    return (int)cudaGetLastError();
  }
  float* scores = static_cast<float*>(scratch);
  cudaError_t err = score_run(M, n, dim, row_sq, Q, nq, mode, scores, n, s);
  if (err != cudaSuccess) return (int)err;
  return (int)select_run(scores, nq, n, k, k2,
                         static_cast<char*>(scratch) +
                             align256((long long)nq * n * 4),
                         vals, idx, nullptr, nullptr, 0, 0, s);
}

// The IVF probe in one call: vec_probe (centroid scores in mode_cent, the
// top nprobe lists, the page slots), then for k2 <= KCAP vec_ivf_topk (the
// pages' scores in mode, their top k mapped to documents), else the pages'
// scores and the select.
static long long ivf_layout(int nq, int n_lists, int nprobe, int max_pages,
                            int P, int k2, char* base, IvfScratch* w) {
  const long long S = (long long)max_pages * P;
  const long long sizes[7] = {
      n_lists > PROBE_LISTS ? align256((long long)nq * n_lists * 4) : 0,
      align256((long long)nq * nprobe * 8),
      align256((long long)nq * nprobe * 4),
      align256((long long)nq * max_pages * 4),
      align256((long long)nq * 4),
      align256((long long)nq * 16),
      k2 <= KCAP ? align256((long long)nq * ivf_blocks(nq, S, k2) *
                            topk_bufn(k2) * 8)
                 : align256((long long)nq * S * 4) +
                       select_scratch(nq, S, k2)};
  long long off[7], total = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = total;
    total += sizes[i];
  }
  if (w != nullptr) {
    w->cscores = reinterpret_cast<float*>(base + off[0]);
    w->sel = reinterpret_cast<unsigned long long*>(base + off[1]);
    w->lists = reinterpret_cast<int*>(base + off[2]);
    w->page_idx = reinterpret_cast<int*>(base + off[3]);
    w->tickets = reinterpret_cast<unsigned*>(base + off[4]);
    w->gthr = reinterpret_cast<unsigned long long*>(base + off[5]);
    w->tail = base + off[6];
  }
  return total;
}

long long pinot_vec_ivf_scratch(int nq, int n_lists, int nprobe,
                                int max_pages, int P, int k2) {
  return ivf_layout(nq, n_lists, nprobe, max_pages, P, k2, nullptr, nullptr);
}

int pinot_vec_ivf(const float* paged, const float* paged_sq,
                  const int* pages, const int* pageptr, const float* cents,
                  const float* cent_sq, const float* Q, int nq, int n_lists,
                  int nprobe, int max_pages, int n_pages, int P, int dim,
                  int n_docs, int mode_cent, int mode, int k, int k2,
                  void* scratch, float* vals, int* idx, void* stream) {
  const long long S = (long long)max_pages * P;
  if (nprobe > n_lists || mode_cent < 0 || mode_cent > 2 ||
      !ivf_args_ok(nq, nprobe, max_pages, P, dim, mode) ||
      !select_args_ok(nq, S, k, k2, pages, P, max_pages)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  IvfScratch w;
  ivf_layout(nq, n_lists, nprobe, max_pages, P, k2,
             static_cast<char*>(scratch), &w);
  cudaError_t err =
      vec_route(dim, cents, Q)
          ? probe_launch<true>(cents, cent_sq, n_lists, dim, Q, nq, mode_cent,
                               nprobe, pageptr, max_pages, n_pages, w, s)
          : probe_launch<false>(cents, cent_sq, n_lists, dim, Q, nq,
                                mode_cent, nprobe, pageptr, max_pages,
                                n_pages, w, s);
  if (err != cudaSuccess) return (int)err;
  if (k2 <= KCAP) {
    const bool vec = vec_route(dim, paged, Q);
#define IVF_TOPK(V, B)                                                     \
  ivf_topk_launch<V, B>(paged, paged_sq, pages, nq, max_pages, n_pages, P, \
                        dim, n_docs, Q, mode, k, k2, w, vals, idx, s)
    if (k2 <= KSMALL) {
      err = vec ? IVF_TOPK(true, false) : IVF_TOPK(false, false);
    } else {
      err = vec ? IVF_TOPK(true, true) : IVF_TOPK(false, true);
    }
#undef IVF_TOPK
    return (int)err;
  }
  float* sims = reinterpret_cast<float*>(w.tail);
  err = ivf_scores_run(paged, paged_sq, pages, w.page_idx, nq, max_pages,
                       n_pages, P, dim, n_docs, Q, mode, sims, s);
  if (err != cudaSuccess) return (int)err;
  return (int)select_run(sims, nq, S, k, k2,
                         w.tail + align256((long long)nq * S * 4), vals, idx,
                         pages, w.page_idx, P, max_pages, s);
}

}  // extern "C"

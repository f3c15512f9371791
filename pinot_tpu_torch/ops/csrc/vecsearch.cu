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
// card's float32 rate (67 TFLOP/s, 20 a byte). The IVF probe reads only the
// probed pages. So:
//
//   * Scoring (vec_score): a warp takes one matrix row at a time; lane l
//     holds 16-byte units l, l + 32, ... of the row (one coalesced 512-byte
//     load for dim 128, four rows in flight per warp) and of every query of
//     the batch, which sit in registers for the whole kernel. Every row is
//     thus read from device memory once for all queries of a launch (up to
//     16; more run as further launches). Products are full float32 FMAs
//     (no TF32, no bf16). Each lane's partial dot products are combined by
//     a reduce-scatter butterfly over the 32 lanes (xor 16, 8, 4, 2, 1):
//     16 shuffles for 16 queries instead of 80, leaving each query's sum in
//     a fixed lane.
//   * Batched == solo, bitwise: the per-(row, query) arithmetic depends on
//     dim alone. A lane's partial runs over its units in the same order
//     whatever the batch; the butterfly adds the lanes in the same tree for
//     every query slot (each step adds a lane's value to its xor partner's,
//     and a + b == b + a in IEEE arithmetic), and the slot a query takes
//     does not change its tree. The IVF page kernel uses the same partials
//     and tree, so a document scores the same bits in either plan.
//   * Rows whose dim is not a multiple of 4 cannot take 16-byte loads
//     (their rows are not 16-byte aligned); they take 4-byte loads with
//     the same structure. dim is at most 2048 (512 on that path).
//   * IVF (vec_pages): centroids are scored and their top-nprobe selected
//     by the same two kernels. One block per (page slot, query) finds its
//     page by walking that query's nprobe lists through pageptr (the
//     ragged expansion, folded in here), records it for the document
//     mapping, and scores the page's rows, which are contiguous in the
//     page-major copy (32 KiB for 64 x 128). Sentinel documents (== n_docs)
//     and slots past the ragged total score -inf without being read.
//   * Top-k (vec_radix, vec_emit, sort, unpack): lax.top_k's order is score
//     descending, ties to the lower position, with -0.0 below +0.0 and NaN
//     above everything (XLA's total order). Each (score, position) becomes
//     one 64-bit key: the float's orderable uint32 view, then 2^32 - 1 -
//     position. Keys are unique, so the top k keys are exactly lax.top_k's
//     answer. A radix select finds the k-th key 8 bits at a time: each
//     block histograms the keys that share the prefix found so far into
//     shared memory (warp-aggregated increments), adds it to the query's
//     global histogram, and the last block to finish picks the next digit
//     (a ticket counter; no host round trip). It stops as soon as the
//     chosen bucket is taken whole, which for distinct scores is after at
//     most 4 of the 8 digits. vec_emit then writes the keys at or above
//     the threshold (exactly k of them, in any order) and a bitonic sort
//     orders them: in shared memory up to 4096 keys, with global-memory
//     stages above that. unpack turns keys back into (score, position),
//     or into a document id through the IVF page table.
//   * Three routes to the same keys, by size. A row of at most 2^17 scores
//     with k <= 4096 (the centroid scores, an IVF probe) takes the digits
//     in one block per query (vec_select_block: histogram, threshold,
//     candidates and sort in shared memory), one launch. A longer row
//     with k <= 1024 (the flat scan) goes in two phases: each block takes
//     4096 scores into shared memory and writes its own top k
//     (vec_select_cand), then one block per query selects among those
//     candidates; the scores are read once. Larger k takes the multi-block
//     radix select above. Every route returns the exact top k of the same
//     unique keys, so the result does not depend on the route. A whole
//     flat or IVF search is one call from the host (pinot_vec_flat,
//     pinot_vec_ivf) with one scratch buffer.
//
// Nothing is allocated here: the wrapper (pinot_tpu_torch/ops/vecsearch.py)
// passes outputs and scratch (sized by the *_scratch functions), and every
// launch goes on its stream with no synchronisation. Every launch is
// checked and the first CUDA error code is returned (0 on success). Plain
// C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WARPS 8
#define THREADS (WARPS * 32)
#define FULL 0xffffffffu
#define MAX_SLOTS 16       // queries scored per matrix row by one launch
#define MAX_CH 16          // units a lane holds per row (16 x 4 x 32 = 2048)
#define PASSES 8           // 8-bit digits of the 64-bit key
#define SELECT_ITEMS 16    // keys per thread of a radix block
#define MAX_SELECT_BLOCKS 1024
#define SORT_CHUNK 4096    // keys sorted in one block's shared memory
#define SORT_THREADS 512
#define BLOCK_THREADS 1024 // the one-block select
#define BLOCK_SELECT_MAX_S (1 << 17)
#define CAND_CHUNK 4096    // scores per block of the two-phase select
#define CAND_THREADS 256   // its first phase: 16 scores a thread

// per-query select state, in 32-bit words
#define ST_PREFIX 0        // 2 words: the key prefix found so far
#define ST_KREM 2          // keys still to take from the prefix's bucket
#define ST_RESOLVED 3      // the threshold is final
#define ST_DONE 4          // PASSES words: finished blocks of each pass
#define ST_OUT (ST_DONE + PASSES)   // keys written by vec_emit
#define STATE_WORDS 16

enum { MODE_DOT = 0, MODE_L2 = 1, MODE_L2_NOQ = 2 };

template <bool VEC>
struct Unit;
template <>
struct Unit<true> {
  typedef float4 T;
  static constexpr int W = 4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float dot(T m, T q, float acc) {
    acc = fmaf(m.x, q.x, acc);
    acc = fmaf(m.y, q.y, acc);
    acc = fmaf(m.z, q.z, acc);
    return fmaf(m.w, q.w, acc);
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};
template <>
struct Unit<false> {
  typedef float T;
  static constexpr int W = 1;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float dot(T m, T q, float acc) {
    return fmaf(m, q, acc);
  }
  static __device__ __forceinline__ T zero() { return 0.f; }
};

template <int N>
struct Log2 {
  static constexpr int v = 1 + Log2<N / 2>::v;
};
template <>
struct Log2<1> {
  static constexpr int v = 0;
};

// Reduce-scatter over the warp: NQ partial sums per lane in, the full sum
// of slot (lane >> (5 - log2 NQ)) out. Each halving step keeps half the
// slots and adds the partner's copy of them; the remaining steps are the
// plain butterfly. Every slot's sum is added in the same tree.
template <int NQ>
struct Reduce {
  static __device__ __forceinline__ float run(float* p, int lane, int off) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      const float send = upper ? p[i] : p[i + NQ / 2];
      const float keep = upper ? p[i + NQ / 2] : p[i];
      p[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
    return Reduce<NQ / 2>::run(p, lane, off >> 1);
  }
};
template <>
struct Reduce<1> {
  static __device__ __forceinline__ float run(float* p, int, int off) {
    float v = p[0];
    for (; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
  }
};

__device__ __forceinline__ float finish(float dot, int mode, float row_sq,
                                        float q_sq) {
  if (mode == MODE_DOT) return dot;
  const float s = __fsub_rn(__fmul_rn(2.0f, dot), row_sq);
  return mode == MODE_L2 ? __fsub_rn(s, q_sq) : s;
}

// Loads the queries' units of this lane into registers and returns |q|^2 of
// the query in this lane's slot (same partials and tree as a dot product).
template <int NQ, int CH, bool VEC>
__device__ __forceinline__ float load_queries(
    const float* __restrict__ Q, int nq, int dim, int lane,
    typename Unit<VEC>::T (&qr)[NQ][CH]) {
  typedef Unit<VEC> U;
  const int units = dim / U::W;
  const int slot = lane >> (5 - Log2<NQ>::v);
  float my_sq = 0.f;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = lane + 32 * c;
      if (j < nq && u < units) {
        qr[j][c] = U::load(Q + (long long)j * dim + (long long)u * U::W);
        s = U::dot(qr[j][c], qr[j][c], s);
      } else {
        qr[j][c] = U::zero();
      }
    }
    s = Reduce<1>::run(&s, lane, 16);
    if (j == slot) my_sq = s;
  }
  return my_sq;
}

// out[j * out_stride + r] = score of matrix row r against query j, for the
// nq <= NQ queries of this launch.
template <int NQ, int CH, bool VEC>
__global__ void __launch_bounds__(THREADS)
    vec_score(const float* __restrict__ M, long long n, int dim,
              const float* __restrict__ row_sq, const float* __restrict__ Q,
              int nq, int mode, float* __restrict__ out,
              long long out_stride) {
  typedef Unit<VEC> U;
  constexpr int R = CH >= 4 ? 1 : 4 / CH;  // rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int units = dim / U::W;
  typename U::T qr[NQ][CH];
  const float q_sq = load_queries<NQ, CH, VEC>(Q, nq, dim, lane, qr);
  const int slot = lane >> (5 - Log2<NQ>::v);
  const bool writer = (lane & (32 / NQ - 1)) == 0 && slot < nq;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long r0 = warp0 * R; r0 < n; r0 += nwarps * R) {
    typename U::T m[R][CH];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int u = lane + 32 * c;
        m[rr][c] = (r0 + rr < n && u < units)
                       ? U::load(M + (r0 + rr) * dim + (long long)u * U::W)
                       : U::zero();
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const long long r = r0 + rr;
      if (r >= n) break;  // warp-uniform
      float p[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        p[j] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (lane + 32 * c < units) p[j] = U::dot(m[rr][c], qr[j][c], p[j]);
        }
      }
      const float v = Reduce<NQ>::run(p, lane, 16);
      if (writer) {
        out[slot * out_stride + r] =
            finish(v, mode, mode == MODE_DOT ? 0.f : row_sq[r], q_sq);
      }
    }
  }
}

// One block per (page slot j, query b): the page of slot j in query b's
// probe (the ragged expansion of its nprobe lists, in their order), scored
// row by row; out is (nq, max_pages * P), page_idx (nq, max_pages).
template <int CH, bool VEC>
__global__ void __launch_bounds__(THREADS)
    vec_pages(const float* __restrict__ paged,
              const float* __restrict__ paged_sq,
              const int* __restrict__ pages, const int* __restrict__ pageptr,
              const int* __restrict__ lists, int nprobe, int max_pages,
              int n_pages, int P, int dim, int n_docs,
              const float* __restrict__ Q, int mode, float* __restrict__ out,
              int* __restrict__ page_idx) {
  typedef Unit<VEC> U;
  __shared__ int s_page;
  const int j = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const int* lb = lists + (long long)b * nprobe;
    int acc = 0, page = n_pages;  // past the ragged total: the pad page
    for (int t = 0; t < nprobe; ++t) {
      const int l = lb[t];
      const int start = pageptr[l], count = pageptr[l + 1] - start;
      if (j < acc + count) {
        page = start + (j - acc);
        break;
      }
      acc += count;
    }
    s_page = page;
    page_idx[(long long)b * max_pages + j] = page;
  }
  __syncthreads();
  const int page = s_page;
  const int units = dim / U::W;
  typename U::T qr[1][CH];
  const float q_sq =
      load_queries<1, CH, VEC>(Q + (long long)b * dim, 1, dim, lane, qr);
  float* ob = out + ((long long)b * max_pages + j) * P;
  for (int r = warp; r < P; r += WARPS) {
    const long long row = (long long)page * P + r;
    if (pages[row] == n_docs) {
      if (lane == 0) ob[r] = -INFINITY;
      continue;
    }
    float p = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = lane + 32 * c;
      if (u < units) {
        p = U::dot(U::load(paged + row * dim + (long long)u * U::W), qr[0][c],
                   p);
      }
    }
    const float v = Reduce<1>::run(&p, lane, 16);
    if (lane == 0) {
      ob[r] = finish(v, mode, mode == MODE_DOT ? 0.f : paged_sq[row], q_sq);
    }
  }
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
// is float scores (keys made from score and position) or, with KEYS, the
// 64-bit keys of vec_select_cand's candidates (0 pads below every key).
template <bool KEYS>
__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_select_block(const void* __restrict__ in, long long S, int k, int k2,
                     float* __restrict__ vals, int* __restrict__ idx,
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
  auto get = [&](long long i) {
    return KEYS ? kb[i] : make_key(sb[i], i);
  };
  if (threadIdx.x == 0) s_count = 0;
  const unsigned long long thr =
      block_threshold<BLOCK_THREADS>(get, S, k, h);
  block_emit<BLOCK_THREADS>(get, S, thr, x, k2, &s_count);
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
// host side
// ---------------------------------------------------------------------------

static int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// units a lane holds per row, rounded to a power of two; 0 if unsupported
static int lane_units(int dim, bool vec) {
  const int units = vec ? dim / 4 : dim;
  const int ch = pow2_at_least((units + 31) / 32);
  return ch <= MAX_CH ? ch : 0;
}

template <int NQ, int CH, bool VEC>
static cudaError_t score_one(const float* M, long long n, int dim,
                             const float* row_sq, const float* Q, int nq,
                             int mode, float* out, long long out_stride,
                             cudaStream_t s) {
  constexpr int R = CH >= 4 ? 1 : 4 / CH;
  long long blocks = (n + (long long)WARPS * R * 8 - 1) / ((long long)WARPS * R * 8);
  if (blocks < 1) blocks = 1;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  vec_score<NQ, CH, VEC><<<(unsigned)blocks, THREADS, 0, s>>>(
      M, n, dim, row_sq, Q, nq, mode, out, out_stride);
  return cudaGetLastError();
}

template <int NQ, bool VEC>
static cudaError_t score_ch(int ch, const float* M, long long n, int dim,
                            const float* row_sq, const float* Q, int nq,
                            int mode, float* out, long long out_stride,
                            cudaStream_t s) {
#define CASE_CH(C)                                                        \
  case C:                                                                 \
    if (NQ * C <= MAX_SLOTS)                                              \
      return score_one<NQ, (NQ * C <= MAX_SLOTS ? C : 1), VEC>(           \
          M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);            \
    break;
  switch (ch) {
    CASE_CH(1)
    CASE_CH(2)
    CASE_CH(4)
    CASE_CH(8)
    CASE_CH(16)
  }
#undef CASE_CH
  return cudaErrorInvalidValue;
}

template <bool VEC>
static cudaError_t score_nq(int nq_pow2, int ch, const float* M, long long n,
                            int dim, const float* row_sq, const float* Q,
                            int nq, int mode, float* out, long long out_stride,
                            cudaStream_t s) {
  switch (nq_pow2) {
    case 1: return score_ch<1, VEC>(ch, M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);
    case 2: return score_ch<2, VEC>(ch, M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);
    case 4: return score_ch<4, VEC>(ch, M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);
    case 8: return score_ch<8, VEC>(ch, M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);
    case 16: return score_ch<16, VEC>(ch, M, n, dim, row_sq, Q, nq, mode, out, out_stride, s);
  }
  return cudaErrorInvalidValue;
}

template <int CH, bool VEC>
static cudaError_t pages_one(const float* paged, const float* paged_sq,
                             const int* pages, const int* pageptr,
                             const int* lists, int nq, int nprobe,
                             int max_pages, int n_pages, int P, int dim,
                             int n_docs, const float* Q, int mode, float* out,
                             int* page_idx, cudaStream_t s) {
  dim3 grid((unsigned)max_pages, (unsigned)nq);
  vec_pages<CH, VEC><<<grid, THREADS, 0, s>>>(
      paged, paged_sq, pages, pageptr, lists, nprobe, max_pages, n_pages, P,
      dim, n_docs, Q, mode, out, page_idx);
  return cudaGetLastError();
}

template <bool VEC>
static cudaError_t pages_ch(int ch, const float* paged, const float* paged_sq,
                            const int* pages, const int* pageptr,
                            const int* lists, int nq, int nprobe,
                            int max_pages, int n_pages, int P, int dim,
                            int n_docs, const float* Q, int mode, float* out,
                            int* page_idx, cudaStream_t s) {
#define CASE_CH(C)                                                          \
  case C:                                                                   \
    return pages_one<C, VEC>(paged, paged_sq, pages, pageptr, lists, nq,    \
                             nprobe, max_pages, n_pages, P, dim, n_docs, Q, \
                             mode, out, page_idx, s);
  switch (ch) {
    CASE_CH(1)
    CASE_CH(2)
    CASE_CH(4)
    CASE_CH(8)
    CASE_CH(16)
  }
#undef CASE_CH
  return cudaErrorInvalidValue;
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
        scores, S, k, k2, vals, idx, pages, page_idx, P, max_pages);
    return cudaGetLastError();
  }
  if (select_in_two_phases(S, k2)) {
    unsigned long long* cand = static_cast<unsigned long long*>(scratch);
    const long long chunks = cand_chunks(S);
    vec_select_cand<<<dim3((unsigned)chunks, (unsigned)nq), CAND_THREADS, 0,
                      s>>>(scores, S, k, k2, cand);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    vec_select_block<true><<<(unsigned)nq, BLOCK_THREADS, 0, s>>>(
        cand, chunks * k2, k, k2, vals, idx, pages, page_idx, P, max_pages);
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

static cudaError_t score_run(const float* M, long long n, int dim,
                             const float* row_sq, const float* Q, int nq,
                             int mode, float* out, long long out_stride,
                             cudaStream_t s) {
  const bool vec = dim % 4 == 0;
  const int ch = dim > 0 ? lane_units(dim, vec) : 0;
  if (n < 0 || nq < 1 || ch == 0 || mode < 0 || mode > 2 ||
      out_stride < n) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int group = MAX_SLOTS / ch;
  for (int q0 = 0; q0 < nq; q0 += group) {
    const int g = nq - q0 < group ? nq - q0 : group;
    const int gp = pow2_at_least(g);
    const cudaError_t err =
        vec ? score_nq<true>(gp, ch, M, n, dim, row_sq, Q + (long long)q0 * dim,
                             g, mode, out + q0 * out_stride, out_stride, s)
            : score_nq<false>(gp, ch, M, n, dim, row_sq,
                              Q + (long long)q0 * dim, g, mode,
                              out + q0 * out_stride, out_stride, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

static cudaError_t pages_run(const float* paged, const float* paged_sq,
                             const int* pages, const int* pageptr,
                             const int* lists, int nq, int nprobe,
                             int max_pages, int n_pages, int P, int dim,
                             int n_docs, const float* Q, int mode, float* out,
                             int* page_idx, cudaStream_t s) {
  const bool vec = dim % 4 == 0;
  const int ch = dim > 0 ? lane_units(dim, vec) : 0;
  if (nq < 1 || nq > 65535 || nprobe < 1 || max_pages < 1 || P < 1 ||
      ch == 0 || mode < 0 || mode > 2) {
    return cudaErrorInvalidValue;
  }
  return vec ? pages_ch<true>(ch, paged, paged_sq, pages, pageptr, lists, nq,
                              nprobe, max_pages, n_pages, P, dim, n_docs, Q,
                              mode, out, page_idx, s)
             : pages_ch<false>(ch, paged, paged_sq, pages, pageptr, lists, nq,
                               nprobe, max_pages, n_pages, P, dim, n_docs, Q,
                               mode, out, page_idx, s);
}

extern "C" {

// Largest dim the kernels take: vec = 1 for dim a multiple of 4 (16-byte
// loads), 0 otherwise.
int pinot_vec_max_dim(int vec) { return vec ? 4 * 32 * MAX_CH : 32 * MAX_CH; }

// The stages, for tests and the chip check. out (nq, n), row stride
// out_stride: the scores of the n rows of M (n, dim) against the queries
// Q (nq, dim); mode 0: dot, 1: 2 m.q - row_sq - |q|^2, 2: 2 m.q - row_sq.
// Queries go MAX_SLOTS / (units per lane) at a time.
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
  return (int)pages_run(paged, paged_sq, pages, pageptr, lists, nq, nprobe,
                        max_pages, n_pages, P, dim, n_docs, Q, mode, out,
                        page_idx, static_cast<cudaStream_t>(stream));
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

// The flat scan in one call: scores of the first n rows, then their top k.
long long pinot_vec_flat_scratch(int nq, long long n, int k2) {
  return align256((long long)nq * n * 4) + select_scratch(nq, n, k2);
}

int pinot_vec_flat(const float* M, long long n, int dim, const float* row_sq,
                   const float* Q, int nq, int mode, int k, int k2,
                   void* scratch, float* vals, int* idx, void* stream) {
  if (!select_args_ok(nq, n, k, k2, nullptr, 0, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scores = static_cast<float*>(scratch);
  cudaError_t err = score_run(M, n, dim, row_sq, Q, nq, mode, scores, n, s);
  if (err != cudaSuccess) return (int)err;
  return (int)select_run(scores, nq, n, k, k2,
                         static_cast<char*>(scratch) +
                             align256((long long)nq * n * 4),
                         vals, idx, nullptr, nullptr, 0, 0, s);
}

// The IVF probe in one call: centroid scores (mode_cent), their top
// nprobe, the page scores (mode), their top k mapped to documents.
static long long ivf_layout(int nq, int n_lists, int nprobe, int max_pages,
                            int P, int k2, long long* off) {
  const long long S = (long long)max_pages * P;
  const long long sizes[6] = {
      align256((long long)nq * n_lists * 4),       // centroid scores
      align256((long long)nq * nprobe * 4),        // their top values
      align256((long long)nq * nprobe * 4),        // the lists
      align256((long long)nq * S * 4),             // page scores
      align256((long long)nq * max_pages * 4),     // page_idx
      0};
  const long long sel = select_scratch(nq, n_lists, pow2_at_least(nprobe));
  const long long sel2 = select_scratch(nq, S, k2);
  long long total = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = total;
    total += sizes[i];
  }
  off[5] = total;
  return total + (sel > sel2 ? sel : sel2);
}

long long pinot_vec_ivf_scratch(int nq, int n_lists, int nprobe,
                                int max_pages, int P, int k2) {
  long long off[6];
  return ivf_layout(nq, n_lists, nprobe, max_pages, P, k2, off);
}

int pinot_vec_ivf(const float* paged, const float* paged_sq,
                  const int* pages, const int* pageptr, const float* cents,
                  const float* cent_sq, const float* Q, int nq, int n_lists,
                  int nprobe, int max_pages, int n_pages, int P, int dim,
                  int n_docs, int mode_cent, int mode, int k, int k2,
                  void* scratch, float* vals, int* idx, void* stream) {
  const long long S = (long long)max_pages * P;
  if (nprobe < 1 || nprobe > n_lists ||
      !select_args_ok(nq, S, k, k2, pages, P, max_pages)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long off[6];
  ivf_layout(nq, n_lists, nprobe, max_pages, P, k2, off);
  char* base = static_cast<char*>(scratch);
  float* cscores = reinterpret_cast<float*>(base + off[0]);
  float* cvals = reinterpret_cast<float*>(base + off[1]);
  int* lists = reinterpret_cast<int*>(base + off[2]);
  float* sims = reinterpret_cast<float*>(base + off[3]);
  int* page_idx = reinterpret_cast<int*>(base + off[4]);
  void* sel = base + off[5];
  cudaError_t err = score_run(cents, n_lists, dim, cent_sq, Q, nq, mode_cent,
                              cscores, n_lists, s);
  if (err == cudaSuccess)
    err = select_run(cscores, nq, n_lists, nprobe, pow2_at_least(nprobe), sel,
                     cvals, lists, nullptr, nullptr, 0, 0, s);
  if (err == cudaSuccess)
    err = pages_run(paged, paged_sq, pages, pageptr, lists, nq, nprobe,
                    max_pages, n_pages, P, dim, n_docs, Q, mode, sims,
                    page_idx, s);
  if (err == cudaSuccess)
    err = select_run(sims, nq, S, k, k2, sel, vals, idx, pages, page_idx, P,
                     max_pages, s);
  return (int)err;
}

}  // extern "C"

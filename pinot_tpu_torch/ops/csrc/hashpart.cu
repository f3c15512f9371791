// Hash-bucket partition of the mesh exchanges, for sm_90a.
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
// Bound on this card: bytes. Each code and payload is read once and each
// bucket slot written once (ops/hashpart.partition_bytes) over 3.35 TB/s;
// the work per row is a hash and a few integer operations.
//
// Design (a multi-pass counting partition, right before fast):
//   0. the buckets are set to -1 and the flag to 0 (cudaMemsetAsync);
//   1. hp_count: one block a tile of kTile rows; a histogram of the
//      tile's partitions in shared memory, warp-aggregated (the lanes of
//      one partition in a warp add once, by __match_any_sync), written
//      partition-major to counts[p * n_blocks + b];
//   2. hp_scan: one block a partition; an exclusive scan of its counts
//      over the blocks in place (the block's first slot in the bucket),
//      and the flag where the partition's total passes cap;
//   3. hp_scatter: one block a tile again; each warp owns a contiguous
//      run of the tile and counts its partitions (kept as bytes in
//      shared memory), a scan over the warps per partition gives each
//      warp's first slot, then the warp walks its run 32 rows at a time
//      in order: a row's rank is its block's and warp's base plus the
//      lanes of its partition below it in the ballot, so ranks follow
//      the input order exactly.
// The codes are read twice (passes 1 and 3) and the buckets written
// twice (the fill and the scatter): about twice the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;               // rows a block
constexpr int kWarpRows = kTile / kWarps;  // a warp's contiguous run
constexpr int kMaxDev = 64;
constexpr int kMaxCols = 17;              // the codes and 16 payloads
constexpr unsigned kFull = 0xffffffffu;

struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];  // bytes: 4 or 8
  int n;
};

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// n_dev for a row past the end or a code below 0 (no partition)
__device__ __forceinline__ int part_of(const int32_t* codes, int64_t row,
                                       int64_t n, int n_dev) {
  if (row >= n) return n_dev;
  const int32_t c = codes[row];
  if (c < 0) return n_dev;
  return static_cast<int>(splitmix32(static_cast<uint32_t>(c)) %
                          static_cast<uint32_t>(n_dev));
}

__global__ void hp_count(const int32_t* __restrict__ codes, int64_t n,
                         int n_dev, int n_blocks, int32_t* counts) {
  __shared__ int hist[kMaxDev];
  for (int p = threadIdx.x; p < n_dev; p += kThreads) hist[p] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int p = part_of(codes, base + i, n, n_dev);
    const unsigned peers = __match_any_sync(kFull, p);
    if (p < n_dev && lane == __ffs(peers) - 1)
      atomicAdd(&hist[p], __popc(peers));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_dev; p += kThreads)
    counts[static_cast<int64_t>(p) * n_blocks + blockIdx.x] = hist[p];
}

constexpr int kScanThreads = 1024;

__global__ void hp_scan(int32_t* counts, int n_blocks, int64_t cap,
                        uint8_t* overflow) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * n_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int start = 0; start < n_blocks; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int32_t v = i < n_blocks ? row[i] : 0;
    int32_t x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int32_t excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n_blocks) row[i] = static_cast<int32_t>(carry + excl);
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0 && carry > cap) *overflow = 1;
}

__global__ void hp_scatter(const int32_t* __restrict__ codes, int64_t n,
                           int n_dev, int n_blocks, int64_t cap,
                           const int32_t* __restrict__ offsets, Cols cols) {
  __shared__ uint8_t parts[kTile];
  __shared__ int32_t warp_base[kWarps][kMaxDev];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int p = lane; p < n_dev; p += 32) warp_base[warp][p] = 0;
  __syncwarp();
  // this warp's run: partitions and counts
  for (int r = 0; r < kWarpRows; r += 32) {
    const int local = warp * kWarpRows + r + lane;
    const int p = part_of(codes, base + local, n, n_dev);
    parts[local] = static_cast<uint8_t>(p);
    const unsigned peers = __match_any_sync(kFull, p);
    if (p < n_dev && lane == __ffs(peers) - 1)
      warp_base[warp][p] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first slot a partition: the block's, then the warps before
  for (int p = threadIdx.x; p < n_dev; p += kThreads) {
    int32_t run = offsets[static_cast<int64_t>(p) * n_blocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = warp_base[w][p];
      warp_base[w][p] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int r = 0; r < kWarpRows; r += 32) {
    const int local = warp * kWarpRows + r + lane;
    const int p = parts[local];
    const unsigned peers = __match_any_sync(kFull, p);
    const int leader = __ffs(peers) - 1;
    if (p < n_dev) {
      const int64_t pos = static_cast<int64_t>(warp_base[warp][p]) +
                          __popc(peers & ((1u << lane) - 1u));
      if (pos < cap) {
        const int64_t src = base + local;
        const int64_t dst = static_cast<int64_t>(p) * cap + pos;
        for (int k = 0; k < cols.n; ++k) {
          if (cols.width[k] == 8)
            static_cast<int64_t*>(cols.dst[k])[dst] =
                static_cast<const int64_t*>(cols.src[k])[src];
          else
            static_cast<int32_t*>(cols.dst[k])[dst] =
                static_cast<const int32_t*>(cols.src[k])[src];
        }
      }
    }
    __syncwarp();
    if (p < n_dev && lane == leader) warp_base[warp][p] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int pinot_hashpart_tile() { return kTile; }

int pinot_hashpart_max_cols() { return kMaxCols; }

// codes: (n,) int32; srcs / widths: n_cols columns, the codes first then
// the payloads, each (n,) of widths[k] bytes; dsts: their (n_dev, cap)
// buckets; overflow: one byte; counts: n_dev * ceil(n / kTile) int32 of
// scratch. Returns 0, or the CUDA error of the first failed step.
int pinot_hashpart(const int32_t* codes, int64_t n, int n_dev, int64_t cap,
                   int n_cols, const void* const* srcs, void* const* dsts,
                   const int* widths, uint8_t* overflow, int32_t* counts,
                   void* stream_ptr) {
  if (n_dev < 1 || n_dev > kMaxDev || n_cols < 1 || n_cols > kMaxCols ||
      cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Cols cols;
  cols.n = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    if (widths[k] != 4 && widths[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.src[k] = srcs[k];
    cols.dst[k] = dsts[k];
    cols.width[k] = widths[k];
    cudaError_t e = cudaMemsetAsync(
        dsts[k], 0xff, static_cast<size_t>(n_dev) * cap * widths[k], stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaMemsetAsync(overflow, 0, 1, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n == 0) return 0;
  const int n_blocks = static_cast<int>((n + kTile - 1) / kTile);
  hp_count<<<n_blocks, kThreads, 0, stream>>>(codes, n, n_dev, n_blocks,
                                              counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  hp_scan<<<n_dev, kScanThreads, 0, stream>>>(counts, n_blocks, cap,
                                              overflow);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  hp_scatter<<<n_blocks, kThreads, 0, stream>>>(codes, n, n_dev, n_blocks,
                                                cap, counts, cols);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  return 0;
}

}  // extern "C"

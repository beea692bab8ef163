// Per-call bucketing of a gathered GleanVec layout's rows by tag, shared by
// gleanvec_sq.cu (the fused top-k) and dense_scores.cu (dense gleanvec_sq
// and gleanvec_ip).
//
// A gathered layout stores one tag per row in row order, so a tile of
// consecutive rows needs ~C query views and cannot be scored as one product.
// The bucketing builds, for this call only, the tag-sorted order the sorted
// layout fixes at layout time: every tag's rows, in ascending row order,
// padded up to a multiple of GT_N = 128 slots, so each 128-slot tile holds
// ONE tag and scan_gemm.cuh's register-tiled product scores it.
//
//   rows (T * GT_N,)  i32: the row of x in each slot, -1 = padding;
//   tile_tags (T,)    i32: the tag of each tile;
//   slot_of (N,)      i32: the slot of each row (the inverse of rows).
//
// T = floor((N + 127 C) / 128) bounds sum_c ceil(n_c / 128); tiles past the
// used ones are all padding (tag 0) and the scan skips them. Built per call
// and never stored: the streaming stores rewrite tags on every insert.
//
// Three launches after a memset of `rows` to -1:
//   1. bucket_count_kernel: per chunk of BK_CHUNK rows, a shared-memory
//      histogram of its tags -> counts[chunk, tag];
//   2. bucket_plan_kernel (one block): per tag, an exclusive scan of its
//      counts over the chunks plus the tag's first slot (the tiles of the
//      tags before it, a scan over the tags) turns counts[chunk, tag] into
//      the first slot of that chunk's rows of that tag; it writes tile_tags;
//   3. bucket_scatter_kernel: each chunk writes its rows to their slots in
//      row order (a warp ranks equal tags with __match_any_sync, the warps of
//      a round in order through per-warp counts), so the order is stable and
//      the same on every call.
// Tags are clamped to [0, C), as the scan clamps a view index. Traffic at
// N = 2M: the tags read twice (16 MB), the slots written twice and slot_of
// once (24 MB).
//
// The dense kernels score the bucketed layout into a slot-ordered buffer
// and bucket_unpermute_kernel gathers it back into row order: a block takes
// BK_WINDOW consecutive rows of one query, and since each tag's rows ascend
// in their slots, those rows sit in at most C short runs of the buffer, so
// its reads stay in a few sectors and its writes are whole rows. (Writing
// each score straight to column rows[slot] instead scatters 4-byte stores
// ~C columns apart over the whole (M, N) output.)
#pragma once
#include <cuda_runtime.h>

#include "scan_gemm.cuh"

constexpr int BK_CHUNK = 4096;   // rows per block of the count and scatter kernels
constexpr int BK_THREADS = 256;
constexpr int BK_PLAN_THREADS = 1024;

constexpr int BK_WINDOW = 2048;  // rows per block of the unpermute kernel

struct Buckets {
  int* counts;     // (n_chunks, C)
  int* tile_tags;  // (T,)
  int* rows;       // (T * GT_N,)
  int* slot_of;    // (N,)
};

static inline int bucket_tiles(int N, int C) {
  return (int)(((long long)N + (long long)(GT_N - 1) * C) / GT_N);
}

static inline int bucket_chunks(int N) { return (N + BK_CHUNK - 1) / BK_CHUNK; }

static inline size_t bucket_align(size_t b) { return (b + 255) / 256 * 256; }

// Byte offsets of counts, tile_tags, rows and slot_of in the workspace;
// returns its size in bytes.
static size_t bucket_offsets(int N, int C, size_t off[4]) {
  const size_t T = (size_t)bucket_tiles(N, C);
  const size_t sizes[] = {(size_t)bucket_chunks(N) * C * 4, T * 4, T * GT_N * 4,
                          (size_t)N * 4};
  size_t end = 0;
  for (int i = 0; i < 4; ++i) {
    off[i] = end;
    end += bucket_align(sizes[i]);
  }
  return end;
}

static void bucket_carve(char* base, int N, int C, Buckets* b) {
  size_t off[4];
  bucket_offsets(N, C, off);
  b->counts = reinterpret_cast<int*>(base + off[0]);
  b->tile_tags = reinterpret_cast<int*>(base + off[1]);
  b->rows = reinterpret_cast<int*>(base + off[2]);
  b->slot_of = reinterpret_cast<int*>(base + off[3]);
}

__device__ __forceinline__ int bucket_tag(const int* tags, long long n, int C) {
  return min(max(tags[n], 0), C - 1);
}

__global__ void __launch_bounds__(BK_THREADS)
    bucket_count_kernel(const int* __restrict__ tags, int N, int C, int* counts) {
  extern __shared__ int hist[];  // C
  for (int c = threadIdx.x; c < C; c += BK_THREADS) hist[c] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * BK_CHUNK;
  for (int i = threadIdx.x; i < BK_CHUNK; i += BK_THREADS) {
    const long long n = base + i;
    if (n < N) atomicAdd(&hist[bucket_tag(tags, n, C)], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += BK_THREADS)
    counts[(size_t)blockIdx.x * C + c] = hist[c];
}

// Exclusive prefix sum over the block of BK_PLAN_THREADS; *total gets the
// block's sum. sh: 33 ints.
__device__ int bucket_block_scan(int x, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = sh[lane];  // BK_PLAN_THREADS / 32 == 32 warps
    int wi = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    sh[lane] = wi - v;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const int res = sh[warp] + incl - x;
  *total = sh[32];
  __syncthreads();
  return res;
}

__global__ void __launch_bounds__(BK_PLAN_THREADS)
    bucket_plan_kernel(int n_chunks, int C, int T, Buckets b) {
  static_assert(BK_PLAN_THREADS == 1024, "bucket_block_scan assumes 32 warps");
  __shared__ int sh[33];
  extern __shared__ int first_tile[];  // C + 1: the first tile of each tag
  int* total = first_tile + C + 1;     // C: rows of each tag
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = BK_PLAN_THREADS / 32;
  // 1. per tag (one warp each): exclusive scan of its counts over the chunks
  for (int c = warp; c < C; c += nwarps) {
    int carry = 0;
    for (int j0 = 0; j0 < n_chunks; j0 += 32) {
      const int j = j0 + lane;
      const int v = j < n_chunks ? b.counts[(size_t)j * C + c] : 0;
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (j < n_chunks) b.counts[(size_t)j * C + c] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) total[c] = carry;
  }
  __syncthreads();
  // 2. the tags' first tiles: an exclusive scan of ceil(total / GT_N)
  int carry = 0;
  for (int c0 = 0; c0 < C; c0 += BK_PLAN_THREADS) {
    const int c = c0 + threadIdx.x;
    const int tiles = c < C ? (total[c] + GT_N - 1) / GT_N : 0;
    int sum;
    const int excl = bucket_block_scan(tiles, sh, &sum);
    if (c < C) first_tile[c] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) first_tile[C] = carry;
  __syncthreads();
  // 3. per tag: its first slot into every chunk's offset; its tiles' tag
  for (int c = warp; c < C; c += nwarps) {
    const int slot0 = first_tile[c] * GT_N;
    for (int j = lane; j < n_chunks; j += 32) b.counts[(size_t)j * C + c] += slot0;
    for (int t = first_tile[c] + lane; t < first_tile[c + 1]; t += 32) b.tile_tags[t] = c;
  }
  for (int t = first_tile[C] + threadIdx.x; t < T; t += BK_PLAN_THREADS) b.tile_tags[t] = 0;
}

__global__ void __launch_bounds__(BK_THREADS)
    bucket_scatter_kernel(const int* __restrict__ tags, int N, int C, Buckets b) {
  extern __shared__ int bsm[];
  int* next = bsm;      // C: the next free slot of each tag in this chunk
  int* wc = bsm + C;    // (BK_THREADS / 32, C): this round's rows per warp and tag
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c = t; c < C; c += BK_THREADS) next[c] = b.counts[(size_t)blockIdx.x * C + c];
  for (int e = t; e < (BK_THREADS / 32) * C; e += BK_THREADS) wc[e] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * BK_CHUNK;
  for (int r0 = 0; r0 < BK_CHUNK; r0 += BK_THREADS) {
    const long long n = base + r0 + t;
    const int tag = n < N ? bucket_tag(tags, n, C) : -1;  // -1: past the end
    const unsigned peers = __match_any_sync(0xffffffffu, tag);
    const bool leader = lane == __ffs(peers) - 1;
    const int cnt = __popc(peers);
    if (tag >= 0 && leader) wc[warp * C + tag] = cnt;
    __syncthreads();
    if (tag >= 0) {
      int pos = next[tag] + __popc(peers & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += wc[w * C + tag];
      b.rows[pos] = (int)n;
      b.slot_of[n] = pos;
    }
    __syncthreads();
    if (tag >= 0 && leader) {
      atomicAdd(&next[tag], cnt);
      wc[warp * C + tag] = 0;
    }
    __syncthreads();
  }
}

// out[i, n] = buf[i, slot_of[n]] for the M rows of a slot-ordered buffer
// (M, slots) and an (M, N) output; grid (ceil(N / BK_WINDOW), M).
__global__ void __launch_bounds__(BK_THREADS)
    bucket_unpermute_kernel(const float* __restrict__ buf,
                            const int* __restrict__ slot_of, int N, long long slots,
                            float* __restrict__ out) {
  const float* src = buf + (size_t)blockIdx.y * slots;
  float* dst = out + (size_t)blockIdx.y * N;
  const long long n0 = (long long)blockIdx.x * BK_WINDOW;
  for (int j = threadIdx.x; j < BK_WINDOW; j += BK_THREADS) {
    const long long n = n0 + j;
    if (n < N) dst[n] = src[slot_of[n]];
  }
}


// Bucket tags (N,) into the workspace `ws` (bucket_carve's size); b gets
// the carved arrays.
static cudaError_t launch_buckets(const int* tags, int N, int C, void* ws, Buckets* b,
                                  cudaStream_t stream) {
  bucket_carve(static_cast<char*>(ws), N, C, b);
  const int T = bucket_tiles(N, C), chunks = bucket_chunks(N);
  cudaError_t err = cudaMemsetAsync(b->rows, 0xff, (size_t)T * GT_N * 4, stream);
  if (err != cudaSuccess) return err;
  const size_t count_smem = (size_t)C * 4, plan_smem = (size_t)(2 * C + 1) * 4,
               scatter_smem = (size_t)(1 + BK_THREADS / 32) * C * 4;
  if ((err = open_dynamic_smem((const void*)bucket_count_kernel)) ||
      (err = open_dynamic_smem((const void*)bucket_plan_kernel)) ||
      (err = open_dynamic_smem((const void*)bucket_scatter_kernel)))
    return err;
  if (chunks > 0) {
    bucket_count_kernel<<<chunks, BK_THREADS, count_smem, stream>>>(tags, N, C, b->counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bucket_plan_kernel<<<1, BK_PLAN_THREADS, plan_smem, stream>>>(chunks, C, T, *b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunks > 0) {
    bucket_scatter_kernel<<<chunks, BK_THREADS, scatter_smem, stream>>>(tags, N, C, *b);
    err = cudaGetLastError();
  }
  return err;
}

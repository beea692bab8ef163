// Gathered GleanVec tile: per-row tags, shared by gleanvec_sq.cu (the fused
// top-k, gleanvec_sq_topk) and dense_scores.cu (dense gleanvec_sq and
// gleanvec_ip).
//
//   score[m, n] = <q_scaled[m, tag_n], codes_n> + q_lo[m, tag_n]
//
// A block keeps the C views of TMG <= 4 queries in shared memory (C * (d + 1)
// * 4 bytes per query, 31 KB at C = 48, d = 160) and one thread scores one
// row of a 256-row tile against them, reading q_scaled[m, tag_n, :] directly
// (the TPU selects views with a one-hot matmul instead). Each tile's rows
// are first counting-sorted by tag in shared memory (the staging copy writes
// each row to its sorted slot), so the 32 lanes of a warp read the views of
// a few neighbouring tags: with the odd row stride d + 1 those fall in
// distinct banks or broadcast. Each FMA still needs its own view element
// from shared memory, so the tile is bound by shared-memory bandwidth (32
// four-byte words per clock per SM against 128 FMAs), a quarter of the FMA
// peak at best: the cost the sorted layout exists to remove.
//
// DENSE = false folds each tile into per-query top-k lists (ids from
// row_ids, -1 = masked); DENSE = true writes the tile's scores to the
// (M, N) output that pv points to (row_ids null, k = 0). The top-k
// instantiation is the one gleanvec_sq.cu had before the tile moved here,
// token for token: a first version with a null test of q_lo and a wider
// argument struct slowed its u8 variant by a quarter on an H100.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_common.cuh"

constexpr int GG_N = 256;  // rows per tile, one per thread
constexpr int GG_K = 32;   // depth chunk staged in shared memory
constexpr int GG_THREADS = 256;

struct GatherArgs {
  const float* qs;      // (M, C, d)
  const float* qlo;     // (M, C)
  const int* tags;      // (N,)
  const int* row_ids;   // optional (N,)
  const void* x;        // (N, d)
  int M, C, d, N, k, S;
  float* pv;            // top-k: (M, S, k) partial lists; DENSE: (M, N) scores
  int* pi;
};

static size_t gathered_smem(int tmg, int C, int d, int k) {
  return ((size_t)tmg * C * (d + 1) + (size_t)tmg * C + (size_t)tmg * k * 2 +
          (size_t)GG_K * (GG_N + 1) + (size_t)tmg * GG_N + 3 * GG_N + C + 1) * 4;
}

template <typename XT, int TMG, bool DENSE = false>
__global__ void __launch_bounds__(GG_THREADS) gathered_scan_topk_kernel(GatherArgs a) {
  extern __shared__ float gg[];
  const int dp = a.d + 1;
  float* qv = gg;                                 // TMG * C * dp
  float* lo = qv + (size_t)TMG * a.C * dp;        // TMG * C
  float* lv = lo + TMG * a.C;                     // TMG * k
  int* li = reinterpret_cast<int*>(lv + TMG * a.k);
  float* xs = reinterpret_cast<float*>(li + TMG * a.k);  // GG_K * (GG_N + 1)
  float* sc = xs + GG_K * (GG_N + 1);             // TMG * GG_N
  int* tid = reinterpret_cast<int*>(sc + TMG * GG_N);    // GG_N, sorted slots
  int* stag = tid + GG_N;                         // GG_N, tag of each slot
  int* rowpos = stag + GG_N;                      // GG_N, slot of each row
  int* hist = rowpos + GG_N;                      // C + 1 (C = past the end)

  const int m0 = blockIdx.x * TMG;
  const int s = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const XT* x = static_cast<const XT*>(a.x);
  const int cd = a.C * a.d;

  for (int e = t; e < TMG * cd; e += GG_THREADS) {
    const int m = e / cd, rem = e % cd, c = rem / a.d, j = rem % a.d;
    qv[(m * a.C + c) * dp + j] = (m0 + m < a.M) ? a.qs[(size_t)(m0 + m) * cd + rem] : 0.f;
  }
  for (int e = t; e < TMG * a.C; e += GG_THREADS) {
    const int m = e / a.C;
    lo[e] = (m0 + m < a.M) ? a.qlo[(size_t)(m0 + m) * a.C + e % a.C] : 0.f;
  }
  for (int e = t; e < TMG * a.k; e += GG_THREADS) {
    lv[e] = NEG_INF_F;
    li[e] = -1;
  }
  const long long r0 = (long long)a.N * s / a.S, r1 = (long long)a.N * (s + 1) / a.S;
  __syncthreads();

  for (long long nb = r0; nb < r1; nb += GG_N) {
    // counting sort of the tile's rows by tag: row t goes to slot rowpos[t]
    for (int c = t; c <= a.C; c += GG_THREADS) hist[c] = 0;
    __syncthreads();
    const long long n = nb + t;
    int tag = a.C, id = -1;  // rows past the split's end: bucket C, masked
    if (n < r1) {
      tag = min(max(a.tags[n], 0), a.C - 1);
      id = a.row_ids ? a.row_ids[n] : (int)n;
    }
    const int slot = atomicAdd(&hist[tag], 1);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of hist[0..C]
      int carry = 0;
      for (int base = 0; base <= a.C; base += 32) {
        const int c = base + lane;
        const int h = c <= a.C ? hist[c] : 0;
        int incl = h;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        if (c <= a.C) hist[c] = carry + incl - h;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();
    const int pos = hist[tag] + slot;
    rowpos[t] = pos;
    stag[pos] = tag;
    tid[pos] = id;
    __syncthreads();
    const int my_tag = min(stag[t], a.C - 1);  // thread t scores slot t
    float acc[TMG];
#pragma unroll
    for (int m = 0; m < TMG; ++m) acc[m] = 0.f;
    for (int kc = 0; kc < a.d; kc += GG_K) {
      const int dd = kc + lane;
#pragma unroll  // all 32 loads in flight at once: the tile waits on them
      for (int r = 0; r < GG_N / 8; ++r) {
        const int nn = warp + 8 * r;
        const long long row = nb + nn;
        float val = 0.f;
        if (row < r1 && dd < a.d) val = static_cast<float>(x[(size_t)row * a.d + dd]);
        xs[lane * (GG_N + 1) + rowpos[nn]] = val;
      }
      __syncthreads();
      const int kmax = min(GG_K, a.d - kc);
      const float* qt = qv + my_tag * dp + kc;
#pragma unroll 8
      for (int kk = 0; kk < kmax; ++kk) {
        const float xv = xs[kk * (GG_N + 1) + t];
#pragma unroll
        for (int m = 0; m < TMG; ++m)
          acc[m] = fmaf(qt[(size_t)m * a.C * dp + kk], xv, acc[m]);
      }
      __syncthreads();
    }
    if constexpr (DENSE) {
      const int col = tid[t];  // the row scored in slot t, -1 = past the end
      if (col >= 0) {
#pragma unroll
        for (int m = 0; m < TMG; ++m)
          if (m0 + m < a.M)
            a.pv[(size_t)(m0 + m) * a.N + col] = acc[m] + lo[m * a.C + my_tag];
      }
      __syncthreads();  // hist, tid and stag are rewritten by the next tile
    } else {
#pragma unroll
      for (int m = 0; m < TMG; ++m) sc[m * GG_N + t] = acc[m] + lo[m * a.C + my_tag];
      __syncthreads();
      const int tn = (int)min((long long)GG_N, r1 - nb);
      for (int r = warp; r < TMG; r += GG_THREADS / 32)
        if (m0 + r < a.M)
          topk_update_row(sc + r * GG_N, tid, tn, lv + r * a.k, li + r * a.k, a.k, lane);
      __syncthreads();
    }
  }

  for (int e = t; e < TMG * a.k; e += GG_THREADS) {
    const int r = e / a.k, j = e % a.k, m = m0 + r;
    if (m < a.M) {
      const size_t o = ((size_t)m * a.S + s) * a.k + j;
      a.pv[o] = lv[e];
      a.pi[o] = li[e];
    }
  }
}

template <typename XT, int TMG, bool DENSE>
static cudaError_t launch_gathered(const GatherArgs& a, cudaStream_t stream) {
  const size_t smem = gathered_smem(TMG, a.C, a.d, a.k);
  auto kernel = gathered_scan_topk_kernel<XT, TMG, DENSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.M + TMG - 1) / TMG, a.S);
  kernel<<<grid, GG_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Queries per block of the gathered tile: the most (4, 2 or 1) whose views
// fit the 227 KB a block may use; 0 = none fits.
static int gathered_tmg(int C, int d, int k) {
  const size_t cap = 232448;
  for (int tmg = 4; tmg >= 1; tmg >>= 1)
    if (gathered_smem(tmg, C, d, k) <= cap) return tmg;
  return 0;
}

template <typename XT, bool DENSE>
static cudaError_t launch_gathered_tmg(const GatherArgs& a, int tmg, cudaStream_t stream) {
  if (tmg == 4) return launch_gathered<XT, 4, DENSE>(a, stream);
  if (tmg == 2) return launch_gathered<XT, 2, DENSE>(a, stream);
  if (tmg == 1) return launch_gathered<XT, 1, DENSE>(a, stream);
  return cudaErrorInvalidValue;
}

// Shared pieces of the fused scan + top-k kernels (ip_topk.cu, gleanvec_sq.cu,
// ivf_scan.cu, graph_scan.cu).
//
// The TPU kernels carry ONE running (TM, k) top-k across a sequential N grid.
// Hopper blocks run in parallel and in no order, so the port splits N across
// blocks: each block keeps a sorted per-query top-k list in shared memory,
// writes it to an (M, S, k) partial buffer, and `topk_merge_kernel` (a second
// launch) reduces the S partial lists of every query to its final top-k.
//
// A list holds at most TOPK_PASS_K entries (its shift runs through registers,
// and GT_M lists of k entries must fit a block's shared memory). A larger k
// runs ceil(k / TOPK_PASS_K) passes of the same scan: pass p keeps only the
// entries that rank strictly below its CEILING, the last entry pass p - 1
// wrote for the query, and its merge writes columns [p * TOPK_PASS_K, ...) of
// the output. The order below is total over distinct ids, and a score does
// not depend on the pass (the same tiles, the same FMA chain), so the passes
// together give exactly the single-list top-k.
//
// Order: value descending, then id ascending with id -1 treated as the
// LARGEST id (compared as unsigned), so value ties break toward the smaller
// id and a -1 slot never outranks a real id of equal value. Masked rows and
// padding carry (NEG_INF, -1), as in the reference.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>
#include "error.cuh"

#define NEG_INF_F (-3.4e38f)
#define TOPK_PASS_K 128
#define MERGE_MAX 8192

__device__ __forceinline__ bool topk_better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && (unsigned)i1 < (unsigned)i2);
}

// One warp folds `tn` scored columns into one query's sorted list lv/li (k
// entries, best first). sc: the query's scores; ids: column ids (-1 =
// masked, never inserted). Candidates that beat the current k-th entry are
// inserted one at a time: the warp counts the entries that outrank the
// candidate (they form a prefix, since the list is sorted) and shifts the
// tail down by one. k <= TOPK_PASS_K. CEIL: only candidates that rank
// strictly below (ceil_v, ceil_i) enter (a later pass of a larger k).
template <bool CEIL = false>
__device__ __forceinline__ void topk_update_row(const float* sc, const int* ids,
                                                int tn, float* lv, int* li,
                                                int k, int lane,
                                                float ceil_v = 0.f,
                                                int ceil_i = 0) {
  const unsigned full = 0xffffffffu;
  float tv = lv[k - 1];
  int ti = li[k - 1];
  for (int c0 = 0; c0 < tn; c0 += 32) {
    int j = c0 + lane;
    float v = NEG_INF_F;
    int id = -1;
    if (j < tn) {
      v = sc[j];
      id = ids[j];
    }
    bool pred = id >= 0 && topk_better(v, id, tv, ti);
    if constexpr (CEIL) pred = pred && topk_better(ceil_v, ceil_i, v, id);
    unsigned mask = __ballot_sync(full, pred);
    while (mask) {
      int src = __ffs(mask) - 1;
      mask &= mask - 1;
      float cv = __shfl_sync(full, v, src);
      int cid = __shfl_sync(full, id, src);
      if (!topk_better(cv, cid, tv, ti)) continue;  // threshold rose meanwhile
      int cnt = 0;
      for (int e = lane; e < k; e += 32) cnt += topk_better(lv[e], li[e], cv, cid);
      int pos = __reduce_add_sync(full, cnt);
      float ov[TOPK_PASS_K / 32];
      int oi[TOPK_PASS_K / 32];
#pragma unroll
      for (int t = 0; t < TOPK_PASS_K / 32; ++t) {
        int e = lane + 32 * t;
        if (e > pos && e < k) {
          ov[t] = lv[e - 1];
          oi[t] = li[e - 1];
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < TOPK_PASS_K / 32; ++t) {
        int e = lane + 32 * t;
        if (e > pos && e < k) {
          lv[e] = ov[t];
          li[e] = oi[t];
        }
      }
      if (lane == 0) {
        lv[pos] = cv;
        li[pos] = cid;
      }
      __syncwarp();
      tv = lv[k - 1];
      ti = li[k - 1];
    }
  }
}

// Sort P (a power of two) (value, id) pairs in shared memory, best first
// (topk_better order), with the whole block; a bitonic network. Ends with a
// barrier.
__device__ __forceinline__ void bitonic_sort_best_first(float* v, int* id, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        int j = i ^ stride;
        if (j > i) {
          bool desc = (i & size) == 0;
          float a_v = v[i], b_v = v[j];
          int a_i = id[i], b_i = id[j];
          bool swap = desc ? topk_better(b_v, b_i, a_v, a_i)
                           : topk_better(a_v, a_i, b_v, b_i);
          if (swap) {
            v[i] = b_v;
            v[j] = a_v;
            id[i] = b_i;
            id[j] = a_i;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Reduce the (M, S, k) partial lists to (M, k): one block per query, a
// bitonic sort of the S*k candidates (padded to a power of two with
// (-inf, -1)) in shared memory, best first. Query m's k entries go to
// out[m * ldo, m * ldo + k).
__global__ void topk_merge_kernel(const float* __restrict__ pv,
                                  const int* __restrict__ pi, int S, int k,
                                  int P, int ldo, float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  extern __shared__ unsigned char merge_smem[];
  float* v = reinterpret_cast<float*>(merge_smem);
  int* id = reinterpret_cast<int*>(v + P);
  const int m = blockIdx.x;
  const int total = S * k;
  const float* src_v = pv + (size_t)m * total;
  const int* src_i = pi + (size_t)m * total;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    if (e < total) {
      v[e] = src_v[e];
      id[e] = src_i[e];
    } else {
      v[e] = -CUDART_INF_F;
      id[e] = -1;
    }
  }
  __syncthreads();
  bitonic_sort_best_first(v, id, P);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_v[(size_t)m * ldo + e] = v[e];
    out_i[(size_t)m * ldo + e] = id[e];
  }
}

static inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

static inline cudaError_t launch_topk_merge(const float* pv, const int* pi, int M,
                                            int S, int k, int ldo, float* out_v,
                                            int* out_i, cudaStream_t stream) {
  int P = next_pow2(S * k);
  size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  cudaError_t err = open_dynamic_smem((const void*)topk_merge_kernel);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<M, 512, smem, stream>>>(pv, pi, S, k, P, ldo, out_v, out_i);
  return cudaGetLastError();
}

// graph_scan: one hop of the fused graph beam search on Hopper (sm_90a).
//
// Replaces the TPU kernel `graph_scan_beam_step` in
// src/repro/kernels/graph_scan/graph_scan.py:177 (pallas_call body
// `_beam_step_kernel`). For each query m: the hop's neighbor rows
// nbr_rows[m, :S] (sorted-row indices of a tag-sorted layout, -1 = pad, any
// order, repeats allowed) are scored once per distinct live row,
//   score = <q_scaled[m, tag], codes[row]> + q_lo[m, tag],
//   tag = block_tags[row / layout_block], id = row_ids[row],
// a candidate is dropped (NEG_INF, -1) if it is a pad, a repeat, a dead row
// (id -1) or an id already in the incoming beam, and the B best of beam +
// candidates come out best first (value descending, id ascending, -1 last;
// topk_common.cuh's order).
//
// What bounds it on an H100 SXM: bytes. At the graph path's shapes (M =
// 1024 queries, B = 128, S = expand * 28 = 28 or 112, d = 160, C = 48) a hop
// scores at most S rows per query at 2 d flops each: 1024 * 112 * 320 =
// 3.7e7 flops, 0.5 us at 67 TFLOP/s. The bytes it must move are the member
// rows' codes (d bytes u8 or 4 d f32 each, up to 18 MB u8 / 73 MB f32 per
// hop), the views of the tags those rows carry (4 d bytes per distinct
// (query, tag) pair, about 0.6 KB each), the neighbor rows (4 S bytes per
// query) and the beam in and out (16 B bytes per query): about 10-25 us at
// 3.35 TB/s. So every hop is bound by bytes, and at these sizes by latency:
// each row is a dependent chain of loads (nbr_rows -> row_ids/block_tags ->
// codes), and the whole hop is a few microseconds of traffic.
//
// What the design does about it: one block per query; its neighbor rows are
// sorted in shared memory (bitonic, padded to a power of two), so repeats
// sit side by side and each distinct row is read once; one warp per
// candidate reads the row's codes with 16-byte loads where d and the
// pointers allow (a ragged d reads one element a lane) and the tag's view
// row from the query's (C, d) block, which stays in L1/L2 for the block's
// life; the beam ids stay in shared memory for the membership test (one
// compare per lane per 32 ids). Only member rows are read, never the TPU
// kernel's tn-row slabs: Hopper gathers a row as cheaply as a slab, and the
// TPU's slab schedule, scalar prefetch and tn rounds of replace-the-minimum
// (graph_scan.py:74-107, 142-157) exist for its sequential grid and DMA
// engine. The B + S (value, id) pairs are then sorted best first in shared
// memory and the first B written. No (M, S) score matrix or gathered row
// leaves the block.
#include <climits>
#include <stdint.h>

#include "topk_common.cuh"
#include "error.cuh"

#define GS_THREADS 256
#define GS_MAX_S 4096
#define GS_SMEM_CAP 232448  // bytes of shared memory a block may use

// Ascending bitonic sort of P (a power of two) ints in shared memory with
// the whole block; ends with a barrier.
__device__ __forceinline__ void bitonic_sort_int_asc(int* a, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        int j = i ^ stride;
        if (j > i) {
          bool asc = (i & size) == 0;
          int x = a[i], y = a[j];
          if (asc ? x > y : x < y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot4_u8(float4 a, uint32_t w) {
  return a.x * (float)(w & 0xffu) + a.y * (float)((w >> 8) & 0xffu) +
         a.z * (float)((w >> 16) & 0xffu) + a.w * (float)(w >> 24);
}

// <q, x> over d elements by one warp; every lane returns the sum. `vec`:
// q and x are 16-byte aligned and d is a multiple of 4 (f32) or 16 (u8).
__device__ __forceinline__ float row_dot(const float* q, const float* x, int d,
                                         bool vec, int lane) {
  float acc = 0.f;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int k = lane; k < (d >> 2); k += 32) acc += dot4(q4[k], __ldg(x4 + k));
  } else {
    for (int k = lane; k < d; k += 32) acc += q[k] * __ldg(x + k);
  }
  return warp_sum(acc);
}

__device__ __forceinline__ float row_dot(const float* q, const uint8_t* x,
                                         int d, bool vec, int lane) {
  float acc = 0.f;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const uint4* x16 = reinterpret_cast<const uint4*>(x);
    for (int k = lane; k < (d >> 4); k += 32) {
      uint4 w = __ldg(x16 + k);
      const float4* qk = q4 + 4 * k;
      acc += dot4_u8(qk[0], w.x) + dot4_u8(qk[1], w.y) + dot4_u8(qk[2], w.z) +
             dot4_u8(qk[3], w.w);
    }
  } else {
    for (int k = lane; k < d; k += 32) acc += q[k] * (float)__ldg(x + k);
  }
  return warp_sum(acc);
}

// One block per query. Shared memory: Q (value, id) pairs (the beam in
// [0, B), the candidates in [B, B + S), -inf pads up to the power of two Q)
// and P sorted neighbor rows.
template <typename XT>
__global__ void __launch_bounds__(GS_THREADS) graph_scan_kernel(
    const float* __restrict__ qs, const float* __restrict__ qlo,
    const int* __restrict__ block_tags, const int* __restrict__ row_ids,
    const XT* __restrict__ codes, const int* __restrict__ nbr_rows,
    const float* __restrict__ beam_vals, const int* __restrict__ beam_ids,
    int C, int d, int N, int layout_block, int S, int B, int P, int Q,
    bool vec, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char gs_smem[];
  float* v = reinterpret_cast<float*>(gs_smem);
  int* id = reinterpret_cast<int*>(v + Q);
  int* rows = id + Q;
  const int m = blockIdx.x;
  const int* nr = nbr_rows + (size_t)m * S;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    int r = j < S ? nr[j] : -1;
    rows[j] = (r >= 0 && r < N) ? r : INT_MAX;   // pads sort to the end
  }
  for (int j = threadIdx.x; j < Q; j += blockDim.x) {
    if (j < B) {
      v[j] = beam_vals[(size_t)m * B + j];
      id[j] = beam_ids[(size_t)m * B + j];
    } else {
      v[j] = -CUDART_INF_F;
      id[j] = -1;
    }
  }
  __syncthreads();
  bitonic_sort_int_asc(rows, P);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* qm = qs + (size_t)m * C * d;
  for (int j = warp; j < S; j += nwarps) {       // warp-uniform from here on
    const int row = rows[j];
    bool ok = row != INT_MAX && (j == 0 || rows[j - 1] != row);
    int cid = ok ? row_ids[row] : -1;
    ok = ok && cid >= 0;
    if (ok) {
      bool hit = false;
      for (int t = lane; t < B; t += 32) hit |= id[t] == cid;
      ok = !__any_sync(0xffffffffu, hit);
    }
    float val = NEG_INF_F;
    if (ok) {
      const int tag = block_tags[row / layout_block];
      val = row_dot(qm + (size_t)tag * d, codes + (size_t)row * d, d, vec,
                    lane) +
            qlo[(size_t)m * C + tag];
    } else {
      cid = -1;
    }
    if (lane == 0) {
      v[B + j] = val;
      id[B + j] = cid;
    }
  }
  __syncthreads();
  bitonic_sort_best_first(v, id, Q);
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    out_v[(size_t)m * B + e] = v[e];
    out_i[(size_t)m * B + e] = id[e];
  }
}

// Shared memory of one block: Q = next_pow2(B + S) (value, id) pairs and
// P = next_pow2(S) rows. The beam and the candidates are sorted together in
// it, so B + S is bounded by a block's 227 KB (B + S <= 16384 at S <= 4096).
static size_t graph_scan_smem(int S, int B) {
  return (size_t)next_pow2(B + S) * (sizeof(float) + sizeof(int)) +
         (size_t)next_pow2(S > 0 ? S : 1) * sizeof(int);
}

extern "C" long long graph_scan_smem_bytes(int S, int B) {
  return (long long)graph_scan_smem(S, B);
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename XT>
static int graph_scan_impl(const float* qs, const float* qlo,
                           const int* block_tags, const int* row_ids,
                           const XT* codes, const int* nbr_rows,
                           const float* beam_vals, const int* beam_ids, int M,
                           int C, int d, int N, int layout_block, int S, int B,
                           float* out_v, int* out_i, void* stream) {
  if (M <= 0) return 0;
  if (S < 0 || S > GS_MAX_S || B < 1 || layout_block <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_vec = sizeof(XT) == 1 ? 16 : 4;  // elements per 16-byte load
  const bool vec = d % per_vec == 0 && aligned16(qs) && aligned16(codes);
  const size_t smem = graph_scan_smem(S, B);
  if (smem > GS_SMEM_CAP) return (int)cudaErrorInvalidValue;
  const int P = next_pow2(S > 0 ? S : 1);
  const int Q = next_pow2(B + S);
  cudaError_t err = cudaFuncSetAttribute(
      graph_scan_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  graph_scan_kernel<XT><<<M, GS_THREADS, smem, (cudaStream_t)stream>>>(
      qs, qlo, block_tags, row_ids, codes, nbr_rows, beam_vals, beam_ids, C, d,
      N, layout_block, S, B, P, Q, vec, out_v, out_i);
  return (int)cudaGetLastError();
}

extern "C" int graph_scan_beam_step_f32(
    const float* qs, const float* qlo, const int* block_tags,
    const int* row_ids, const float* codes, const int* nbr_rows,
    const float* beam_vals, const int* beam_ids, int M, int C, int d, int N,
    int layout_block, int S, int B, float* out_v, int* out_i, void* stream) {
  return graph_scan_impl<float>(qs, qlo, block_tags, row_ids, codes, nbr_rows,
                                beam_vals, beam_ids, M, C, d, N, layout_block,
                                S, B, out_v, out_i, stream);
}

extern "C" int graph_scan_beam_step_u8(
    const float* qs, const float* qlo, const int* block_tags,
    const int* row_ids, const uint8_t* codes, const int* nbr_rows,
    const float* beam_vals, const int* beam_ids, int M, int C, int d, int N,
    int layout_block, int S, int B, float* out_v, int* out_i, void* stream) {
  return graph_scan_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes,
                                  nbr_rows, beam_vals, beam_ids, M, C, d, N,
                                  layout_block, S, B, out_v, out_i, stream);
}

// Tiled fp32 scan + per-block top-k of the gathered layout of
// gleanvec_sq.cu (through its per-call bucketing, bucket_rows.cuh) and of
// the dense gathered scores (dense_scores.cu). ip_topk.cu, the sorted
// layout of gleanvec_sq.cu (top-k and dense), sq_dot and ivf_scan.cu run
// the pipelined scan of ip_scan.cuh instead.
//
// A block owns GT_M = 64 queries and one split of the layout's tiles of
// GT_N = 128 slots; the bucketing gives every tile ONE tag (a segment of
// L = GT_N slots). Slot n of the layout holds row rows[n] of x (-1 =
// padding), so a tile stages x[rows[n], :]; a slot's id is
// row_ids[rows[n]] (or rows[n]); a tile whose first slot is padding is all
// padding and is skipped. Per tile the block computes the (64, 128) score
// tile with a register-tiled fp32 FMA product (each thread 4 x 8 scores,
// operands staged through shared memory in depth chunks of GT_K = 32), adds
// the per-query affine offset of the tile's view, and folds the tile into
// its per-query top-k lists (topk_common.cuh). The dense (M, N) score
// matrix never exists. The DENSE instantiation (dense_scores.cu: gathered
// gleanvec_sq and gleanvec_ip) runs the same tiles and writes each score
// tile to a slot-ordered buffer instead of folding it. The indirection adds
// a chain of dependent loads (slot -> row -> id) in front of each tile, so
// the next tile's rows and tag are loaded a tile ahead, the ids and offsets
// reach shared memory with the first depth chunk, and each depth chunk's
// operands are loaded into registers while the previous chunk is folded.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_common.cuh"

constexpr int GT_M = 64;
constexpr int GT_N = 128;
constexpr int GT_K = 32;
constexpr int GT_THREADS = 256;
constexpr int QS_STRIDE = GT_M + 4;
constexpr int XS_STRIDE = GT_N + 4;
constexpr int GT_STAGE =
    (GT_K * (QS_STRIDE + XS_STRIDE) > GT_M * GT_N) ? GT_K * (QS_STRIDE + XS_STRIDE)
                                                   : GT_M * GT_N;

struct GemmScanArgs {
  const float* q;       // query m, view t: q + m * q_stride + t * d
  long long q_stride;
  int d;
  const float* qlo;     // optional (M, C) offsets: qlo[m * C + t]
  int C;
  const int* seg_tags;  // optional view per segment (default 0)
  const int* row_ids;   // optional id per row, -1 = masked (default: row)
  const void* x;        // (N, d) rows, float or uint8
  int N;
  int L;                // rows per segment
  int M;
  int k;
  int S;                // splits of the row tiles (partial slots per query)
  float* pv;            // (M, S, k) partial lists; DENSE: (M, N) scores
  int* pi;
  const int* rows = nullptr;     // (N,) row of x per layout slot, -1 = padding
  const float* ceil_v = nullptr; // CEIL: query m's ceiling at ceil_v[m * ceil_ld]
  const int* ceil_i = nullptr;
  int ceil_ld = 0;
};

// Query tiles x splits. MIN_BLOCKS resident blocks per SM set the
// register budget: 2 (at most 128 a thread) for the fold, 3 (at most 85)
// for DENSE, which (with k = 0) stores every tile to the slot-ordered
// matrix at a.pv; its top-k lists are empty and nothing is folded. CEIL: a
// later pass of a k > TOPK_PASS_K scan (topk_common.cuh).
template <typename XT, int MIN_BLOCKS, bool DENSE = false, bool CEIL = false>
__global__ void __launch_bounds__(GT_THREADS, MIN_BLOCKS)
    gemm_scan_topk_kernel(GemmScanArgs a) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  float* lv = reinterpret_cast<float*>(gsmem);  // GT_M * k
  int* li = reinterpret_cast<int*>(lv + GT_M * a.k);
  int* tile_ids = li + GT_M * a.k;              // GT_N
  float* lo_s = reinterpret_cast<float*>(tile_ids + GT_N);  // GT_M
  int* tail = reinterpret_cast<int*>(lo_s + GT_M);
  int* tile_rows = tail;                        // GT_N rows of x, -1 = padding
  tail += GT_N;
  float* ceil_vs = reinterpret_cast<float*>(tail);  // CEIL: GT_M ceilings
  int* ceil_is = tail + GT_M;
  tail += CEIL ? 2 * GT_M : 0;
  float* stage = reinterpret_cast<float*>(tail);  // 16-byte aligned
  float* qs = stage;                            // GT_K x QS_STRIDE
  float* xs = stage + GT_K * QS_STRIDE;         // GT_K x XS_STRIDE
  float* sc = stage;                            // GT_M x GT_N, after the depth loop

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ty = t >> 4, tx = t & 15;
  const XT* x = static_cast<const XT*>(a.x);

  const int tps = (a.L + GT_N - 1) / GT_N;
  const int m0 = blockIdx.x * GT_M, s = blockIdx.y;
  const long long nseg = (a.N + (long long)a.L - 1) / a.L;
  const long long T = nseg * tps;
  const long long t_begin = T * s / a.S, t_end = T * (s + 1) / a.S;
  for (int e = t; e < GT_M * a.k; e += GT_THREADS) {
    lv[e] = NEG_INF_F;
    li[e] = -1;
  }
  __syncthreads();
  // query row of tile row r, -1 = none
  auto query_of = [&](int r) -> int { return m0 + r < a.M ? m0 + r : -1; };
  if constexpr (CEIL) {  // read by the fold, after the first tile's barriers
    if (t < GT_M) {
      const int m = query_of(t);
      ceil_vs[t] = m >= 0 ? a.ceil_v[(size_t)m * a.ceil_ld] : NEG_INF_F;
      ceil_is[t] = m >= 0 ? a.ceil_i[(size_t)m * a.ceil_ld] : -1;
    }
  }

  // the next tile's first slot, tag and (thread t < GT_N) slot t's row
  int pf_first = -1, pf_tag = 0, pf_row = -1;
  if (t_begin < t_end) {
    pf_first = a.rows[t_begin * GT_N];
    pf_tag = a.seg_tags[t_begin];
    if (t < GT_N) pf_row = a.rows[t_begin * GT_N + t];
  }

  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int seg = (int)(tile / tps), sub = (int)(tile % tps);
    const long long seg0 = (long long)seg * a.L;
    const int n0 = (int)(seg0 + (long long)sub * GT_N);
    const int cur_row = pf_row, cur_tag = pf_tag;  // this tile's
    {
      const int first = pf_first;
      if (tile + 1 < t_end) {
        pf_first = a.rows[(tile + 1) * GT_N];
        pf_tag = a.seg_tags[tile + 1];
        if (t < GT_N) pf_row = a.rows[(tile + 1) * GT_N + t];
      }
      if (first < 0) continue;  // all padding; the whole block skips it
    }
    const int n1 = n0 + GT_N;
    const int tag = min(max(cur_tag, 0), a.C - 1);
    int id = -1;          // slot t's id and query t's offset, stored
    float tile_lo = 0.f;  // with the first depth chunk
    if (t < GT_N) {
      tile_rows[t] = cur_row;
      id = cur_row >= 0 ? (a.row_ids ? a.row_ids[cur_row] : cur_row) : -1;
    }
    if (t < GT_M) {
      const int m = query_of(t);
      tile_lo = (a.qlo && m >= 0) ? a.qlo[(size_t)m * a.C + tag] : 0.f;
    }
    __syncthreads();  // tile_rows, read by every warp's staging
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    {
      // The slots' rows are scattered, so their loads wait longer than a
      // contiguous tile's: chunk kc + GT_K is loaded into registers while
      // chunk kc is folded.
      float qn[GT_M / 8], xn[GT_N / 8];
      auto load_chunk = [&](int kc) {
        const int dd = kc + lane;
#pragma unroll
        for (int r = 0; r < GT_M / 8; ++r) {
          const int m = m0 + warp + 8 * r;
          qn[r] = (m < a.M && dd < a.d)
                      ? a.q[(size_t)m * a.q_stride + (size_t)tag * a.d + dd]
                      : 0.f;
        }
#pragma unroll
        for (int r = 0; r < GT_N / 8; ++r) {
          const int row = tile_rows[warp + 8 * r];
          xn[r] = (row >= 0 && dd < a.d) ? static_cast<float>(x[(size_t)row * a.d + dd])
                                         : 0.f;
        }
      };
      load_chunk(0);
      for (int kc = 0; kc < a.d; kc += GT_K) {
#pragma unroll
        for (int r = 0; r < GT_M / 8; ++r) qs[lane * QS_STRIDE + warp + 8 * r] = qn[r];
#pragma unroll
        for (int r = 0; r < GT_N / 8; ++r) xs[lane * XS_STRIDE + warp + 8 * r] = xn[r];
        if (kc == 0) {
          if (t < GT_N) tile_ids[t] = id;
          if (t < GT_M) lo_s[t] = tile_lo;
        }
        __syncthreads();
        if (kc + GT_K < a.d) load_chunk(kc + GT_K);
#pragma unroll 4
        for (int kk = 0; kk < GT_K; ++kk) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[kk * QS_STRIDE + ty * 4]);
          const float4 x0 = *reinterpret_cast<const float4*>(&xs[kk * XS_STRIDE + tx * 4]);
          const float4 x1 =
              *reinterpret_cast<const float4*>(&xs[kk * XS_STRIDE + 64 + tx * 4]);
          const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
          const float xa[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qa[i], xa[j], acc[i][j]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float lo = lo_s[r];
      *reinterpret_cast<float4*>(&sc[r * GT_N + tx * 4]) =
          make_float4(acc[i][0] + lo, acc[i][1] + lo, acc[i][2] + lo, acc[i][3] + lo);
      *reinterpret_cast<float4*>(&sc[r * GT_N + 64 + tx * 4]) =
          make_float4(acc[i][4] + lo, acc[i][5] + lo, acc[i][6] + lo, acc[i][7] + lo);
    }
    __syncthreads();
    if constexpr (DENSE) {
      // one warp per query row: 32 consecutive columns per store
      for (int r = warp; r < GT_M; r += GT_THREADS / 32) {
        const int m = query_of(r);
        if (m >= 0) {
          float* orow = a.pv + (size_t)m * a.N + n0;
          for (int c = lane; c < n1 - n0; c += 32) orow[c] = sc[r * GT_N + c];
        }
      }
    } else {
      for (int r = warp; r < GT_M; r += GT_THREADS / 32)
        if (query_of(r) >= 0)
          topk_update_row<CEIL>(sc + r * GT_N, tile_ids, n1 - n0, lv + r * a.k,
                                li + r * a.k, a.k, lane, CEIL ? ceil_vs[r] : 0.f,
                                CEIL ? ceil_is[r] : 0);
    }
    __syncthreads();
  }

  for (int e = t; e < GT_M * a.k; e += GT_THREADS) {
    const int r = e / a.k, j = e % a.k, m = query_of(r);
    if (m >= 0) {
      const size_t o = ((size_t)m * a.S + s) * a.k + j;
      a.pv[o] = lv[e];
      a.pi[o] = li[e];
    }
  }
}

// Shared memory of one block of the top-k scan at list length a.k.
template <bool CEIL>
static size_t gemm_scan_smem(const GemmScanArgs& a) {
  return (size_t)GT_M * a.k * 8 + GT_N * 4 + GT_M * 4 + GT_N * 4 + (CEIL ? GT_M * 8 : 0) +
         GT_STAGE * 4;
}


// The scan alone, on `grid` blocks (partial lists only, a.k <= TOPK_PASS_K),
// under the 2-block budget that keeps its register-staged chunk.
template <typename XT, bool CEIL = false>
static cudaError_t launch_gemm_scan_blocks(const GemmScanArgs& a, dim3 grid,
                                           cudaStream_t stream) {
  const size_t smem = gemm_scan_smem<CEIL>(a);
  auto kernel = gemm_scan_topk_kernel<XT, 2, false, CEIL>;
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  kernel<<<grid, GT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The bucketed gathered layout: query tiles x S splits of the row tiles,
// then the merge of the S partial lists of every query, for any a.k >= 1:
// one pass per TOPK_PASS_K columns of the output, each after the first
// under the previous pass's ceiling. a.pv / a.pi hold (M, S, min(a.k,
// TOPK_PASS_K)) entries.
template <typename XT>
static cudaError_t launch_gemm_scan_rows(GemmScanArgs a, float* out_v, int* out_i,
                                         cudaStream_t stream) {
  const int k = a.k;
  const dim3 grid((a.M + GT_M - 1) / GT_M, a.S);
  for (int k0 = 0; k0 < k; k0 += TOPK_PASS_K) {
    a.k = k - k0 < TOPK_PASS_K ? k - k0 : TOPK_PASS_K;
    cudaError_t err;
    if (k0 == 0) {
      err = launch_gemm_scan_blocks<XT>(a, grid, stream);
    } else {
      a.ceil_v = out_v + k0 - 1;
      a.ceil_i = out_i + k0 - 1;
      a.ceil_ld = k;
      err = launch_gemm_scan_blocks<XT, true>(a, grid, stream);
    }
    if (err != cudaSuccess) return err;
    err = launch_topk_merge(a.pv, a.pi, a.M, a.S, a.k, k, out_v + k0, out_i + k0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Dense slot-ordered scores over query tiles x a.S splits of the row tiles
// (no top-k lists, no merge). k must be 0.
template <typename XT>
static cudaError_t launch_gemm_dense(const GemmScanArgs& a, cudaStream_t stream) {
  const size_t smem = GT_N * 4 + GT_M * 4 + GT_N * 4 + GT_STAGE * 4;
  auto kernel = gemm_scan_topk_kernel<XT, 3, true>;
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.M + GT_M - 1) / GT_M, a.S), GT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

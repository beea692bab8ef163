// ivf_scan_topk: the gather-free fine step of a sorted IVF on Hopper
// (sm_90a).
//
// Replaces the TPU kernel `ivf_scan_topk` in
// src/repro/kernels/ivf_scan/ivf_scan.py (pallas_call body
// `_range_scan_kernel`). Inputs: q_scaled (M, C, d) f32, q_lo (M, C) f32,
// block_tags (NB,) i32, row_ids (N,) i32 (-1 = padding, never wins),
// codes (N, d) uint8 or f32 of the tag-sorted layout (layout blocks of L
// rows, one tag each), and sched (M, S) i32: the layout blocks each query
// visits (-1, or any index outside [0, NB), = a pad slot that scores
// nothing). Every valid slot's slab is scored with its block's one view,
//   score[m, n] = <q_scaled[m, tag_b], codes_n> + q_lo[m, tag_b],
// and the top k per query come out as (vals (M, k) f32, ids (M, k) i32),
// ids from row_ids, value descending then id ascending; winners at -inf
// carry id -1 (k above the valid row count, an all-pad schedule).
//
// What bounds it on an H100 SXM, at the smoke run's IVF shapes (M = 1024
// queries, nprobe = 12 of C = 48 clusters over N ~ 2.2M sorted rows, so each
// query scores ~0.55M rows of d = 160): 2 * 1024 * 0.55M * 160 = 1.8e11
// flop = 2.7 ms at the 67 TFLOP/s fp32 peak. The bytes a kernel must move are
// the probed slabs read once (at most the whole store: 0.35 GB of u8 codes,
// 1.4 GB f32, plus 4 bytes of row id per row) = 0.1 / 0.4 ms at 3.35 TB/s.
// So the fine step is fp32 FMA bound, and the design decides how far from
// that it lands.
//
// The TPU grid is one query per grid row, each row streaming its own
// schedule: carried over, every query would read its probed slabs for itself
// (1024 x 0.55M rows x 164 B = 92 GB u8, 363 GB f32: 27 / 108 ms of bytes
// alone). This design inverts the schedule on the device instead, so each
// slab is scored against all the queries that probe it at once:
//   1. ivf_count_kernel: one warp per query compacts its valid slots
//      (slot r = rank among the query's valid slots) and counts, per layout
//      block, the queries that visit it (atomics give each its rank);
//   2. ivf_plan_kernel: one block scans the counts into per-block offsets
//      and cuts each block's query list into work items of <= 64 queries;
//   3. ivf_scatter_kernel: writes each (query, slot) entry into its block's
//      list;
//   4. the register-tiled fp32 scan of scan_gemm.cuh in work-list mode: one
//      CTA per work item scores the block's L rows (128-row tiles, never
//      crossing the block) against its <= 64 queries with the block's single
//      view, folds them into per-query top-k lists in shared memory and
//      writes each list to the query's partial slot r of (M, S, k);
//   5. ivf_merge_kernel: per query, the running best k and chunks of its
//      valid partial lists are bitonic-sorted in shared memory (at most
//      MERGE_MAX at a time) until all are consumed.
// A k above TOPK_PASS_K repeats steps 4-5 once per TOPK_PASS_K output
// columns, each pass under the previous one's ceiling (topk_common.cuh).
// A slab is read once per work item that covers it: ceil(queries probing it /
// 64) times, about 4 at the smoke shapes (~1.4 GB u8, 5.6 GB f32 per batch,
// before the 50 MB L2 catches the items of one block, which run side by
// side). No (M, S * L) score or candidate matrix reaches device memory; the
// partial lists take M * S * k * 8 bytes. All arithmetic is fp32 FMA, no
// TF32; tensor cores and TMA are later work.
#include "scan_gemm.cuh"
#include "error.cuh"

constexpr int IVF_THREADS = 256;

struct Workspace {
  int* counts;     // (NB,) queries per block
  int* offsets;    // (NB,) first entry of each block's list
  int* nvalid;     // (M,) valid slots per query
  int* ent_block;  // (M, S) block of compacted slot r
  int* ent_rank;   // (M, S) rank of the entry in its block's list
  int* q_index;    // (M * S,) entries grouped by block: query row
  int* q_slot;     //                                    compacted slot
  int* work;       // (W_max, 3) work items
  int* n_work;     // (1,)
  float* pv;       // (M, S, k) partial lists
  int* pi;
};

static size_t align256(size_t b) { return (b + 255) / 256 * 256; }

static size_t max_work(int M, int S, int NB) {
  return (size_t)NB + ((size_t)M * S + GT_M - 1) / GT_M;
}

// Carve the workspace; returns its size in bytes (base may be null). The
// partial lists hold one pass: min(k, TOPK_PASS_K) entries.
static size_t carve(char* base, int M, int S, int NB, int k, Workspace* w) {
  const size_t ms = (size_t)M * S;
  k = k < TOPK_PASS_K ? k : TOPK_PASS_K;
  const size_t sizes[] = {(size_t)NB * 4, (size_t)NB * 4, (size_t)M * 4, ms * 4,
                          ms * 4, ms * 4, ms * 4, max_work(M, S, NB) * 12, 4,
                          ms * k * 4, ms * k * 4};
  void** slots[] = {(void**)&w->counts, (void**)&w->offsets, (void**)&w->nvalid,
                    (void**)&w->ent_block, (void**)&w->ent_rank, (void**)&w->q_index,
                    (void**)&w->q_slot, (void**)&w->work, (void**)&w->n_work,
                    (void**)&w->pv, (void**)&w->pi};
  size_t off = 0;
  for (int i = 0; i < 11; ++i) {
    *slots[i] = base ? base + off : nullptr;
    off += align256(sizes[i]);
  }
  return off;
}

__global__ void ivf_count_kernel(const int* __restrict__ sched, int M, int S, int NB,
                                 Workspace w) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;  // whole warps
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const int b = s < S ? sched[(size_t)m * S + s] : -1;
    const bool ok = b >= 0 && b < NB;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const size_t e = (size_t)m * S + base + __popc(mask & ((1u << lane) - 1u));
      w.ent_block[e] = b;
      w.ent_rank[e] = atomicAdd(&w.counts[b], 1);
    }
    base += __popc(mask);
  }
  if (lane == 0) w.nvalid[m] = base;
}

// Exclusive prefix sum over the block; *total gets the block's sum.
__device__ int block_scan_excl(int x, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nw ? sh[lane] : 0;
    int wi = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < nw) sh[lane] = wi - v;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const int res = sh[warp] + incl - x;
  *total = sh[32];
  __syncthreads();
  return res;
}

__global__ void ivf_plan_kernel(int NB, Workspace w) {
  __shared__ int sh[33];
  int carry_e = 0, carry_w = 0;
  for (int b0 = 0; b0 < NB; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int c = b < NB ? w.counts[b] : 0;
    const int tiles = (c + GT_M - 1) / GT_M;
    int tot_e, tot_w;
    const int oe = carry_e + block_scan_excl(c, sh, &tot_e);
    const int ow = carry_w + block_scan_excl(tiles, sh, &tot_w);
    if (b < NB) {
      w.offsets[b] = oe;
      for (int j = 0; j < tiles; ++j) {
        int* wk = w.work + 3 * (size_t)(ow + j);
        wk[0] = b;
        wk[1] = oe + j * GT_M;
        wk[2] = min(GT_M, c - j * GT_M);
      }
    }
    carry_e += tot_e;
    carry_w += tot_w;
  }
  if (threadIdx.x == 0) *w.n_work = carry_w;
}

__global__ void ivf_scatter_kernel(int M, int S, Workspace w) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)M * S) return;
  const int m = (int)(e / S), r = (int)(e % S);
  if (r >= w.nvalid[m]) return;
  const int pos = w.offsets[w.ent_block[e]] + w.ent_rank[e];
  w.q_index[pos] = m;
  w.q_slot[pos] = r;
}

// Per query: the running best k sit in [0, k); each round loads the next
// P - k candidates of the query's valid partial lists behind them and sorts.
// Query m's k entries go to out[m * ldo, m * ldo + k).
__global__ void ivf_merge_kernel(int S, int k, int P, int ldo, Workspace w,
                                 float* out_v, int* out_i) {
  extern __shared__ unsigned char merge_smem[];
  float* v = reinterpret_cast<float*>(merge_smem);
  int* id = reinterpret_cast<int*>(v + P);
  const int m = blockIdx.x;
  const long long total = (long long)w.nvalid[m] * k;
  const float* src_v = w.pv + (size_t)m * S * k;
  const int* src_i = w.pi + (size_t)m * S * k;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    v[e] = NEG_INF_F;
    id[e] = -1;
  }
  const int chunk = P - k;
  for (long long c0 = 0; c0 < total; c0 += chunk) {
    for (int e = threadIdx.x; e < chunk; e += blockDim.x) {
      const long long src = c0 + e;
      if (src < total) {
        v[k + e] = src_v[src];
        id[k + e] = src_i[src];
      } else {
        v[k + e] = -CUDART_INF_F;
        id[k + e] = -1;
      }
    }
    __syncthreads();
    bitonic_sort_best_first(v, id, P);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_v[(size_t)m * ldo + e] = v[e];
    out_i[(size_t)m * ldo + e] = id[e];
  }
}

extern "C" long long ivf_scan_workspace_bytes(int M, int S, int NB, int k) {
  Workspace w;
  return (long long)carve(nullptr, M, S, NB, k, &w);
}

template <typename XT>
static int ivf_impl(const float* qs, const float* qlo, const int* block_tags,
                    const int* row_ids, const XT* codes, const int* sched, int M,
                    int C, int d, int N, int NB, int L, int S, int k, void* ws,
                    float* out_v, int* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Workspace w;
  carve(static_cast<char*>(ws), M, S, NB, k, &w);
  cudaError_t err = cudaMemsetAsync(w.counts, 0, (size_t)NB * 4, st);
  if (err != cudaSuccess) return (int)err;
  const size_t ms = (size_t)M * S;
  if (ms > 0) {
    const int warps = IVF_THREADS / 32;
    ivf_count_kernel<<<(M + warps - 1) / warps, IVF_THREADS, 0, st>>>(sched, M, S, NB,
                                                                      w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else {
    err = cudaMemsetAsync(w.nvalid, 0, (size_t)M * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  ivf_plan_kernel<<<1, 1024, 0, st>>>(NB, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (ms > 0) {
    ivf_scatter_kernel<<<(unsigned)((ms + IVF_THREADS - 1) / IVF_THREADS), IVF_THREADS,
                         0, st>>>(M, S, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  GemmScanArgs a;
  a.q = qs;
  a.q_stride = (long long)C * d;
  a.d = d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = block_tags;
  a.row_ids = row_ids;
  a.x = codes;
  a.N = N;
  a.L = L;
  a.M = M;
  a.S = S;
  a.pv = w.pv;
  a.pi = w.pi;
  a.work = w.work;
  a.n_work = w.n_work;
  a.q_index = w.q_index;
  a.q_slot = w.q_slot;
  const dim3 grid((unsigned)max_work(M, S, NB));
  for (int k0 = 0; k0 < k; k0 += TOPK_PASS_K) {
    const int kp = k - k0 < TOPK_PASS_K ? k - k0 : TOPK_PASS_K;
    a.k = kp;
    if (ms > 0) {
      if (k0 == 0) {
        err = launch_gemm_scan_blocks<XT, true>(a, grid, st);
      } else {
        a.ceil_v = out_v + k0 - 1;
        a.ceil_i = out_i + k0 - 1;
        a.ceil_ld = k;
        err = launch_gemm_scan_blocks<XT, true, false, true>(a, grid, st);
      }
      if (err != cudaSuccess) return (int)err;
    }
    long long want = (long long)S * kp + kp;  // one query's candidates + its best kp
    if (want > MERGE_MAX) want = MERGE_MAX;
    if (want < 2LL * kp) want = 2LL * kp;
    const int P = next_pow2((int)want);
    const size_t smem = (size_t)P * 8;
    err = cudaFuncSetAttribute(ivf_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ivf_merge_kernel<<<M, 512, smem, st>>>(S, kp, P, k, w, out_v + k0, out_i + k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int ivf_scan_topk_f32(const float* qs, const float* qlo, const int* block_tags,
                                 const int* row_ids, const float* codes, const int* sched,
                                 int M, int C, int d, int N, int NB, int L, int S, int k,
                                 void* ws, float* out_v, int* out_i, void* stream) {
  return ivf_impl<float>(qs, qlo, block_tags, row_ids, codes, sched, M, C, d, N, NB, L,
                         S, k, ws, out_v, out_i, stream);
}

extern "C" int ivf_scan_topk_u8(const float* qs, const float* qlo, const int* block_tags,
                                const int* row_ids, const uint8_t* codes, const int* sched,
                                int M, int C, int d, int N, int NB, int L, int S, int k,
                                void* ws, float* out_v, int* out_i, void* stream) {
  return ivf_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes, sched, M, C, d, N, NB,
                           L, S, k, ws, out_v, out_i, stream);
}

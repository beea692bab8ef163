// graph_scan: the fused graph beam search on Hopper (sm_90a), one hop a
// launch (graph_scan_beam_step) or the whole traversal in one launch
// (graph_beam_search).
//
// graph_scan_beam_step replaces the TPU kernel `graph_scan_beam_step` in
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
// graph_beam_search runs the reference's whole traversal, the
// `jax.lax.while_loop` of src/repro/index/graph.py (`_beam_loop`), whose
// every hop is that kernel: one block owns one query from its entry beam to
// its last hop. Each hop it picks the first `expand` expandable slots
// (unvisited, id >= 0; those with a score above NEG_INF first, then the
// rest, each in slot order, which is the loop's stable best-first pick on a
// beam sorted best first), marks them visited, reads their rows of the
// (n, R) table nbr_tbl (sorted-row space) and runs the same hop body; the
// visited flags travel with their entries through the merge. A query stops
// when no slot is expandable or at max_hops: in the batched loop such a
// query's later hops carry only pads, and a merge with no candidate leaves
// its sorted beam as it is. Its hop count goes to hops[m]; the batch's is
// the maximum.
//
// What bounds them on an H100 SXM: bytes, and at these sizes latency. At the
// graph path's shapes (M = 1024 queries, B = 128, S = expand * 28 = 28 or
// 112, d = 160, C = 48) a hop scores at most S rows per query at 2 d flops
// each: 1024 * 112 * 320 = 3.7e7 flops, 0.5 us at 67 TFLOP/s. The bytes it
// must move are the member rows' codes (d bytes u8 or 4 d f32 each, up to
// 18 MB u8 / 73 MB f32 per hop), the views of the tags those rows carry
// (4 d bytes per distinct (query, tag) pair), the neighbor rows (4 S bytes
// per query) and the beam in and out (16 B bytes per query): about 3-25 us
// at 3.35 TB/s. Each hop is a chain of dependent loads (nbr_tbl ->
// row_ids / block_tags -> codes), 44-46 hops deep on the graph path.
//
// What the design does about it: one block per query; one thread per
// neighbor row puts it into a hash set in shared memory (a repeated row is
// scored once), loads its id and block tag and tests it against the beam,
// so all rows' loads are in flight at once, and the survivors go to a
// list; one warp scores U listed rows at once with 16-byte loads where d
// and the pointers allow (a ragged d reads one element a lane), so U rows'
// loads are in flight per warp, and reads the tag's view row from the
// query's (C, d) block, which stays in L1/L2. Only member rows are read,
// never the TPU kernel's tn-row slabs: Hopper gathers a row as cheaply as a
// slab, and the TPU's slab schedule, scalar prefetch and tn rounds of
// replace-the-minimum (graph_scan.py:74-107, 142-157) exist for its
// sequential grid and DMA engine. The hop then sorts beam + candidates
// best first in shared memory (graph_scan_beam_step, whose beam may come
// in any order) or, in the traversal, whose beam stays sorted, merges them
// by rank: each entry's place is its rank in its own list plus the entries
// of the other that outrank it, a few barriers in place of a sorting
// network's 36. No (M, S) score matrix or gathered row leaves the block.
// The traversal keeps the beam, its visited flags and the hop's rows in
// shared memory for the whole search: no launch, host sync or torch op a
// hop. Blocks of 128 threads with at most 64 registers let 8 blocks share
// an SM, so the graph path's 1024 queries are resident at once on 132 SMs.
//
// Arithmetic: each score is the same fp32 sum in both kernels (rows_dot:
// per lane a chain over its depths, then a butterfly over the warp), so a
// traversal returns exactly what the per-hop loop over graph_scan_beam_step
// returns.
#include <climits>
#include <stdint.h>

#include "topk_common.cuh"
#include "error.cuh"

#define GS_THREADS 256     // graph_scan_beam_step's block
#define GB_THREADS 128     // graph_beam_search's block
#define GB_MIN_BLOCKS 8    // resident blocks an SM it is compiled for
#define GS_MAX_S 4096
#define GS_SMEM_CAP 232448  // bytes of shared memory a block may use
#define GS_U 4              // rows a warp scores at once

// bitonic_sort_best_first (topk_common.cuh) carrying a payload int with
// each (value, id) pair; ends with a barrier.
__device__ __forceinline__ void bitonic_sort_best_first_pay(float* v, int* id, int* pay,
                                                            int P) {
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
            int p = pay[i];
            pay[i] = pay[j];
            pay[j] = p;
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

// <q[u], x[u]> over d elements for U rows by one warp; every lane returns
// the sums. Each row's sum is the one-row chain (a lane's depths in order,
// then the butterfly): the U rows only put U loads in flight at once.
// `vec`: q and x are 16-byte aligned and d is a multiple of 4 (f32) or 16
// (u8).
template <int U>
__device__ __forceinline__ void rows_dot(const float* (&q)[U], const float* (&x)[U],
                                         int d, bool vec,
                                         int lane, float (&out)[U]) {
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  if (vec) {
    for (int k = lane; k < (d >> 2); k += 32) {
      float4 xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) xv[u] = __ldg(reinterpret_cast<const float4*>(x[u]) + k);
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] += dot4(reinterpret_cast<const float4*>(q[u])[k], xv[u]);
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      float xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) xv[u] = __ldg(x[u] + k);
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] += q[u][k] * xv[u];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = warp_sum(acc[u]);
}

template <int U>
__device__ __forceinline__ void rows_dot(const float* (&q)[U], const uint8_t* (&x)[U],
                                         int d, bool vec,
                                         int lane, float (&out)[U]) {
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  if (vec) {
    for (int k = lane; k < (d >> 4); k += 32) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) w[u] = __ldg(reinterpret_cast<const uint4*>(x[u]) + k);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* qk = reinterpret_cast<const float4*>(q[u]) + 4 * k;
        acc[u] += dot4_u8(qk[0], w[u].x) + dot4_u8(qk[1], w[u].y) +
                  dot4_u8(qk[2], w[u].z) + dot4_u8(qk[3], w[u].w);
      }
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      float xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) xv[u] = (float)__ldg(x[u] + k);
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] += q[u][k] * xv[u];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = warp_sum(acc[u]);
}

// The shared memory of one hop: Q (value, id) pairs -- the beam in [0, B),
// the n listed candidates in [B, B + n) and, for graph_scan_beam_step's
// sort, (-inf, -1) pads up to the power of two Q -- and, in the traversal,
// a payload each (the visited flag) and a second beam (v2, id2, pay2) for
// the merge; S hop rows, a hash set of 2 P slots (P = next_pow2(S)) that
// drops repeated rows, the listed candidates' rows and tags, and the
// list's count and the traversal's work flag.
struct HopSmem {
  float* v;
  int* id;
  int* pay;    // PAY only
  float* v2;   // PAY only
  int* id2;
  int* pay2;
  int* rows;
  int* set;
  int* lrow;
  int* ltag;
  int* count;
  __device__ __forceinline__ HopSmem(unsigned char* base, int P, int Q, int B,
                                     bool pay_on) {
    const int QA = (Q + 3) & ~3, BA = pay_on ? (B + 3) & ~3 : 0;  // 16-byte rows
    v = reinterpret_cast<float*>(base);
    id = reinterpret_cast<int*>(v + QA);  // 16-byte aligned (in_beam)
    pay = id + QA;
    v2 = reinterpret_cast<float*>(pay + (pay_on ? QA : 0));
    id2 = reinterpret_cast<int*>(v2 + BA);
    pay2 = id2 + BA;
    rows = pay2 + BA;
    set = rows + P;
    lrow = set + 2 * P;
    ltag = lrow + P;
    count = ltag + P;
  }
};

static size_t hop_smem(int P, int Q, int B, bool pay_on) {
  const size_t QA = (size_t)((Q + 3) & ~3), BA = pay_on ? (size_t)((B + 3) & ~3) : 0;
  return (QA * (pay_on ? 3 : 2) + BA * 3 + (size_t)P * 5 + 4) * sizeof(int);
}

// Whether id occurs in ids[0, B): 16-byte loads (ids is 16-byte aligned),
// every thread of a warp reading the same words, no early exit, so the
// loads pipeline.
__device__ __forceinline__ bool in_beam(const int* ids, int B, int id) {
  bool hit = false;
  const int4* w = reinterpret_cast<const int4*>(ids);
#pragma unroll 4
  for (int t = 0; t < (B >> 2); ++t) {
    const int4 v = w[t];
    hit |= (v.x == id) | (v.y == id) | (v.z == id) | (v.w == id);
  }
  for (int t = B & ~3; t < B; ++t) hit |= ids[t] == id;
  return hit;
}

// Put row into the hash set of H (a power of two >= 2 P) slots (-1 =
// free); false if it was there already (a repeated row: one copy of it is
// scored, whichever thread's).
__device__ __forceinline__ bool set_insert(int* set, int H, int row) {
  unsigned h = ((unsigned)row * 2654435761u) >> (32 - (__ffs(H) - 1));
  while (true) {
    const int prev = atomicCAS(set + h, -1, row);
    if (prev == -1) return true;
    if (prev == row) return false;
    h = (h + 1) & (unsigned)(H - 1);
  }
}

// One hop of query m, the body of both kernels. On entry s.v / s.id [0, B)
// hold the beam (any order; PAY: best first, topk_common.cuh's order, with
// its payloads), s.rows [0, S) the hop's sorted-row indices (INT_MAX =
// none, any order, repeats allowed), the set's 2 P slots are -1, *s.count
// is 0, and a barrier has passed. On exit s.v / s.id [0, B) hold the merged
// beam best first (PAY: each entry's payload beside it, 0 for a new
// candidate), after a barrier. The candidates are the distinct live rows
// whose id is not in the beam; the B best of beam + candidates are the same
// whatever order the rows came in (distinct ids, one total order).
// Profile of the traversal (graph_beam_search_profile): thread 0's clock64
// cycles summed over the blocks, by part of a hop: the pick, the rows'
// table reads, the filter (set, ids and tags, beam test, list), the
// scoring, the merge; and the whole kernel. Thread 0 also waits at each
// part's closing barrier for the block's slowest warp.
enum { GB_CLK_PICK, GB_CLK_ROWS, GB_CLK_FILTER, GB_CLK_SCORE, GB_CLK_MERGE, GB_CLK_KERNEL,
       GB_CLK_N };

struct HopClock {
  unsigned long long* acc = nullptr;  // GB_CLK_N sums in shared memory, or null
  long long t = 0;
  __device__ __forceinline__ void stamp(int part) {
    if (acc != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      acc[part] += now - t;
      t = now;
    }
  }
};

template <typename XT, bool PAY>
__device__ __forceinline__ void beam_hop(const HopSmem& s, const float* qm,
                                         const float* qlo_m, const int* block_tags,
                                         const int* row_ids, const XT* codes, int d,
                                         int layout_block, int S, int B, int P, int Q,
                                         bool vec, HopClock& clk) {
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const int row = s.rows[j];
    if (row == INT_MAX || !set_insert(s.set, 2 * P, row)) continue;
    const int cid = row_ids[row];
    const int tag = block_tags[row / layout_block];
    if (cid < 0 || in_beam(s.id, B, cid)) continue;
    const int i = atomicAdd(s.count, 1);
    s.lrow[i] = row;
    s.ltag[i] = tag;
    s.id[B + i] = cid;
  }
  __syncthreads();
  clk.stamp(GB_CLK_FILTER);
  const int n = *s.count, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i0 = warp * GS_U; i0 < n; i0 += nwarps * GS_U) {  // warp-uniform
    const float* q[GS_U];
    const XT* x[GS_U];
#pragma unroll
    for (int u = 0; u < GS_U; ++u) {
      const int i = min(i0 + u, n - 1);  // past the list: its last row again
      q[u] = qm + (size_t)s.ltag[i] * d;
      x[u] = codes + (size_t)s.lrow[i] * d;
    }
    float r[GS_U];
    rows_dot<GS_U>(q, x, d, vec, lane, r);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < GS_U; ++u)
        if (i0 + u < n) s.v[B + i0 + u] = r[u] + qlo_m[s.ltag[i0 + u]];
    }
  }
  __syncthreads();
  clk.stamp(GB_CLK_SCORE);
  if constexpr (PAY) {
    // merge by rank: an entry's place is its rank in its own list plus the
    // entries of the other list that outrank it (keys are distinct but for
    // the beam's equal (NEG_INF, -1) pads, which keep their slot order)
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const float bv = s.v[i];
      const int bi = s.id[i];
      int pos = i;
      for (int t = B; t < B + n; ++t) pos += topk_better(s.v[t], s.id[t], bv, bi);
      if (pos < B) {
        s.v2[pos] = bv;
        s.id2[pos] = bi;
        s.pay2[pos] = s.pay[i];
      }
    }
    for (int t = B + threadIdx.x; t < B + n; t += blockDim.x) {
      const float cv = s.v[t];
      const int ci = s.id[t];
      int lo = 0, hi = B;  // the beam entries that outrank it: a prefix
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (topk_better(s.v[mid], s.id[mid], cv, ci)) lo = mid + 1;
        else hi = mid;
      }
      for (int u = B; u < B + n; ++u) lo += topk_better(s.v[u], s.id[u], cv, ci);
      if (lo < B) {
        s.v2[lo] = cv;
        s.id2[lo] = ci;
        s.pay2[lo] = 0;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      s.v[i] = s.v2[i];
      s.id[i] = s.id2[i];
      s.pay[i] = s.pay2[i];
    }
    __syncthreads();
    clk.stamp(GB_CLK_MERGE);
  } else {
    for (int j = B + n + threadIdx.x; j < Q; j += blockDim.x) {
      s.v[j] = -CUDART_INF_F;
      s.id[j] = -1;
    }
    __syncthreads();
    bitonic_sort_best_first(s.v, s.id, Q);
  }
}

// One block per query: one hop.
template <typename XT>
__global__ void __launch_bounds__(GS_THREADS) graph_scan_kernel(
    const float* __restrict__ qs, const float* __restrict__ qlo,
    const int* __restrict__ block_tags, const int* __restrict__ row_ids,
    const XT* __restrict__ codes, const int* __restrict__ nbr_rows,
    const float* __restrict__ beam_vals, const int* __restrict__ beam_ids,
    int C, int d, int N, int layout_block, int S, int B, int P, int Q,
    bool vec, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  const HopSmem s(gs_smem, P, Q, B, false);
  const int m = blockIdx.x;
  const int* nr = nbr_rows + (size_t)m * S;
  for (int j = threadIdx.x; j < 2 * P; j += blockDim.x) {
    if (j < S) {
      const int r = nr[j];
      s.rows[j] = (r >= 0 && r < N) ? r : INT_MAX;
    }
    s.set[j] = -1;
  }
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    s.v[j] = beam_vals[(size_t)m * B + j];
    s.id[j] = beam_ids[(size_t)m * B + j];
  }
  if (threadIdx.x == 0) *s.count = 0;
  __syncthreads();
  HopClock clk;
  beam_hop<XT, false>(s, qs + (size_t)m * C * d, qlo + (size_t)m * C, block_tags,
                      row_ids, codes, d, layout_block, S, B, P, Q, vec, clk);
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    out_v[(size_t)m * B + e] = s.v[e];
    out_i[(size_t)m * B + e] = s.id[e];
  }
}

// One block per query: the whole traversal from the entry beam (beam_vals /
// beam_ids, slot order as scored) for up to max_hops hops, expanding E
// slots a hop through the (n_tbl, R) table nbr_tbl. Shared memory: the hop's
// (HopSmem, with the visited flags as payload), then E picked slots and E
// pick flags (PROF: then the profile's GB_CLK_N sums, 8-byte aligned).
template <typename XT, bool PROF>
__global__ void __launch_bounds__(GB_THREADS, GB_MIN_BLOCKS) graph_search_kernel(
    const float* __restrict__ qs, const float* __restrict__ qlo,
    const int* __restrict__ block_tags, const int* __restrict__ row_ids,
    const XT* __restrict__ codes, const int* __restrict__ nbr_tbl, int n_tbl, int R,
    const float* __restrict__ beam_vals, const int* __restrict__ beam_ids, int C,
    int d, int N, int layout_block, int B, int E, int max_hops, int P, int Q, bool vec,
    float* __restrict__ out_v, int* __restrict__ out_i, int* __restrict__ out_hops,
    unsigned long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  const HopSmem s(gs_smem, P, Q, B, true);
  int* work = s.count + 1;
  int* sel = s.count + 4;  // E slots
  int* sel_ok = sel + E;   // E flags
  HopClock clk;
  if constexpr (PROF) {
    clk.acc = reinterpret_cast<unsigned long long*>(
        (reinterpret_cast<uintptr_t>(sel_ok + E) + 7) & ~(uintptr_t)7);
    if (threadIdx.x < GB_CLK_N) clk.acc[threadIdx.x] = 0;
    clk.t = clock64();
  }
  const long long t_kernel = clk.t;
  const int m = blockIdx.x, S = E * R, lane = threadIdx.x & 31;
  const float* qm = qs + (size_t)m * C * d;
  const float* qlo_m = qlo + (size_t)m * C;

  // the entry beam in the loop's first pick order (value descending, then
  // slot): sort (value, slot) carrying the id, then keep the ids and clear
  // the payload (nothing visited)
  for (int j = threadIdx.x; j < Q; j += blockDim.x) {
    const bool in = j < B;
    s.v[j] = in ? beam_vals[(size_t)m * B + j] : -CUDART_INF_F;
    s.id[j] = in ? j : -1;
    s.pay[j] = in ? beam_ids[(size_t)m * B + j] : -1;
  }
  __syncthreads();
  bitonic_sort_best_first_pay(s.v, s.id, s.pay, Q);
  for (int j = threadIdx.x; j < Q; j += blockDim.x) {
    s.id[j] = s.pay[j];
    s.pay[j] = 0;
  }
  __syncthreads();

  int hops = 0;
  clk.stamp(GB_CLK_PICK);
  for (; hops < max_hops; ++hops) {
    if (threadIdx.x < 32) {
      // the loop's pick on a beam sorted best first: expandable slots with
      // a score above NEG_INF in slot order, then every other slot in slot
      // order; the first E
      const unsigned full = 0xffffffffu;
      int found = 0;
      bool any = false;
      for (int c0 = 0; c0 < B; c0 += 32) {
        const int j = c0 + lane;
        const bool x = j < B && s.id[j] >= 0 && s.pay[j] == 0;
        any |= __any_sync(full, x);
        unsigned mask = __ballot_sync(full, x && s.v[j] > NEG_INF_F);
        while (mask && found < E) {
          if (lane == 0) sel[found] = c0 + __ffs(mask) - 1;
          mask &= mask - 1;
          ++found;
        }
      }
      for (int c0 = 0; c0 < B && found < E; c0 += 32) {
        const int j = c0 + lane;
        const bool a = j < B && s.id[j] >= 0 && s.pay[j] == 0 && s.v[j] > NEG_INF_F;
        unsigned mask = __ballot_sync(full, j < B && !a);
        while (mask && found < E) {
          if (lane == 0) sel[found] = c0 + __ffs(mask) - 1;
          mask &= mask - 1;
          ++found;
        }
      }
      __syncwarp();
      // expand 1 gates on the query's work (the loop's classic rule), more
      // on each picked slot's own
      for (int e = lane; e < E; e += 32) {
        const int j = sel[e];
        sel_ok[e] = E == 1 ? any : (s.id[j] >= 0 && s.pay[j] == 0);
      }
      __syncwarp();
      for (int e = lane; e < E; e += 32)
        if (sel_ok[e]) s.pay[sel[e]] = 1;
      if (lane == 0) {
        *work = any;
        *s.count = 0;
      }
    }
    __syncthreads();
    clk.stamp(GB_CLK_PICK);
    if (!*work) break;
    for (int j = threadIdx.x; j < 2 * P; j += blockDim.x) {
      if (j < S) {
        const int e = j / R;
        int r = INT_MAX;
        if (sel_ok[e]) {
          const int vid = max(s.id[sel[e]], 0);  // -1 reads vertex 0, as the loop
          const int x = vid < n_tbl ? nbr_tbl[(size_t)vid * R + (j - e * R)] : -1;
          if (x >= 0 && x < N) r = x;
        }
        s.rows[j] = r;
      }
      s.set[j] = -1;
    }
    __syncthreads();
    // the merge by rank needs the beam best first: the entry beam was in
    // pick order (ties by slot), so order it once, after its first pick
    // ([B, Q) still holds the (-inf, -1) pads then)
    if (hops == 0) bitonic_sort_best_first_pay(s.v, s.id, s.pay, Q);
    clk.stamp(GB_CLK_ROWS);
    beam_hop<XT, true>(s, qm, qlo_m, block_tags, row_ids, codes, d, layout_block, S, B,
                       P, Q, vec, clk);
  }
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    out_v[(size_t)m * B + e] = s.v[e];
    out_i[(size_t)m * B + e] = s.id[e];
  }
  if (threadIdx.x == 0) out_hops[m] = hops;
  if constexpr (PROF) {
    if (threadIdx.x == 0) {
      clk.acc[GB_CLK_KERNEL] = clock64() - t_kernel;
      for (int c = 0; c < GB_CLK_N; ++c) atomicAdd(clocks + c, clk.acc[c]);
    }
  }
}

// Shared memory of one block. graph_scan_beam_step: Q = next_pow2(B + S)
// (value, id) pairs and P = next_pow2(S) rows (B + S <= 16384 at S <=
// 4096). graph_beam_search: the same with a payload a pair and the second
// beam, then the E picks and flags.
static size_t graph_scan_smem(int S, int B) {
  return hop_smem(next_pow2(S > 0 ? S : 1), next_pow2(B + S), B, false);
}

static size_t graph_search_smem(int S, int B, int E) {
  return hop_smem(next_pow2(S > 0 ? S : 1), next_pow2(B + S), B, true) +
         (size_t)E * 2 * sizeof(int) + 8 + GB_CLK_N * 8;
}

extern "C" long long graph_scan_smem_bytes(int S, int B) {
  return (long long)graph_scan_smem(S, B);
}

extern "C" long long graph_search_smem_bytes(int S, int B, int E) {
  return (long long)graph_search_smem(S, B, E);
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename XT>
static bool vec_loads(const float* qs, const XT* codes, int d) {
  const int per_vec = sizeof(XT) == 1 ? 16 : 4;  // elements per 16-byte load
  return d % per_vec == 0 && aligned16(qs) && aligned16(codes);
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
  const size_t smem = graph_scan_smem(S, B);
  if (smem > GS_SMEM_CAP) return (int)cudaErrorInvalidValue;
  const int P = next_pow2(S > 0 ? S : 1);
  const int Q = next_pow2(B + S);
  cudaError_t err = open_dynamic_smem((const void*)graph_scan_kernel<XT>);
  if (err != cudaSuccess) return (int)err;
  graph_scan_kernel<XT><<<M, GS_THREADS, smem, (cudaStream_t)stream>>>(
      qs, qlo, block_tags, row_ids, codes, nbr_rows, beam_vals, beam_ids, C, d,
      N, layout_block, S, B, P, Q, vec_loads(qs, codes, d), out_v, out_i);
  return (int)cudaGetLastError();
}

template <typename XT, bool PROF = false>
static int graph_search_impl(const float* qs, const float* qlo, const int* block_tags,
                             const int* row_ids, const XT* codes, const int* nbr_tbl,
                             int n_tbl, int R, const float* beam_vals,
                             const int* beam_ids, int M, int C, int d, int N,
                             int layout_block, int B, int E, int max_hops, float* out_v,
                             int* out_i, int* out_hops, unsigned long long* clocks,
                             void* stream) {
  if (M <= 0) return 0;
  const long long S = (long long)E * R;
  if (R < 0 || E < 1 || E > B || S > GS_MAX_S || layout_block <= 0 || max_hops < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = graph_search_smem((int)S, B, E);
  if (smem > GS_SMEM_CAP) return (int)cudaErrorInvalidValue;
  const int P = next_pow2(S > 0 ? (int)S : 1);
  const int Q = next_pow2(B + (int)S);
  auto kernel = graph_search_kernel<XT, PROF>;
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<M, GB_THREADS, smem, (cudaStream_t)stream>>>(
      qs, qlo, block_tags, row_ids, codes, nbr_tbl, n_tbl, R, beam_vals, beam_ids, C, d,
      N, layout_block, B, E, max_hops, P, Q, vec_loads(qs, codes, d), out_v, out_i,
      out_hops, clocks);
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

extern "C" int graph_beam_search_f32(
    const float* qs, const float* qlo, const int* block_tags, const int* row_ids,
    const float* codes, const int* nbr_tbl, int n_tbl, int R, const float* beam_vals,
    const int* beam_ids, int M, int C, int d, int N, int layout_block, int B, int E,
    int max_hops, float* out_v, int* out_i, int* out_hops, void* stream) {
  return graph_search_impl<float>(qs, qlo, block_tags, row_ids, codes, nbr_tbl, n_tbl,
                                  R, beam_vals, beam_ids, M, C, d, N, layout_block, B,
                                  E, max_hops, out_v, out_i, out_hops, nullptr, stream);
}

extern "C" int graph_beam_search_u8(
    const float* qs, const float* qlo, const int* block_tags, const int* row_ids,
    const uint8_t* codes, const int* nbr_tbl, int n_tbl, int R, const float* beam_vals,
    const int* beam_ids, int M, int C, int d, int N, int layout_block, int B, int E,
    int max_hops, float* out_v, int* out_i, int* out_hops, void* stream) {
  return graph_search_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes, nbr_tbl,
                                    n_tbl, R, beam_vals, beam_ids, M, C, d, N,
                                    layout_block, B, E, max_hops, out_v, out_i,
                                    out_hops, nullptr, stream);
}

// graph_beam_search with its hops profiled: the arguments of
// graph_beam_search_f32 / _u8 (codes u8 when u8 != 0), then clocks
// (GB_CLK_N sums, zeroed by the caller).
extern "C" int graph_beam_search_profile(
    const float* qs, const float* qlo, const int* block_tags, const int* row_ids,
    const void* codes, int u8, const int* nbr_tbl, int n_tbl, int R,
    const float* beam_vals, const int* beam_ids, int M, int C, int d, int N,
    int layout_block, int B, int E, int max_hops, float* out_v, int* out_i,
    int* out_hops, unsigned long long* clocks, void* stream) {
  if (u8)
    return graph_search_impl<uint8_t, true>(
        qs, qlo, block_tags, row_ids, static_cast<const uint8_t*>(codes), nbr_tbl, n_tbl,
        R, beam_vals, beam_ids, M, C, d, N, layout_block, B, E, max_hops, out_v, out_i,
        out_hops, clocks, stream);
  return graph_search_impl<float, true>(
      qs, qlo, block_tags, row_ids, static_cast<const float*>(codes), nbr_tbl, n_tbl, R,
      beam_vals, beam_ids, M, C, d, N, layout_block, B, E, max_hops, out_v, out_i,
      out_hops, clocks, stream);
}

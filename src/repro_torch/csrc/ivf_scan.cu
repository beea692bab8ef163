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
// carry id -1 (k above the valid row count, an all-pad schedule). A block
// listed twice is scored twice, as the reference does.
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
// (27 / 108 ms of bytes alone). This design scans RUNS: a run is a maximal
// sequence of a query's valid slots s, s + 1, ... whose blocks are
// consecutive (sched[s + 1] = sched[s] + 1) and carry one tag. On the main
// path each probed list is one run (its blocks are contiguous and share the
// list's tag; on a stream, with its slack blocks). The queries whose runs
// start at one block are scanned together, each keeping ONE running top-k
// list for its whole run (or for one piece of it), not one a layout block:
// a fresh list of k = 100 over a 4096-row block takes ~470 insertions, one
// over a list's ~42,000 rows ~700. Kernels, none with a host sync:
//   1. ivf_runs_kernel (one warp a query): the query's runs (first block,
//      blocks), and for each run its rank in the list of runs that start at
//      its first block b0 (atomics), the longest such run per b0;
//   2. ivf_plan_kernel (one block): cuts each b0's runs into pieces of whole
//      layout blocks, so that the work (IP_TM-query chunks x rows) comes to
//      about IVF_PIECES_PER_SM items an SM, and lays the items (chunk, piece)
//      out largest first (a counting sort by piece size), so that the
//      persistent scan's blocks end together;
//   3. ivf_scatter_kernel (one warp a query): each run's entry into its
//      b0's list, with the partial slots of its pieces (a query's slots are
//      its runs' pieces in schedule order: at most its valid slots, S);
//   4. ip_list_kernel (ip_scan.cuh; one block an SM, taking items through
//      an atomic counter): the pipelined 8 x 16 register-tiled fp32 scan
//      over the piece's rows (512-row tiles cut at the piece's end, not at
//      layout-block ends), queries staged through the index list, ids with
//      each tile's first chunk, the fold filtered by each query's k-th value
//      and (k >= IP_FLOORS_MIN_K) by floors all slots of a query share;
//   5. ivf_merge_kernel: per query, the entries of its slots' lists that
//      are not below the best slot k-th entry, bitonic-sorted in shared
//      memory (chunks of at most MERGE_MAX).
// A k above TOPK_PASS_K repeats steps 4-5 once per TOPK_PASS_K output
// columns, each pass under the previous one's ceiling (topk_common.cuh).
// A block scheduled twice lists its rows in two slots of a query, so the
// ceiling names its entry's slot too and the merge orders equal entries by
// slot: the order is total, and no copy is lost at a pass boundary.
// All arithmetic is the ascending fp32 FMA chain then + the offset, so
// scores and lists are bit-identical to the scan_gemm.cuh kernel this
// replaces. No TF32, no tensor cores.
#include "error.cuh"
#include "ip_scan.cuh"

constexpr int IVF_THREADS = 256;
constexpr int IVF_PLAN_THREADS = 1024;
constexpr int IVF_SIZE_BINS = 1024;    // piece sizes (blocks) the sort tells apart
constexpr int IVF_PIECES_PER_SM = 4;   // work items an SM, about

struct Workspace {
  int* run_first;   // (M, S) first block of query m's run r
  int* run_blocks;  // (M, S) its blocks (first: its last block)
  int* run_rank;    // (M, S) its rank in its first block's list
  int* nruns;       // (M,)
  int* nslots;      // (M,) partial slots of each query
  int* ceil_slot;   // (M,) the slot of the last entry a pass wrote
  int* grp_count;   // (NB,) runs that start at each block
  int* grp_blocks;  // (NB,) blocks of the longest of them
  int* grp_pieces;  // (NB,) pieces they are cut into
  int* grp_off;     // (NB,) first entry of each block's list
  int* q_index;     // (M * S,) entries grouped by first block: query
  int* q_slot;      //                                           first slot
  int* q_blocks;    //                                           blocks
  int4* work;       // (W_max,) items {b0, e0, cnt, piece}
  int* n_work;      // (1,) items
  int* next;        // (1,) the scan's item counter
  int* floors;      // (M, 2 S) the shared floors
  float* pv;        // (M, S, min(k, TOPK_PASS_K)) partial lists
  int* pi;
};

static size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// Items the plan may lay out: with every run in one piece there are at most
// ceil(entries / IP_TM) + (first blocks) of them; the pieces add at most
// ~2 IVF_PIECES_PER_SM an SM (ivf_plan_kernel doubles the piece size until
// the items fit).
static size_t max_work(int M, int S, int NB, int sms) {
  const size_t ms = (size_t)M * S;
  return ms / IP_TM + 1 + (ms < (size_t)NB ? ms : (size_t)NB) +
         4 * (size_t)IVF_PIECES_PER_SM * sms;
}

// Carve the workspace; returns its size in bytes (base may be null).
static size_t carve(char* base, int M, int S, int NB, int k, int sms, Workspace* w) {
  const size_t ms = (size_t)M * S, kp = k < TOPK_PASS_K ? k : TOPK_PASS_K;
  const size_t sizes[] = {ms * 4, ms * 4, ms * 4, (size_t)M * 4, (size_t)M * 4, (size_t)M * 4,
                          (size_t)NB * 4, (size_t)NB * 4, (size_t)NB * 4, (size_t)NB * 4,
                          ms * 4, ms * 4, ms * 4, max_work(M, S, NB, sms) * 16, 4, 4,
                          ms * 8, ms * kp * 4, ms * kp * 4};
  void** slots[] = {(void**)&w->run_first, (void**)&w->run_blocks, (void**)&w->run_rank,
                    (void**)&w->nruns, (void**)&w->nslots, (void**)&w->ceil_slot,
                    (void**)&w->grp_count,
                    (void**)&w->grp_blocks, (void**)&w->grp_pieces, (void**)&w->grp_off,
                    (void**)&w->q_index, (void**)&w->q_slot, (void**)&w->q_blocks,
                    (void**)&w->work, (void**)&w->n_work, (void**)&w->next,
                    (void**)&w->floors, (void**)&w->pv, (void**)&w->pi};
  static_assert(sizeof(sizes) / sizeof(sizes[0]) == sizeof(slots) / sizeof(slots[0]),
                "one size a slot");
  size_t off = 0;
  for (size_t i = 0; i < sizeof(sizes) / sizeof(sizes[0]); ++i) {
    *slots[i] = base ? base + off : nullptr;
    off += align256(sizes[i]);
  }
  return off;
}

// Slot i of query m's schedule: its block, or -1 (pad or out of range).
__device__ __forceinline__ int ivf_block(const int* sched, int S, int NB, int m, int i) {
  const int b = i >= 0 && i < S ? sched[(size_t)m * S + i] : -1;
  return b >= 0 && b < NB ? b : -1;
}

// One warp a query: slot s starts a run unless it continues slot s - 1's
// (both valid, consecutive blocks, one tag), and ends one unless slot s + 1
// continues it; the r-th start and the r-th end bound run r.
__global__ void ivf_runs_kernel(const int* __restrict__ sched,
                                const int* __restrict__ block_tags, int M, int S, int NB,
                                Workspace w) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;  // whole warps
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  int starts = 0, ends = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const int b = ivf_block(sched, S, NB, m, s);
    const int bp = ivf_block(sched, S, NB, m, s - 1), bn = ivf_block(sched, S, NB, m, s + 1);
    const int tg = b >= 0 ? block_tags[b] : 0;
    const bool cont = b >= 0 && bp >= 0 && b == bp + 1 && tg == block_tags[bp];
    const bool cont_next = b >= 0 && bn >= 0 && bn == b + 1 && block_tags[bn] == tg;
    const unsigned ms = __ballot_sync(full, b >= 0 && !cont);
    const unsigned me = __ballot_sync(full, b >= 0 && !cont_next);
    if (b >= 0 && !cont) w.run_first[(size_t)m * S + starts + __popc(ms & below)] = b;
    if (b >= 0 && !cont_next) w.run_blocks[(size_t)m * S + ends + __popc(me & below)] = b;
    starts += __popc(ms);
    ends += __popc(me);
  }
  __syncwarp();
  for (int r = lane; r < starts; r += 32) {
    const size_t e = (size_t)m * S + r;
    const int first = w.run_first[e], blocks = w.run_blocks[e] - first + 1;
    w.run_blocks[e] = blocks;
    w.run_rank[e] = atomicAdd(&w.grp_count[first], 1);
    atomicMax(&w.grp_blocks[first], blocks);
  }
  if (lane == 0) w.nruns[m] = starts;
}

// Exclusive prefix sum over the block; *total gets the block's sum.
template <typename T>
__device__ T block_scan_excl(T x, T* sh, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T v = lane < nw ? sh[lane] : 0;
    T wi = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < nw) sh[lane] = wi - v;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const T res = sh[warp] + incl - x;
  *total = sh[32];
  __syncthreads();
  return res;
}

template <typename T>
__device__ T block_sum(T x, T* sh) {
  T total;
  block_scan_excl(x, sh, &total);
  return total;
}

__device__ int block_max(int x, int* sh) {
  x = __reduce_max_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : INT_MIN;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0) sh[32] = v;
  }
  __syncthreads();
  x = sh[32];
  __syncthreads();
  return x;
}

// The rows of the longest run that starts at block b0; the IP_TM-query
// chunks of `count` runs.
__device__ __forceinline__ long long ivf_group_rows(const Workspace& w, int b0, int L, int N) {
  const long long r0 = (long long)b0 * L, r1 = r0 + (long long)w.grp_blocks[b0] * L;
  return (r1 < N ? r1 : N) - r0;
}

__device__ __forceinline__ int ivf_chunks(int count) { return (count + IP_TM - 1) / IP_TM; }

// One block of IVF_PLAN_THREADS. Pieces of pb blocks: pb is the work (query
// chunks x rows) over IVF_PIECES_PER_SM * sms items, in whole blocks, at
// least 1, doubled until the items fit the workspace (w_max). Run group b0
// with longest run nbk blocks is cut into np = ceil(nbk / pb) pieces, piece
// j its blocks [nbk j / np, nbk (j + 1) / np); its items (chunk, piece) are
// written piece by piece, each piece's chunks adjacent (they read the same
// rows), in the order of piece sizes, largest first.
__global__ void __launch_bounds__(IVF_PLAN_THREADS) ivf_plan_kernel(int NB, int L, int N,
                                                                    int sms, long long w_max,
                                                                    Workspace w) {
  __shared__ long long shl[33];
  __shared__ int shi[33];
  __shared__ int cursor[IVF_SIZE_BINS];
  const int t = threadIdx.x;
  long long work = 0;
  int longest = 1;
  for (int b = t; b < NB; b += blockDim.x) {
    const int c = w.grp_count[b];
    if (c > 0) {
      work += ivf_chunks(c) * ivf_group_rows(w, b, L, N);
      longest = max(longest, w.grp_blocks[b]);
    }
  }
  work = block_sum(work, shl);
  longest = block_max(longest, shi);
  const long long per_item = (long long)IVF_PIECES_PER_SM * sms * L;
  int pb = (int)max(1LL, min((long long)longest, (work + per_item - 1) / per_item));
  while (true) {
    long long items = 0;
    for (int b = t; b < NB; b += blockDim.x) {
      const int c = w.grp_count[b];
      if (c > 0) items += (long long)ivf_chunks(c) * ((w.grp_blocks[b] + pb - 1) / pb);
    }
    items = block_sum(items, shl);
    if (items <= w_max || pb >= longest) break;
    pb = min(2 * pb, longest);
  }
  // counting sort of the items by piece size (blocks), largest first
  for (int i = t; i < IVF_SIZE_BINS; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  auto bin = [](int size) { return min(size, IVF_SIZE_BINS - 1); };
  for (int b = t; b < NB; b += blockDim.x) {
    const int c = w.grp_count[b];
    if (c == 0) continue;
    const int nbk = w.grp_blocks[b], np = (nbk + pb - 1) / pb, q = nbk / np;
    const int big = nbk - q * np;  // pieces of q + 1 blocks; the rest have q
    if (big > 0) atomicAdd(&cursor[bin(q + 1)], big * ivf_chunks(c));
    if (np > big) atomicAdd(&cursor[bin(q)], (np - big) * ivf_chunks(c));
  }
  __syncthreads();
  static_assert(IVF_SIZE_BINS == IVF_PLAN_THREADS, "one size bin a thread");
  {
    const int i = IVF_SIZE_BINS - 1 - t;  // thread t: the t-th largest size
    int total;
    const int start = block_scan_excl(cursor[i], shi, &total);
    cursor[i] = start;
    if (t == 0) *w.n_work = total;
  }
  __syncthreads();
  int carry = 0;
  for (int b0 = 0; b0 < NB; b0 += blockDim.x) {
    const int b = b0 + t;
    const int c = b < NB ? w.grp_count[b] : 0;
    int total;
    const int off = carry + block_scan_excl(c, shi, &total);
    carry += total;
    if (b >= NB) continue;
    w.grp_off[b] = off;
    if (c == 0) {
      w.grp_pieces[b] = 1;
      continue;
    }
    const int nbk = w.grp_blocks[b], np = (nbk + pb - 1) / pb, qc = ivf_chunks(c);
    w.grp_pieces[b] = np;
    for (int j = 0; j < np; ++j) {
      const int size = (int)((long long)nbk * (j + 1) / np - (long long)nbk * j / np);
      const int pos = atomicAdd(&cursor[bin(size)], qc);
      for (int i = 0; i < qc; ++i)
        w.work[pos + i] = make_int4(b, off + i * IP_TM, min(IP_TM, c - i * IP_TM), j);
    }
  }
}

// One warp a query: run r (first block b0, nq blocks) is in the pieces j of
// b0 whose first block nbk j / np lies below nq: ceil(nq np / nbk) of them
// (at most nq), which take the query's next partial slots.
__global__ void ivf_scatter_kernel(int M, int S, Workspace w) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;  // whole warps
  const int nrun = w.nruns[m];
  int base = 0;
  for (int r0 = 0; r0 < nrun; r0 += 32) {
    const int r = r0 + lane;
    int pq = 0, first = 0, nq = 0;
    if (r < nrun) {
      const size_t e = (size_t)m * S + r;
      first = w.run_first[e];
      nq = w.run_blocks[e];
      const int nbk = w.grp_blocks[first], np = w.grp_pieces[first];
      pq = (int)(((long long)nq * np + nbk - 1) / nbk);
    }
    int incl = pq;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (r < nrun) {
      const int pos = w.grp_off[first] + w.run_rank[(size_t)m * S + r];
      w.q_index[pos] = m;
      w.q_slot[pos] = base + incl - pq;
      w.q_blocks[pos] = nq;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) w.nslots[m] = base;
}

// The merge's order: value descending, id ascending (-1 last), then partial
// slot ascending. The slot orders the copies of a row listed in two slots
// of a query (a block scheduled twice), so that the order is total and a
// later pass's ceiling (value, id, slot) cuts between such copies.
__device__ __forceinline__ bool ivf_better(float v1, int i1, int s1, float v2, int i2,
                                           int s2) {
  return topk_better(v1, i1, v2, i2) || (v1 == v2 && i1 == i2 && s1 < s2);
}

// Sort P (a power of two) (value, id, slot) triples in shared memory, best
// first, with the whole block; a bitonic network. Ends with a barrier.
__device__ void ivf_sort(float* v, int* id, int* sl, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const float a_v = v[i], b_v = v[j];
          const int a_i = id[i], b_i = id[j], a_s = sl[i], b_s = sl[j];
          if (desc ? ivf_better(b_v, b_i, b_s, a_v, a_i, a_s)
                   : ivf_better(a_v, a_i, a_s, b_v, b_i, b_s)) {
            v[i] = b_v;
            v[j] = a_v;
            id[i] = b_i;
            id[j] = a_i;
            sl[i] = b_s;
            sl[j] = a_s;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Per query: a slot whose list is full holds k entries at least as good as
// its k-th, so a candidate strictly below the best slot k-th entry (thr) can
// not be in the top k. The running best k sit in [0, k); each round takes
// the next (at most P - k) of the query's partial-list entries, keeps those
// not below thr behind them and sorts the smallest power of two that holds
// them. Query m's k entries go to out[m * ldo, m * ldo + k), the slot of
// its last to w.ceil_slot[m].
__global__ void ivf_merge_kernel(int S, int k, int P, int ldo, Workspace w, float* out_v,
                                 int* out_i) {
  extern __shared__ unsigned char merge_smem[];
  float* v = reinterpret_cast<float*>(merge_smem);
  int* id = reinterpret_cast<int*>(v + P);
  int* sl = id + P;
  __shared__ float thr_v[32];
  __shared__ int thr_i[32], n_kept;
  const int m = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsl = w.nslots[m];
  const long long total = (long long)nsl * k;
  const float* src_v = w.pv + (size_t)m * S * k;
  const int* src_i = w.pi + (size_t)m * S * k;
  float tv = -CUDART_INF_F;  // the best slot k-th entry
  int ti = -1;
  for (int s2 = threadIdx.x; s2 < nsl; s2 += blockDim.x) {
    const float cv = src_v[(size_t)s2 * k + k - 1];
    const int ci = src_i[(size_t)s2 * k + k - 1];
    if (topk_better(cv, ci, tv, ti)) {
      tv = cv;
      ti = ci;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, tv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
    if (topk_better(ov, oi, tv, ti)) {
      tv = ov;
      ti = oi;
    }
  }
  if (lane == 0) {
    thr_v[warp] = tv;
    thr_i[warp] = ti;
  }
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    v[e] = NEG_INF_F;
    id[e] = -1;
    sl[e] = INT_MAX;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int x = 1; x < (int)(blockDim.x >> 5); ++x) {
      if (topk_better(thr_v[x], thr_i[x], thr_v[0], thr_i[0])) {
        thr_v[0] = thr_v[x];
        thr_i[0] = thr_i[x];
      }
    }
  }
  __syncthreads();
  tv = thr_v[0];
  ti = thr_i[0];
  const int chunk = P - k;
  for (long long c0 = 0; c0 < total; c0 += chunk) {
    const int n = (int)(total - c0 < chunk ? total - c0 : chunk);
    if (threadIdx.x == 0) n_kept = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const float cv = src_v[c0 + e];
      const int ci = src_i[c0 + e];
      if (!topk_better(tv, ti, cv, ci)) {
        const int at = k + atomicAdd(&n_kept, 1);
        v[at] = cv;
        id[at] = ci;
        sl[at] = (int)((c0 + e) / k);
      }
    }
    __syncthreads();
    const int kept = n_kept;
    int pc = 2;
    while (pc < k + kept) pc <<= 1;
    for (int e = k + kept + threadIdx.x; e < pc; e += blockDim.x) {
      v[e] = -CUDART_INF_F;
      id[e] = -1;
      sl[e] = INT_MAX;
    }
    __syncthreads();
    ivf_sort(v, id, sl, pc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    out_v[(size_t)m * ldo + e] = v[e];
    out_i[(size_t)m * ldo + e] = id[e];
  }
  if (threadIdx.x == 0) w.ceil_slot[m] = sl[k - 1];
}

extern "C" long long ivf_scan_workspace_bytes(int M, int S, int NB, int k, int sms) {
  Workspace w;
  return (long long)carve(nullptr, M, S, NB, k, sms, &w);
}

// The plan (kernels 1-3) for M > 0.
static cudaError_t ivf_plan(const int* sched, const int* block_tags, int M, int S, int NB,
                            int L, int N, int sms, const Workspace& w, cudaStream_t st) {
  cudaError_t err;
  if (NB > 0) {
    if ((err = cudaMemsetAsync(w.grp_count, 0, (size_t)NB * 4, st)) != cudaSuccess) return err;
    if ((err = cudaMemsetAsync(w.grp_blocks, 0, (size_t)NB * 4, st)) != cudaSuccess)
      return err;
  }
  const unsigned warps = IVF_THREADS / 32, grid = (unsigned)((M + warps - 1) / warps);
  if (S > 0) {
    ivf_runs_kernel<<<grid, IVF_THREADS, 0, st>>>(sched, block_tags, M, S, NB, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else if ((err = cudaMemsetAsync(w.nruns, 0, (size_t)M * 4, st)) != cudaSuccess) {
    return err;
  }
  ivf_plan_kernel<<<1, IVF_PLAN_THREADS, 0, st>>>(NB, L, N, sms,
                                                  (long long)max_work(M, S, NB, sms), w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ivf_scatter_kernel<<<grid, IVF_THREADS, 0, st>>>(M, S, w);
  return cudaGetLastError();
}

// The whole call (clocks null), or the plan and the first pass's scan
// alone with its fold profile summed into clocks[IP_CLK_N].
template <typename XT>
static int ivf_impl(const float* qs, const float* qlo, const int* block_tags,
                    const int* row_ids, const XT* codes, const int* sched, int M, int C,
                    int d, int N, int NB, int L, int S, int k, int sms, void* ws,
                    float* out_v, int* out_i, unsigned long long* clocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Workspace w;
  carve(static_cast<char*>(ws), M, S, NB, k, sms, &w);
  cudaError_t err = ivf_plan(sched, block_tags, M, S, NB, L, N, sms, w, st);
  if (err != cudaSuccess) return (int)err;
  IpListArgs a;
  static_cast<IpSegArgs&>(a) = ip_seg_args(qs, codes, M, N, d, k, S, w.pv, w.pi, w.floors);
  a.q_ld = (long long)C * d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = block_tags;
  a.row_ids = row_ids;
  a.L = L;
  a.clocks = clocks;
  a.work = w.work;
  a.n_work = w.n_work;
  a.next = w.next;
  a.q_index = w.q_index;
  a.q_slot = w.q_slot;
  a.q_blocks = w.q_blocks;
  a.nslots = w.nslots;
  a.grp_blocks = w.grp_blocks;
  a.grp_pieces = w.grp_pieces;
  a.ceil_slot = w.ceil_slot;
  for (int k0 = 0; k0 < k; k0 += TOPK_PASS_K) {
    const int kp = k - k0 < TOPK_PASS_K ? k - k0 : TOPK_PASS_K;
    a.k = kp;
    if (k0 == 0) {
      err = launch_ip_list_pass<XT, false>(a, sms, st);
    } else {
      a.ceil_v = out_v + k0 - 1;
      a.ceil_i = out_i + k0 - 1;
      a.ceil_ld = k;
      err = launch_ip_list_pass<XT, true>(a, sms, st);
    }
    if (err != cudaSuccess || clocks != nullptr) return (int)err;
    long long want = (long long)S * kp + kp;  // one query's candidates + its best kp
    if (want > MERGE_MAX) want = MERGE_MAX;
    if (want < 2LL * kp) want = 2LL * kp;
    const int P = next_pow2((int)want);
    const size_t smem = (size_t)P * 12;
    err = open_dynamic_smem((const void*)ivf_merge_kernel);
    if (err != cudaSuccess) return (int)err;
    ivf_merge_kernel<<<M, 512, smem, st>>>(S, kp, P, k, w, out_v + k0, out_i + k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int ivf_scan_topk_f32(const float* qs, const float* qlo, const int* block_tags,
                                 const int* row_ids, const float* codes, const int* sched,
                                 int M, int C, int d, int N, int NB, int L, int S, int k,
                                 int sms, void* ws, float* out_v, int* out_i, void* stream) {
  return ivf_impl<float>(qs, qlo, block_tags, row_ids, codes, sched, M, C, d, N, NB, L, S,
                         k, sms, ws, out_v, out_i, nullptr, stream);
}

extern "C" int ivf_scan_topk_u8(const float* qs, const float* qlo, const int* block_tags,
                                const int* row_ids, const uint8_t* codes, const int* sched,
                                int M, int C, int d, int N, int NB, int L, int S, int k,
                                int sms, void* ws, float* out_v, int* out_i, void* stream) {
  return ivf_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes, sched, M, C, d, N, NB, L,
                           S, k, sms, ws, out_v, out_i, nullptr, stream);
}

// The plan and one scan pass (k <= TOPK_PASS_K; no merge) with the scan's
// fold profile summed into clocks[IP_CLK_N] (zeroed by the caller).
extern "C" int ivf_scan_profile(const float* qs, const float* qlo, const int* block_tags,
                                const int* row_ids, const void* codes, int u8,
                                const int* sched, int M, int C, int d, int N, int NB, int L,
                                int S, int k, int sms, void* ws,
                                unsigned long long* clocks, void* stream) {
  if (k < 1 || k > TOPK_PASS_K) return (int)cudaErrorInvalidValue;
  if (u8)
    return ivf_impl<uint8_t>(qs, qlo, block_tags, row_ids,
                             static_cast<const uint8_t*>(codes), sched, M, C, d, N, NB, L,
                             S, k, sms, ws, nullptr, nullptr, clocks, stream);
  return ivf_impl<float>(qs, qlo, block_tags, row_ids, static_cast<const float*>(codes),
                         sched, M, C, d, N, NB, L, S, k, sms, ws, nullptr, nullptr, clocks,
                         stream);
}

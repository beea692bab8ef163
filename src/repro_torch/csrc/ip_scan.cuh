// Pipelined fp32 scan + per-block top-k lists or dense scores, one kernel
// body for three users:
//   * plain MIPS (V = 0): ip_topk.cu;
//   * per-segment views (V = 1 or 2): the tag-sorted layout of
//     gleanvec_sq.cu, whose layout blocks of L rows each score against one
//     query view q[m, tag] and add its offset q_lo[m, tag], with ids read
//     through row_ids (-1 = padding, never listed);
//   * dense scores (V = 1 or 2, DENSE): dense_scores.cu's sq_dot, the
//     one-view case (C = 1), and the sorted dense gleanvec_sq, with a store
//     of every score tile in place of the fold;
//   * work items (ip_list_kernel, at the end): ivf_scan.cu's runs of layout
//     blocks, each scanned by one block for up to IP_TM queries gathered
//     through an index list, one view an item.
// The gathered scans (top-k and dense) keep scan_gemm.cuh.
//
// A block owns IP_TM = 64 queries and one split of the database's tiles of
// IP_TN = 512 rows, one block an SM (256 threads with up to 255 registers).
// Its 8 warps form a 2 x 4 grid of 32-query x 128-row warp tiles; a lane
// keeps an 8 x 16 register tile of scores: queries lq + 4 i against rows
// lr + 8 j of its warp tile (lq = lane / 8, lr = lane % 8). Operands reach
// shared memory through a ring of IP_STAGES depth chunks, filled by cp.async
// (async_copy.cuh) with no register staging: chunk c + IP_STAGES - 1 is in
// flight while chunk c is multiplied, one barrier a chunk. The ring flows
// across tile boundaries.
//
// Staged rows keep depth contiguous (row-major), padded so that consecutive
// rows fall on distinct banks. A lane reads 4 depths of a query or a row
// with one 16-byte load (u8: one 4-byte word, converted to floats exactly
// through the 2^23 bias), so a 4-depth step costs 8 query loads and 16 row
// loads for 512 FMAs (21 a load); a warp's loads touch 4 queries and 8 rows
// each. The steps of a chunk run as a loop: unrolled, the chunk body
// outgrew the instruction cache (6 % slower on an H100); the last chunk of a
// row stops at d rounded up to 4. Rows that are not 16-byte aligned take
// 4-byte copies (u8 always does: its 20-byte staged stride keeps 8 rows'
// same word on distinct banks), and u8 rows that are not 4-byte aligned
// take byte loads into the same ring. Each thread's copies keep one depth
// and a fixed row step for the whole call (stage_chunk_rows): with the
// addresses worked out per copy the scan was 5 to 6 % slower (H100).
//
// Views (V >= 1). A tile never multiplies a row by another view than its
// layout block's. V = 1: tiles are cut at layout-block ends (ceil(L /
// IP_TN) tiles a block; any L >= 1, no waste when IP_TN divides L). V = 2
// (IP_TN / 2 divides L, not IP_TN: the stream's L = 256): tiles are the
// plain IP_TN-row tiles, and warp columns 0-1 and 2-3 each take the view of
// their own IP_TN / 2 rows, so two query views are staged a chunk. With the
// first chunk of a tile each block also stages, through the same cp.async
// groups, the tile's ids and its views' offsets into a side buffer (one a
// ring stage, so a tile's side outlives its chunks' ring slots). The views'
// tags are read when the tile's first chunk is issued.
//
// Arithmetic: each score is one fp32 FMA chain over depth 0, 1, ..., d - 1
// (zero-filled up to a multiple of 4), then + 0.f (V = 0) or + the view's
// offset (V >= 1) -- the chain scan_gemm.cuh computes (its further zero
// FMAs change at most the sign of a zero, which the addition clears), so
// scores and top-k lists are bit-identical to it. No TF32, no tensor
// cores, no split-K. (The plain fold compares scores before the + 0.f:
// -0.0 and +0.0 compare equal.)
//
// The fold: a score is a candidate only if it outranks its query's current
// k-th list entry (and, in a later pass, ranks below the pass's ceiling);
// after the first tiles of a split few do, and a query whose best score of
// the tile does not reach the k-th value costs 15 max and a compare.
// Candidates go to a per-query buffer of IP_CAP (shared-memory atomics);
// after a barrier one warp per 8 queries runs topk_update_row
// (topk_common.cuh) over it; a barrier vote ends the fold unless a full
// buffer left candidates for another round. N is split for one wave of
// blocks (the wrappers' plans): fewer splits, fewer list insertions. For
// long lists (k >= IP_FLOORS_MIN_K) the splits of a query also share a
// floor through device memory (ip_share_floor) that cuts their insertions
// further. The result is the exact top-k whatever order the splits run in.
//
// DENSE: each warp writes its 32 x 128 piece of a finished tile through its
// own slice of shared memory, 4 queries at a time, so that every store
// instruction writes 4 whole 128-byte lines, with streaming stores (the
// (M, N) output is written once and would only evict the rows from L2).
// The store does not depend on the view: with V = 2 each warp's piece has
// its own column half's view and offset, as in the fold.
#pragma once
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "error.cuh"
#include "topk_common.cuh"

constexpr int IP_TM = 64;        // queries per block
constexpr int IP_TN = 512;       // database rows per tile
constexpr int IP_RX = 16;        // rows per lane: IP_TN / 32
constexpr int IP_THREADS = 256;  // 8 warps: 2 x 4 warp tiles of 32 x 128
static_assert(IP_TN == 32 * IP_RX, "4 warps x 8 lanes share a tile's rows");
constexpr int IP_STAGES = 3;     // depth chunks in the ring
constexpr int IP_CAP = 32;       // fold candidates per query and round
// Lists at least this long share floors across splits (FLOORS): measured on
// an H100, the floors take a fifth of the fold at k = 100 (sphering 24.0 ->
// 22.3 ms, sphering-int8 26.7 -> 23.3) but slow the FMA loop of their
// instantiation by 5 % (full, k = 10: 55.6 -> 58.6; the self-join, k = 49:
// 30.7 -> 31.5).
constexpr int IP_FLOORS_MIN_K = 64;

// Depth chunk BK and staged row strides (queries in floats, rows in bytes).
template <typename XT>
struct IpChunk;
template <>
struct IpChunk<float> {
  static constexpr int BK = 16;
  static constexpr int QSTR = 20;  // 80 B: 8 consecutive rows on distinct 16-B slots
  static constexpr int XSTR = 80;
};
template <>
struct IpChunk<uint8_t> {
  static constexpr int BK = 16;
  static constexpr int QSTR = 20;
  static constexpr int XSTR = 20;  // 20 B: word w of 8 consecutive rows on 8 banks
};

// Query views staged a chunk: one, or V.
template <int V>
__host__ __device__ constexpr int ip_views() {
  return V > 1 ? V : 1;
}

template <typename XT, int V = 0>
__host__ __device__ constexpr int ip_stage_bytes() {
  return ip_views<V>() * IP_TM * IpChunk<XT>::QSTR * 4 + IP_TN * IpChunk<XT>::XSTR;
}

// V >= 1: a tile's side buffer: its IP_TN ids, then its views' IP_TM offsets.
template <int V>
__host__ __device__ constexpr int ip_side_bytes() {
  return V == 0 ? 0 : (IP_TN + ip_views<V>() * IP_TM) * 4;
}

constexpr int IP_DSTR = IP_RX * 8 + 8;  // DENSE: floats a staged row (8 banks apart)
constexpr int IP_SMEM_MAX = 232448;     // a block's shared memory on an H100

struct IpScanArgs {
  const float* q;        // (M, d); IpSegArgs: query m's view t at q + m * q_ld + t * d
  const void* x;         // (N, d) float or uint8
  int M, N, d;
  int k;                 // list length of this pass (<= TOPK_PASS_K); DENSE: 0
  int S;                 // splits of the row tiles (partial slots per query)
  float* pv;             // (M, S, k) partial lists
  int* pi;
  int* floors;           // FLOORS: (M, S) each split's floor, ip_order; INT_MIN = none
  const float* ceil_v;   // CEIL: query m's ceiling at ceil_v[m * ceil_ld]
  const int* ceil_i;
  int ceil_ld;
  int q_vec;             // q rows take 16-byte copies
  int x_vec;             // f32: 16-byte copies; u8: 4-byte copies (else bytes)
  unsigned long long* clocks;  // optional fold profile (IP_CLK_N sums), else null
};

// The arguments of the scans with views (V >= 1). A kernel parameter of its
// own, so that the plain scan's (IpScanArgs) stays as it was: with the
// fields below in it, ptxas gave ip_topk's FLOORS instantiations other
// register counts (H100 build, the code otherwise unchanged).
struct IpSegArgs : IpScanArgs {
  long long q_ld = 0;
  const float* qlo = nullptr;     // (M, C) offsets qlo[m * C + t], or null (none)
  int C = 1;
  const int* seg_tags = nullptr;  // view of each layout block, or null (view 0)
  const int* row_ids = nullptr;   // id of each row, -1 = padding; or null (the row)
  int L = 1;                      // rows a layout block
  float* out = nullptr;           // DENSE: (M, N) scores
  int out_vec = 0;                // DENSE: out rows take 16-byte stores
};

// The kernel parameter of a scan with V views.
template <int V>
using IpArgs = std::conditional_t<V == 0, IpScanArgs, IpSegArgs>;

// The arguments of a scan of q against x (N, d): no ceiling, no profile
// (and with views: rows of d elements, every other option at its default).
template <typename XT>
static IpScanArgs ip_scan_args(const float* q, const XT* x, int M, int N, int d, int k,
                               int S, float* pv, int* pi, int* floors) {
  IpScanArgs a;
  a.q = q;
  a.x = x;
  a.M = M;
  a.N = N;
  a.d = d;
  a.k = k;
  a.S = S;
  a.pv = pv;
  a.pi = pi;
  a.floors = floors;
  a.ceil_v = nullptr;
  a.ceil_i = nullptr;
  a.ceil_ld = 0;
  a.q_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  a.x_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (sizeof(XT) == 4 ? 16 : 4) == 0;
  a.clocks = nullptr;
  return a;
}

template <typename XT>
static IpSegArgs ip_seg_args(const float* q, const XT* x, int M, int N, int d, int k,
                             int S, float* pv, int* pi, int* floors) {
  IpSegArgs a{ip_scan_args(q, x, M, N, d, k, S, pv, pi, floors)};
  a.q_ld = d;
  return a;
}

// The tiles of the row space, and (V >= 1) tile t's rows [n0, n1) (n0 =
// n1 = N past the last row).
template <int V>
__device__ __forceinline__ long long ip_tiles(const IpArgs<V>& a) {
  if constexpr (V == 1) {
    const long long nseg = (a.N + (long long)a.L - 1) / a.L;
    return nseg * ((a.L + IP_TN - 1) / IP_TN);
  } else {
    return (a.N + IP_TN - 1) / IP_TN;
  }
}

template <int V>
__device__ __forceinline__ void ip_seg_tile(const IpSegArgs& a, int t, int& n0, int& n1) {
  if (V == 2) {
    n0 = t * IP_TN;
    n1 = min(n0 + IP_TN, a.N);
    return;
  }
  const int tps = (a.L + IP_TN - 1) / IP_TN;
  const long long seg0 = (long long)(t / tps) * a.L;
  const long long r0 = seg0 + (long long)(t % tps) * IP_TN;
  n0 = (int)min(r0, (long long)a.N);
  n1 = (int)min(min(r0 + IP_TN, seg0 + a.L), (long long)a.N);
}

// V >= 1: the view of warp-column group v of tile t, clamped to [0, C).
template <int V>
__device__ __forceinline__ int ip_seg_tag(const IpSegArgs& a, int t, int v) {
  if (a.seg_tags == nullptr) return 0;
  long long seg;
  if (V == 2) {
    const long long nseg = (a.N + (long long)a.L - 1) / a.L;
    seg = min(((long long)t * IP_TN + v * (IP_TN / 2)) / a.L, nseg - 1);
  } else {
    seg = t / ((a.L + IP_TN - 1) / IP_TN);
  }
  return min(max(a.seg_tags[seg], 0), a.C - 1);
}

// A float as an int of the same order (no NaN), and back; INT_MIN (no
// floor yet) back to -inf.
__device__ __forceinline__ int ip_order(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ip_unorder(int i) {
  return i == INT_MIN ? -CUDART_INF_F : __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Byte b of w as an exact float: the bits 0x4B0000bb are 2^23 + b.
__device__ __forceinline__ float ip_byte(unsigned w, int b) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | b)) - 8388608.0f;
}

// Stage the chunk of depths [kc, kc + BK) of the block's queries and of
// tile rows [n0, n0 + IP_TN) (rows from n1 on are zeros) into one ring
// slot. V >= 1: the queries of each view tags[v], one slab a view.
template <typename XT, int V>
__device__ __forceinline__ void ip_load_chunk(const IpArgs<V>& a, unsigned char* st,
                                              int m0, int n0, int n1, int kc,
                                              const int (&tags)[ip_views<V>()]) {
  using CH = IpChunk<XT>;
  constexpr int BK = CH::BK, QB = CH::QSTR * 4, XSTR = CH::XSTR, T = IP_THREADS;
  unsigned char* xs = st + ip_views<V>() * IP_TM * QB;
  const XT* x = static_cast<const XT*>(a.x);
  if constexpr (V == 0) {
    if (a.q_vec) stage_chunk_rows<T, float, BK, IP_TM, 16>(st, QB, a.q, m0, a.M, a.d, kc);
    else stage_chunk_rows<T, float, BK, IP_TM, 4>(st, QB, a.q, m0, a.M, a.d, kc);
  } else {
#pragma unroll
    for (int v = 0; v < ip_views<V>(); ++v) {
      const float* qv = a.q + (size_t)tags[v] * a.d;
      unsigned char* dst = st + v * IP_TM * QB;
      if (a.q_vec)
        stage_chunk_rows<T, float, BK, IP_TM, 16>(dst, QB, qv, m0, a.M, a.d, kc, a.q_ld);
      else stage_chunk_rows<T, float, BK, IP_TM, 4>(dst, QB, qv, m0, a.M, a.d, kc, a.q_ld);
    }
  }
  if constexpr (sizeof(XT) == 4) {
    if (a.x_vec) stage_chunk_rows<T, XT, BK, IP_TN, 16>(xs, XSTR, x, n0, n1, a.d, kc);
    else stage_chunk_rows<T, XT, BK, IP_TN, 4>(xs, XSTR, x, n0, n1, a.d, kc);
  } else {
    if (a.x_vec) stage_chunk_rows<T, XT, BK, IP_TN, 4>(xs, XSTR, x, n0, n1, a.d, kc);
    else stage_chunk_rows<T, XT, BK, IP_TN, 1>(xs, XSTR, x, n0, n1, a.d, kc);
  }
}

// V >= 1: stage tile rows [n0, n1)'s ids (when a.row_ids is set) and the
// block's offsets of each view tags[v] into a side buffer, with the tile's
// first chunk (the same cp.async group). Out of range: zeros.
template <int V>
__device__ __forceinline__ void ip_load_side(const IpSegArgs& a, unsigned char* side, int m0,
                                             int n0, int n1,
                                             const int (&tags)[ip_views<V>()]) {
  static_assert(IP_TN % IP_THREADS == 0 && ip_views<V>() * IP_TM <= IP_THREADS,
                "a fixed number of side copies a thread");
  const int t = threadIdx.x;
  if (a.row_ids != nullptr) {
#pragma unroll
    for (int i = 0; i < IP_TN / IP_THREADS; ++i) {
      const int r = t + i * IP_THREADS;
      const bool ok = n0 + r < n1;
      cp_async4(side + 4 * r, ok ? a.row_ids + n0 + r : a.row_ids, ok);
    }
  }
  if (t < ip_views<V>() * IP_TM) {
    int tag = tags[0];  // of view t / IP_TM (tags stay in registers)
#pragma unroll
    for (int v = 1; v < ip_views<V>(); ++v)
      if (t >= v * IP_TM) tag = tags[v];
    const int m = m0 + t % IP_TM;
    const bool ok = a.qlo != nullptr && m < a.M;
    const float* src = ok ? a.qlo + (size_t)m * a.C + tag : a.q;
    cp_async4(side + 4 * (IP_TN + t), src, ok);
  }
}

// Multiply depths s4 .. s4 + 3 of one staged chunk into the lane's 8 x 16
// scores: block queries q0 + 4 i (of query slab `slab`) against tile rows
// r0 + 8 j, in depth order.
template <typename XT, int V>
__device__ __forceinline__ void ip_compute_steps(const unsigned char* st, int q0, int r0,
                                                 int slab, int s4, float (&acc)[8][IP_RX]) {
  using CH = IpChunk<XT>;
  constexpr int QSTR = CH::QSTR, XSTR = CH::XSTR;
  const float* qs = reinterpret_cast<const float*>(st) + (V > 1 ? slab * IP_TM * QSTR : 0) +
                    q0 * QSTR;
  const unsigned char* xs = st + ip_views<V>() * IP_TM * QSTR * 4 + r0 * XSTR;
  float4 qv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    qv[i] = *reinterpret_cast<const float4*>(qs + 4 * i * QSTR + s4);
#pragma unroll
  for (int j = 0; j < IP_RX; ++j) {
    float4 xv;
    if constexpr (sizeof(XT) == 4) {
      xv = *reinterpret_cast<const float4*>(xs + 8 * j * XSTR + s4 * 4);
    } else {
      const unsigned w = *reinterpret_cast<const unsigned*>(xs + 8 * j * XSTR + s4);
      xv = make_float4(ip_byte(w, 0), ip_byte(w, 1), ip_byte(w, 2), ip_byte(w, 3));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][j] = fmaf(qv[i].x, xv.x, acc[i][j]);
      acc[i][j] = fmaf(qv[i].y, xv.y, acc[i][j]);
      acc[i][j] = fmaf(qv[i].z, xv.z, acc[i][j]);
      acc[i][j] = fmaf(qv[i].w, xv.w, acc[i][j]);
    }
  }
}

// One staged chunk, depths ascending: all BK depths, or (the last chunk of
// a row) the `left` < BK depths that remain, rounded up to 4.
template <typename XT, int V>
__device__ __forceinline__ void ip_compute_chunk(const unsigned char* st, int q0, int r0,
                                                 int slab, int left, float (&acc)[8][IP_RX]) {
  constexpr int BK = IpChunk<XT>::BK;
  if (left >= BK) {
#pragma unroll 1
    for (int s4 = 0; s4 < BK; s4 += 4) ip_compute_steps<XT, V>(st, q0, r0, slab, s4, acc);
  } else {
#pragma unroll 1
    for (int s4 = 0; s4 < left; s4 += 4) ip_compute_steps<XT, V>(st, q0, r0, slab, s4, acc);
  }
}

// Fold profile (IpScanArgs::clocks): thread 0's clock64 cycles summed over
// the blocks of a pass: the kernel, its folds, and inside the folds the
// compares and appends, the wait at the barrier after them, the inserts
// (thread 0's warp), the wait at the closing vote. Thread 0's clock also
// runs while the other warp of its scheduler issues, so the parts are
// upper bounds.
enum { IP_CLK_KERNEL, IP_CLK_FOLD, IP_CLK_APPEND, IP_CLK_WAIT, IP_CLK_INSERT, IP_CLK_VOTE,
       IP_CLK_N };

// The shared-memory layout after the ring, at list length k: the lists
// (IP_TM x k values, then ids), the candidates (IP_TM x IP_CAP values, then
// ids), their counts, the ceilings (CEIL), the shared floors (FLOORS), the
// profile.
struct IpFoldLayout {
  float* lv;
  int* li;
  float* cv;
  int* ci;
  int* cnt;
  float* ceil_v;
  int* ceil_i;
  float* floor_v;
  unsigned long long* clk;
  __device__ __forceinline__ IpFoldLayout(unsigned char* base, int k) {
    lv = reinterpret_cast<float*>(base);
    li = reinterpret_cast<int*>(lv + IP_TM * k);
    cv = reinterpret_cast<float*>(li + IP_TM * k);
    ci = reinterpret_cast<int*>(cv + IP_TM * IP_CAP);
    cnt = ci + IP_TM * IP_CAP;
    ceil_v = reinterpret_cast<float*>(cnt + IP_TM);
    ceil_i = reinterpret_cast<int*>(ceil_v + IP_TM);
    floor_v = reinterpret_cast<float*>(ceil_i + IP_TM);
    clk = reinterpret_cast<unsigned long long*>(floor_v + 2 * IP_TM);  // 8-B aligned
  }
};

// LIST (ip_list_kernel): the block query rows of the work item being
// scanned, in shared memory. Row r is query m[r] (-1: none), whose list goes
// to its partial slot slot[r] and who has nslots[r] partial slots in all;
// rows from end[r] on are not its run's. A row listed in two of a query's
// slots is two entries of equal value and id, so a later pass's ceiling
// also names the slot its entry came from (cslot[r]): an equal entry is
// below the ceiling when its slot comes after that one.
struct IpListRows {
  int* m = nullptr;
  int* slot = nullptr;
  int* end = nullptr;
  int* nslots = nullptr;
  float* lo = nullptr;  // the offset of its view
  int* cslot = nullptr;
};

__device__ __forceinline__ void ip_clock(bool on, unsigned long long* slot, long long& t) {
  if (on) {
    const long long now = clock64();
    *slot += now - t;
    t = now;
  }
}

// Publish and refresh the shared floor of block query row r (m0 + r < M),
// by its inserting warp after its list changed. A split whose list holds
// rank = ceil(k / S) entries publishes its rank-th value; the floor of a
// query is the least of its S splits' (INT_MIN until each has one). The S
// splits then hold S rank >= k entries at or above it, so no score below
// it can reach the final top-k, while it rises about as fast as the k-th
// value of all the query's rows seen so far: a split admits about S times
// fewer scores than its own k-th entry would let through.
// V >= 1 (a.floors (M, 2 S)): each split also publishes its k-th value, and
// the floor is the larger of that least rank-th value and the greatest
// k-th value (a split with a full list alone holds k entries at or above
// its k-th). In the tag-sorted layout a query's best rows sit in the
// clusters of a few splits, so the least rank-th value stays low while
// those splits' k-th values rise: on the main path's data (H100, k = 100)
// this floor took the sorted scan from 33.9 to 25.2 ms (f32) and 35.6 to
// 27.5 ms (u8). Plain MIPS (V = 0), whose splits see alike rows, keeps the
// one floor: with the second floor too, ip_topk's FLOORS instantiations
// took 237 / 254 / 254 registers in place of 251 / 251 / 247, and at k =
// 100 sphering-int8 ran 23.51 -> 24.65 ms on the main path's data (23.28
// -> 24.56 on random data) while sphering stayed at 22.3-22.4 (H100,
// chip_smoke.py phase 4 and --kernel-timing).
template <int V>
__device__ __forceinline__ void ip_share_floor(const IpScanArgs& a, const IpFoldLayout& f,
                                               int m0, int r, int lane) {
  const int k = a.k, rank = (k + a.S - 1) / a.S;
  const size_t row = (size_t)(m0 + r) * a.S * (V > 0 ? 2 : 1);
  if (lane == 0 && f.li[r * k + rank - 1] >= 0)
    a.floors[row + blockIdx.y] = ip_order(f.lv[r * k + rank - 1]);
  if constexpr (V > 0) {
    if (lane == 0 && f.li[r * k + k - 1] >= 0)
      a.floors[row + a.S + blockIdx.y] = ip_order(f.lv[r * k + k - 1]);
  }
  // both floors' loads in one loop: one trip to device memory, not two
  int v = INT_MAX, w = INT_MIN;
  for (int s2 = lane; s2 < a.S; s2 += 32) {
    v = min(v, __ldcg(a.floors + row + s2));
    if constexpr (V > 0) w = max(w, __ldcg(a.floors + row + a.S + s2));
  }
  v = __reduce_min_sync(0xffffffffu, v);
  if constexpr (V > 0) v = max(v, __reduce_max_sync(0xffffffffu, w));
  if (lane == 0) f.floor_v[r] = ip_unorder(v);
}

// LIST: ip_share_floor<1> for block query row r of a work item, whose
// query lr.m[r] has lr.nslots[r] partial slots (its runs' pieces) in place
// of the splits, this item's being lr.slot[r]; a.floors is (M, 2 a.S).
__device__ __forceinline__ void ip_list_share_floor(const IpScanArgs& a, const IpFoldLayout& f,
                                                    int r, int lane, const IpListRows& lr) {
  const int k = a.k, ns = lr.nslots[r], rank = (k + ns - 1) / ns, own = lr.slot[r];
  const size_t row = (size_t)lr.m[r] * a.S * 2;
  if (lane == 0 && f.li[r * k + rank - 1] >= 0)
    a.floors[row + own] = ip_order(f.lv[r * k + rank - 1]);
  if (lane == 0 && f.li[r * k + k - 1] >= 0)
    a.floors[row + a.S + own] = ip_order(f.lv[r * k + k - 1]);
  int v = INT_MAX, w = INT_MIN;
  for (int s2 = lane; s2 < ns; s2 += 32) {
    v = min(v, __ldcg(a.floors + row + s2));
    w = max(w, __ldcg(a.floors + row + a.S + s2));
  }
  v = max(__reduce_min_sync(0xffffffffu, v), __reduce_max_sync(0xffffffffu, w));
  if (lane == 0) f.floor_v[r] = ip_unorder(v);
}

// LIST: fold the c (1 <= c <= IP_CAP) candidates cv/ci of one query into
// its sorted list lv/li (k <= TOPK_PASS_K entries, best first) in one pass
// of the warp, not one candidate at a time (topk_update_row): the lanes sort
// the candidates (a bitonic network over the 32 lanes), each candidate
// finds its place among the list's entries and each entry its place among
// the candidates (binary searches), and every entry moves at once. A work
// item's cold lists take hundreds of candidates a query in their first
// tiles. Candidates and entries are distinct (one row, one entry a slot),
// so the places are a permutation; entries moved past k drop out.
__device__ __forceinline__ void ip_list_insert(float* cv, int* ci, int c, float* lv, int* li,
                                               int k, int lane) {
  static_assert(IP_CAP == 32 && TOPK_PASS_K % 32 == 0, "one candidate a lane");
  const unsigned full = 0xffffffffu;
  float v = lane < c ? cv[lane] : -CUDART_INF_F;  // padding sorts last
  int id = lane < c ? ci[lane] : -1;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(full, v, stride);
      const int oi = __shfl_xor_sync(full, id, stride);
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      const bool ob = topk_better(ov, oi, v, id);
      if (keep_better ? ob : !ob) {
        v = ov;
        id = oi;
      }
    }
  }
  cv[lane] = v;  // best first
  ci[lane] = id;
  int lo = 0, hi = k;  // the list entries that outrank candidate `lane`
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (topk_better(lv[mid], li[mid], v, id)) lo = mid + 1;
    else hi = mid;
  }
  const int cpos = lane + lo;
  __syncwarp();
  float ev[TOPK_PASS_K / 32];
  int ei[TOPK_PASS_K / 32], epos[TOPK_PASS_K / 32];
#pragma unroll
  for (int t = 0; t < TOPK_PASS_K / 32; ++t) {
    const int e = lane + 32 * t;
    epos[t] = k;
    if (e < k) {
      ev[t] = lv[e];
      ei[t] = li[e];
      int a = 0, b = c;  // the candidates that outrank entry e
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (topk_better(cv[mid], ci[mid], ev[t], ei[t])) a = mid + 1;
        else b = mid;
      }
      epos[t] = e + a;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < TOPK_PASS_K / 32; ++t) {
    if (epos[t] < k) {
      lv[epos[t]] = ev[t];
      li[epos[t]] = ei[t];
    }
  }
  if (lane < c && cpos < k) {
    lv[cpos] = v;
    li[cpos] = id;
  }
  __syncwarp();
}

// Fold the block's finished tile into its queries' lists: the lane's scores
// are queries q0 + 4 i against rows n0 + 8 j, of which those below n_end
// count. Their ids: the rows (V = 0, or no row_ids), else ids[8 j] (shared
// memory; -1 = padding, never listed). Every thread of the block calls it
// (it holds barriers). `fold_base`: the layout's start. LIST: the block's
// query rows are lr's (m0 unused), and row r's scores count below
// min(n_end, lr.end[r]).
template <int V, bool CEIL, bool FLOORS, bool LIST = false>
__device__ __forceinline__ void ip_fold_tile(const IpScanArgs& a, unsigned char* fold_base,
                                             float (&acc)[8][IP_RX], int m0, int q0,
                                             int n0, int n_end, const int* ids,
                                             const IpListRows& lr = IpListRows{}) {
  static_assert(IP_RX < 32, "a query's pending scores are one 32-bit mask");
  const int k = a.k, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const IpFoldLayout f(fold_base, k);
  const bool prof = a.clocks != nullptr && threadIdx.x == 0;
  long long t = prof ? clock64() : 0;
  const long long t_fold = t;
  unsigned pend[8];  // per query, the scores (bit j: row n0 + 8 j) still to offer
  // keep the scores that outrank their query's k-th entry, are not below
  // its shared floor (and rank below its ceiling); a query whose best
  // score of the tile does not reach them (the common case) costs 15 max
  // and two compares
  auto refilter = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + 4 * i;
      const float tv = f.lv[r * k + k - 1];
      const int ti = f.li[r * k + k - 1];
      const float fv = FLOORS ? f.floor_v[r] : 0.f;
      float best = acc[i][0];
#pragma unroll
      for (int j = 1; j < IP_RX; ++j) best = fmaxf(best, acc[i][j]);
      const bool none = LIST ? lr.m[r] < 0 : m0 + r >= a.M;
      if (none || best < tv || (FLOORS && best < fv)) {
        pend[i] = 0;
        continue;
      }
      const int ne = LIST ? min(n_end, lr.end[r]) : n_end;
#pragma unroll
      for (int j = 0; j < IP_RX; ++j) {
        const int n = n0 + 8 * j;
        const int id = (V > 0 && ids != nullptr) ? ids[8 * j] : n;
        bool p = n < ne && topk_better(acc[i][j], id, tv, ti);
        if constexpr (V > 0) p = p && id >= 0;
        if constexpr (FLOORS) p = p && acc[i][j] >= fv;
        if constexpr (CEIL && LIST)
          p = p && (topk_better(f.ceil_v[r], f.ceil_i[r], acc[i][j], id) ||
                    (acc[i][j] == f.ceil_v[r] && id == f.ceil_i[r] &&
                     lr.slot[r] > lr.cslot[r]));
        else if constexpr (CEIL)
          p = p && topk_better(f.ceil_v[r], f.ceil_i[r], acc[i][j], id);
        if (!p) pend[i] &= ~(1u << j);
      }
    }
  };
  auto any_pending = [&]() {
    unsigned u = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) u |= pend[i];
    return u != 0;
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) pend[i] = (1u << IP_RX) - 1;
  refilter();
  while (true) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!pend[i]) continue;
#pragma unroll
      for (int j = 0; j < IP_RX; ++j) {
        if (pend[i] & (1u << j)) {
          const int r = q0 + 4 * i;
          const int slot = atomicAdd(&f.cnt[r], 1);
          if (slot < IP_CAP) {
            f.cv[r * IP_CAP + slot] = acc[i][j] + 0.f;
            f.ci[r * IP_CAP + slot] = (V > 0 && ids != nullptr) ? ids[8 * j] : n0 + 8 * j;
            pend[i] &= ~(1u << j);
          }
        }
      }
    }
    ip_clock(prof, &f.clk[IP_CLK_APPEND], t);
    __syncthreads();
    ip_clock(prof, &f.clk[IP_CLK_WAIT], t);
#pragma unroll 1
    for (int qq = 0; qq < 8; ++qq) {
      const int r = warp * 8 + qq;
      const int c = min(f.cnt[r], IP_CAP);
      if (c > 0) {
        if constexpr (LIST)  // the candidates passed the ceiling (and its slot) above
          ip_list_insert(f.cv + r * IP_CAP, f.ci + r * IP_CAP, c, f.lv + r * k,
                         f.li + r * k, k, lane);
        else
          topk_update_row<CEIL>(f.cv + r * IP_CAP, f.ci + r * IP_CAP, c, f.lv + r * k,
                                f.li + r * k, k, lane, CEIL ? f.ceil_v[r] : 0.f,
                                CEIL ? f.ceil_i[r] : 0);
        __syncwarp();
        if (lane == 0) f.cnt[r] = 0;
        if constexpr (FLOORS && LIST) ip_list_share_floor(a, f, r, lane, lr);
        else if constexpr (FLOORS) ip_share_floor<V>(a, f, m0, r, lane);
      }
    }
    ip_clock(prof, &f.clk[IP_CLK_INSERT], t);
    const bool again = __syncthreads_or(any_pending());
    ip_clock(prof, &f.clk[IP_CLK_VOTE], t);
    if (!again) break;
    refilter();  // what a full buffer left, against the risen lists
  }
  if (prof) f.clk[IP_CLK_FOLD] += clock64() - t_fold;
}

// DENSE: the lane's scores of a finished tile (output columns from n0,
// those below n1; the block's queries from m0) to a.out, through the
// warp's slice `wst` of shared memory (4 x IP_DSTR floats): per query group
// i the warp stages 4 queries x its 128 columns, then each lane stores 16
// bytes, so one store instruction writes 4 whole 128-byte lines (when
// a.out_vec and n0 % 4 == 0; else 4-byte stores).
__device__ __forceinline__ void ip_store_tile(const IpSegArgs& a, float* wst,
                                              const float (&acc)[8][IP_RX], int m0, int n0,
                                              int n1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 3, c = lane & 7;          // staged row, lane in the row
  const int col0 = (warp & 3) * 8 * IP_RX;        // the warp's first column
  const int mg = m0 + (warp >> 2) * 32 + g;       // query of staged row g at i = 0
  const bool vec = a.out_vec && n0 % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < IP_RX; ++j) wst[g * IP_DSTR + c + 8 * j] = acc[i][j];
    __syncwarp();
    const int m = mg + 4 * i;
#pragma unroll
    for (int s = 0; s < IP_RX / 4; ++s) {
      const int col = 32 * s + 4 * c;
      const float4 v = *reinterpret_cast<const float4*>(wst + g * IP_DSTR + col);
      const int n = n0 + col0 + col;
      if (m < a.M) {
        float* o = a.out + (size_t)m * a.N + n;
        if (vec && n + 4 <= n1) {
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
          if (n < n1) __stcs(o, v.x);
          if (n + 1 < n1) __stcs(o + 1, v.y);
          if (n + 2 < n1) __stcs(o + 2, v.z);
          if (n + 3 < n1) __stcs(o + 3, v.w);
        }
      }
    }
    __syncwarp();
  }
}

// One block an SM (the lane's 8 x 16 tile needs up to 255 registers) for
// IP_TM queries (blockIdx.x) and split blockIdx.y of the row tiles, whose
// lists go to partial slot blockIdx.y. Query blocks are the fastest grid
// dimension, so the blocks resident at one time read the same row tiles
// and x streams from device memory about once. V: plain MIPS (0) or views
// per layout block (1, 2; see the top). DENSE (V = 1): store the scores,
// no lists (any V >= 1). CEIL: a later pass of a k > TOPK_PASS_K scan; FLOORS: the
// splits share floors (a.floors). Each option is a template parameter, so
// the plain instantiations compile to the code they ran before the others
// existed.
template <typename XT, int V, bool DENSE, bool CEIL, bool FLOORS>
__global__ void __launch_bounds__(IP_THREADS, 1) ip_scan_kernel(IpArgs<V> a) {
  static_assert(!DENSE || V >= 1, "dense scores take the views' offsets");
  constexpr int BK = IpChunk<XT>::BK, STAGE = ip_stage_bytes<XT, V>();
  constexpr int SIDE = ip_side_bytes<V>();
  extern __shared__ __align__(16) unsigned char ism[];
  unsigned char* ring = ism;                            // IP_STAGES x STAGE
  unsigned char* side = ism + IP_STAGES * STAGE;        // V >= 1: IP_STAGES x SIDE
  unsigned char* fold_base = side + IP_STAGES * SIDE;   // the fold, or DENSE's staging
  const IpFoldLayout f(fold_base, a.k);
  const long long t_kernel = a.clocks ? clock64() : 0;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = (warp >> 2) * 32 + (lane >> 3);      // the lane's first query row
  const int r0 = (warp & 3) * 8 * IP_RX + (lane & 7);  // and first tile row
  const int slab = V > 1 ? (warp & 3) * V / 4 : 0;     // and query view
  const int m0 = blockIdx.x * IP_TM, s = blockIdx.y;
  const int nk = (a.d + BK - 1) / BK;
  const long long T = ip_tiles<V>(a);
  const int t_begin = (int)(T * s / a.S), t_end = (int)(T * (s + 1) / a.S);
  const long long total = (long long)(t_end - t_begin) * nk;

  if constexpr (!DENSE) {
    for (int e = t; e < IP_TM * a.k; e += IP_THREADS) {
      f.lv[e] = NEG_INF_F;
      f.li[e] = -1;
    }
    if (t < IP_TM) {
      const int m = m0 + t;
      f.cnt[t] = 0;
      f.floor_v[t] = -CUDART_INF_F;
      if (CEIL) {
        f.ceil_v[t] = m < a.M ? a.ceil_v[(size_t)m * a.ceil_ld] : NEG_INF_F;
        f.ceil_i[t] = m < a.M ? a.ceil_i[(size_t)m * a.ceil_ld] : -1;
      }
    }
    if (t < IP_CLK_N) f.clk[t] = 0;
  }

  // producer position (tile, chunk) of the next chunk to load; V >= 1: its
  // tile's rows, views and side buffer
  int lt = t_begin, lk = 0, pn0 = 0, pn1 = 0, pside = 0;
  int ptag[ip_views<V>()] = {};
  auto load_next = [&](unsigned char* st) {
    if constexpr (V == 0) {
      ip_load_chunk<XT, V>(a, st, m0, lt * IP_TN, a.N, lk * BK, ptag);
    } else {
      if (lk == 0) {
        ip_seg_tile<V>(a, lt, pn0, pn1);
#pragma unroll
        for (int v = 0; v < ip_views<V>(); ++v) ptag[v] = ip_seg_tag<V>(a, lt, v);
        ip_load_side<V>(a, side + pside * SIDE, m0, pn0, pn1, ptag);
        pside = pside + 1 == IP_STAGES ? 0 : pside + 1;
      }
      ip_load_chunk<XT, V>(a, st, m0, pn0, pn1, lk * BK, ptag);
    }
    if (++lk == nk) {
      lk = 0;
      ++lt;
    }
  };
  for (int g = 0; g < IP_STAGES - 1; ++g) {
    if (g < total) load_next(ring + g * STAGE);
    cp_async_commit();
  }

  float acc[8][IP_RX];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < IP_RX; ++j) acc[i][j] = 0.f;

  int ct = t_begin, ck = 0, slot = 0, cside = 0;  // consumer position, ring slot, side
  for (long long g = 0; g < total; ++g) {
    cp_async_wait<IP_STAGES - 2>();
    __syncthreads();  // chunk g visible; every warp is done with chunk g - 1
    if (g + IP_STAGES - 1 < total)
      load_next(ring + (slot == 0 ? IP_STAGES - 1 : slot - 1) * STAGE);
    cp_async_commit();
    ip_compute_chunk<XT, V>(ring + slot * STAGE, q0, r0, slab, a.d - ck * BK, acc);
    slot = slot + 1 == IP_STAGES ? 0 : slot + 1;
    if (++ck == nk) {
      if constexpr (V == 0) {
        ip_fold_tile<V, CEIL, FLOORS>(a, fold_base, acc, m0, q0, ct * IP_TN + r0, a.N,
                                      nullptr);
      } else {
        int n0, n1;
        ip_seg_tile<V>(a, ct, n0, n1);
        const unsigned char* sd = side + cside * SIDE;
        const float* lo = reinterpret_cast<const float*>(sd) + IP_TN + slab * IP_TM + q0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float l = lo[4 * i];
#pragma unroll
          for (int j = 0; j < IP_RX; ++j) acc[i][j] = acc[i][j] + l;  // after the chain
        }
        if constexpr (DENSE)
          ip_store_tile(a, reinterpret_cast<float*>(fold_base) + warp * 4 * IP_DSTR, acc, m0,
                        n0, n1);
        else
          ip_fold_tile<V, CEIL, FLOORS>(
              a, fold_base, acc, m0, q0, n0 + r0, n1,
              a.row_ids != nullptr ? reinterpret_cast<const int*>(sd) + r0 : nullptr);
        cside = cside + 1 == IP_STAGES ? 0 : cside + 1;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < IP_RX; ++j) acc[i][j] = 0.f;
      ck = 0;
      ++ct;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (!DENSE) {
    for (int e = t; e < IP_TM * a.k; e += IP_THREADS) {
      const int r = e / a.k, j = e % a.k, m = m0 + r;
      if (m < a.M) {
        const size_t o = ((size_t)m * a.S + s) * a.k + j;
        a.pv[o] = f.lv[e];
        a.pi[o] = f.li[e];
      }
    }
    if (a.clocks && t == 0) {
      f.clk[IP_CLK_KERNEL] = clock64() - t_kernel;
      for (int c = 0; c < IP_CLK_N; ++c) atomicAdd(a.clocks + c, f.clk[c]);
    }
  }
}

// Shared memory of one block at list length k (DENSE: k = 0).
template <typename XT, int V = 0, bool DENSE = false>
static size_t ip_scan_smem(int k) {
  const size_t ring = (size_t)IP_STAGES * (ip_stage_bytes<XT, V>() + ip_side_bytes<V>());
  if (DENSE) return ring + (size_t)(IP_THREADS / 32) * 4 * IP_DSTR * 4;
  return ring + (size_t)IP_TM * k * 8 + (size_t)IP_TM * IP_CAP * 8 + IP_TM * 20 +
         IP_CLK_N * 8;
}

__global__ void ip_floor_reset_kernel(int* floors, long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e < n) floors[e] = INT_MIN;
}

// One pass of the scan (a.k <= TOPK_PASS_K) on ceil(M / IP_TM) x a.S blocks,
// the shared floors reset first.
template <typename XT, int V, bool CEIL>
static cudaError_t launch_ip_scan_pass(const IpArgs<V>& a, cudaStream_t stream) {
  const bool floors = a.k >= IP_FLOORS_MIN_K;
  if (floors) {
    const long long nf = (long long)a.M * a.S * (V > 0 ? 2 : 1);
    ip_floor_reset_kernel<<<(unsigned)((nf + 255) / 256), 256, 0, stream>>>(a.floors, nf);
  }
  const size_t smem = ip_scan_smem<XT, V>(a.k);
  auto kernel = floors ? ip_scan_kernel<XT, V, false, CEIL, true>
                       : ip_scan_kernel<XT, V, false, CEIL, false>;
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.M + IP_TM - 1) / IP_TM, a.S), IP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Any k >= 1: one pass per TOPK_PASS_K columns of the output, each after the
// first under the previous pass's ceiling, each followed by the merge of
// the S partial lists (topk_common.cuh). a.pv / a.pi hold (M, S,
// min(k, TOPK_PASS_K)) entries.
template <typename XT, int V = 0>
static cudaError_t launch_ip_scan(IpArgs<V> a, int k, float* out_v, int* out_i,
                                  cudaStream_t stream) {
  for (int k0 = 0; k0 < k; k0 += TOPK_PASS_K) {
    a.k = k - k0 < TOPK_PASS_K ? k - k0 : TOPK_PASS_K;
    cudaError_t err;
    if (k0 == 0) {
      err = launch_ip_scan_pass<XT, V, false>(a, stream);
    } else if constexpr (V == 2 && sizeof(XT) == 4) {
      return cudaErrorInvalidValue;  // ip_seg_views: f32 takes two views at k <= 104 only
    } else {
      a.ceil_v = out_v + k0 - 1;
      a.ceil_i = out_i + k0 - 1;
      a.ceil_ld = k;
      err = launch_ip_scan_pass<XT, V, true>(a, stream);
    }
    if (err != cudaSuccess) return err;
    err = launch_topk_merge(a.pv, a.pi, a.M, a.S, a.k, k, out_v + k0, out_i + k0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The views (1 or 2) a scan of layout blocks of L rows takes at list length
// k: two where IP_TN / 2 divides L but IP_TN does not, and the two query
// slabs fit a block's shared memory (f32 rows: k <= 104), else one.
template <typename XT>
static int ip_seg_views(int L, int k) {
  const int pk = k < TOPK_PASS_K ? k : TOPK_PASS_K;
  if (L % IP_TN != 0 && L % (IP_TN / 2) == 0 && ip_scan_smem<XT, 2>(pk) <= IP_SMEM_MAX)
    return 2;
  return 1;
}

// The scan of layout blocks (V >= 1) with `views` = ip_seg_views(a.L, k).
template <typename XT>
static cudaError_t launch_ip_seg_scan(const IpSegArgs& a, int views, int k, float* out_v,
                                      int* out_i, cudaStream_t stream) {
  if (a.L < 1 || views != ip_seg_views<XT>(a.L, k)) return cudaErrorInvalidValue;
  return views == 2 ? launch_ip_scan<XT, 2>(a, k, out_v, out_i, stream)
                    : launch_ip_scan<XT, 1>(a, k, out_v, out_i, stream);
}

// The views (1 or 2) the dense scan takes for layout blocks of L rows: two
// where IP_TN / 2 divides L but IP_TN does not (its tiles are then
// ceil(N / IP_TN)), else one (ceil(N / L) * ceil(L / IP_TN) tiles).
template <typename XT>
static int ip_dense_views(int L) {
  if (L % IP_TN != 0 && L % (IP_TN / 2) == 0 &&
      ip_scan_smem<XT, 2, true>(0) <= IP_SMEM_MAX)
    return 2;
  return 1;
}

// Dense (M, N) scores of a.L rows a view (V = ip_dense_views(a.L)) on
// ceil(M / IP_TM) x a.S blocks: no lists, no merge.
template <typename XT, int V>
static cudaError_t launch_ip_dense_v(IpSegArgs a, cudaStream_t stream) {
  a.k = 0;
  const size_t smem = ip_scan_smem<XT, V, true>(0);
  auto kernel = ip_scan_kernel<XT, V, true, false, false>;
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.M + IP_TM - 1) / IP_TM, a.S), IP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT>
static cudaError_t launch_ip_dense(const IpSegArgs& a, cudaStream_t stream) {
  if (a.L < 1) return cudaErrorInvalidValue;
  return ip_dense_views<XT>(a.L) == 2 ? launch_ip_dense_v<XT, 2>(a, stream)
                                      : launch_ip_dense_v<XT, 1>(a, stream);
}

// ---------------------------------------------------------------------------
// Work items (ivf_scan.cu). A run is a sequence of consecutive layout blocks
// of one tag that a query visits in consecutive schedule slots; the runs
// that start at layout block b0 form b0's entry list, and b0's "pieces" cut
// the rows of its longest run (grp_blocks[b0] blocks) into grp_pieces[b0]
// spans of whole blocks. Work item w = work[w] = {b0, e0, cnt, j} is piece
// j for the entries e0 .. e0 + cnt - 1 (cnt <= IP_TM) of b0's list: entry e
// is query q_index[e], whose run has q_blocks[e] blocks and whose pieces
// take its partial slots q_slot[e], q_slot[e] + 1, ...; an entry whose run
// ends before piece j starts is not in the item. One block an SM takes
// items through the counter `next` until n_work is reached.
// ---------------------------------------------------------------------------

struct IpListArgs : IpSegArgs {
  const int4* work = nullptr;
  const int* n_work = nullptr;
  int* next = nullptr;              // the next item to take; zero at launch
  const int* q_index = nullptr;     // entry -> query
  const int* q_slot = nullptr;      // entry -> its run's first partial slot
  const int* q_blocks = nullptr;    // entry -> its run's layout blocks
  const int* nslots = nullptr;      // query -> its partial slots in all
  const int* grp_blocks = nullptr;  // b0 -> blocks of its longest run
  const int* grp_pieces = nullptr;  // b0 -> pieces its runs are cut into
  const int* ceil_slot = nullptr;   // CEIL: query -> the slot of its ceiling
};

// Shared memory after the ring: the tiles' ids (IP_STAGES x IP_TN), the
// item's query rows (IpListRows: 6 x IP_TM), the item taken, then the fold.
constexpr int IP_LIST_HEAD = (IP_STAGES * IP_TN + 7 * IP_TM) * 4;

// Stage the chunk of depths [kc, kc + BK) of the item's queries (view
// `tag`, rows lr_m through the index list) and of rows [n0, n1) of x.
template <typename XT>
__device__ __forceinline__ void ip_load_list_chunk(const IpListArgs& a, unsigned char* st,
                                                   const int* lr_m, int tag, int n0, int n1,
                                                   int kc) {
  using CH = IpChunk<XT>;
  constexpr int BK = CH::BK, QB = CH::QSTR * 4, XSTR = CH::XSTR, T = IP_THREADS;
  unsigned char* xs = st + IP_TM * QB;
  const XT* x = static_cast<const XT*>(a.x);
  const float* qv = a.q + (size_t)tag * a.d;
  if (a.q_vec) stage_chunk_rows_at<T, float, BK, IP_TM, 16>(st, QB, qv, lr_m, a.d, kc, a.q_ld);
  else stage_chunk_rows_at<T, float, BK, IP_TM, 4>(st, QB, qv, lr_m, a.d, kc, a.q_ld);
  if constexpr (sizeof(XT) == 4) {
    if (a.x_vec) stage_chunk_rows<T, XT, BK, IP_TN, 16>(xs, XSTR, x, n0, n1, a.d, kc);
    else stage_chunk_rows<T, XT, BK, IP_TN, 4>(xs, XSTR, x, n0, n1, a.d, kc);
  } else {
    if (a.x_vec) stage_chunk_rows<T, XT, BK, IP_TN, 4>(xs, XSTR, x, n0, n1, a.d, kc);
    else stage_chunk_rows<T, XT, BK, IP_TN, 1>(xs, XSTR, x, n0, n1, a.d, kc);
  }
}

// The scan of work items: per item the pipelined tile of ip_scan_kernel
// over the piece's rows (tiles of IP_TN rows from the piece's first row, cut
// at its end), one view (the tag of block b0), each query's offset added
// after the FMA chain, one running list per query for the whole piece,
// written to the query's partial slot. a.row_ids must be set. CEIL / FLOORS
// as ip_scan_kernel's (a.floors: (M, 2 S), the slots of a query sharing
// them).
template <typename XT, bool CEIL, bool FLOORS>
__global__ void __launch_bounds__(IP_THREADS, 1) ip_list_kernel(IpListArgs a) {
  constexpr int BK = IpChunk<XT>::BK, STAGE = ip_stage_bytes<XT, 1>();
  extern __shared__ __align__(16) unsigned char ism[];
  unsigned char* ring = ism;                                      // IP_STAGES x STAGE
  int* side = reinterpret_cast<int*>(ism + IP_STAGES * STAGE);    // IP_STAGES x IP_TN ids
  int* head = side + IP_STAGES * IP_TN;
  const IpListRows lr{head, head + IP_TM, head + 2 * IP_TM, head + 3 * IP_TM,
                      reinterpret_cast<float*>(head + 4 * IP_TM), head + 5 * IP_TM};
  int* taken = head + 6 * IP_TM;
  unsigned char* fold_base = ism + IP_STAGES * STAGE + IP_LIST_HEAD;
  const IpFoldLayout f(fold_base, a.k);
  const long long t_kernel = a.clocks ? clock64() : 0;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = (warp >> 2) * 32 + (lane >> 3);
  const int r0 = (warp & 3) * 8 * IP_RX + (lane & 7);
  const int nk = (a.d + BK - 1) / BK;
  const int n_work = *a.n_work;
  if (t < IP_CLK_N) f.clk[t] = 0;

  while (true) {
    if (t == 0) *taken = atomicAdd(a.next, 1);
    __syncthreads();  // the item; every thread is done with the last one
    const int w = *taken;
    if (w >= n_work) break;
    const int4 it = a.work[w];
    const int b0 = it.x, j = it.w;
    const int nbk = a.grp_blocks[b0], np = a.grp_pieces[b0];
    const long long base = (long long)b0 * a.L;
    const int bs = (int)((long long)nbk * j / np), be = (int)((long long)nbk * (j + 1) / np);
    const int p0 = (int)min(base + (long long)bs * a.L, (long long)a.N);
    const int p1 = (int)min(base + (long long)be * a.L, (long long)a.N);
    const int tag = min(max(a.seg_tags[b0], 0), a.C - 1);
    if (t < IP_TM) {
      int m = -1, slot = 0, end = 0, ns = 1;
      float lo = 0.f;
      if (t < it.z) {
        const int e = it.y + t, nq = a.q_blocks[e];
        if (bs < nq) {  // the entry's run reaches the piece
          m = a.q_index[e];
          slot = a.q_slot[e] + j;
          end = (int)min(base + (long long)nq * a.L, (long long)a.N);
          ns = a.nslots[m];
          if (a.qlo != nullptr) lo = a.qlo[(size_t)m * a.C + tag];
        }
      }
      lr.m[t] = m;
      lr.slot[t] = slot;
      lr.end[t] = end;
      lr.nslots[t] = ns;
      lr.lo[t] = lo;
      f.cnt[t] = 0;
      f.floor_v[t] = -CUDART_INF_F;
      if (CEIL) {
        f.ceil_v[t] = m >= 0 ? a.ceil_v[(size_t)m * a.ceil_ld] : NEG_INF_F;
        f.ceil_i[t] = m >= 0 ? a.ceil_i[(size_t)m * a.ceil_ld] : -1;
        lr.cslot[t] = m >= 0 ? a.ceil_slot[m] : 0;
      }
    }
    for (int e = t; e < IP_TM * a.k; e += IP_THREADS) {
      f.lv[e] = NEG_INF_F;
      f.li[e] = -1;
    }
    __syncthreads();  // the query rows, read by the staging

    const long long total = (long long)((p1 - p0 + IP_TN - 1) / IP_TN) * nk;
    // a warp whose 32 query rows the item leaves empty multiplies nothing:
    // the other warp of its scheduler then issues alone
    const bool active = it.z > (warp >> 2) * 32;
    int lt = 0, lk = 0, pside = 0;  // producer tile (from p0), chunk, side slot
    auto load_next = [&](unsigned char* st) {
      const int n0 = p0 + lt * IP_TN, n1 = min(n0 + IP_TN, p1);
      if (lk == 0) {  // the tile's ids ride with its first chunk
        int* ids = side + pside * IP_TN;
#pragma unroll
        for (int i = 0; i < IP_TN / IP_THREADS; ++i) {
          const int r = t + i * IP_THREADS;
          const bool ok = n0 + r < n1;
          cp_async4(ids + r, ok ? a.row_ids + n0 + r : a.row_ids, ok);
        }
        pside = pside + 1 == IP_STAGES ? 0 : pside + 1;
      }
      ip_load_list_chunk<XT>(a, st, lr.m, tag, n0, n1, lk * BK);
      if (++lk == nk) {
        lk = 0;
        ++lt;
      }
    };
    for (int g = 0; g < IP_STAGES - 1; ++g) {
      if (g < total) load_next(ring + g * STAGE);
      cp_async_commit();
    }

    float acc[8][IP_RX];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < IP_RX; ++jj) acc[i][jj] = 0.f;

    int ct = 0, ck = 0, slot = 0, cside = 0;
    for (long long g = 0; g < total; ++g) {
      cp_async_wait<IP_STAGES - 2>();
      __syncthreads();  // chunk g visible; every warp is done with chunk g - 1
      if (g + IP_STAGES - 1 < total)
        load_next(ring + (slot == 0 ? IP_STAGES - 1 : slot - 1) * STAGE);
      cp_async_commit();
      if (active) ip_compute_chunk<XT, 1>(ring + slot * STAGE, q0, r0, 0, a.d - ck * BK, acc);
      slot = slot + 1 == IP_STAGES ? 0 : slot + 1;
      if (++ck == nk) {
        const int n0 = p0 + ct * IP_TN, n1 = min(n0 + IP_TN, p1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float l = lr.lo[q0 + 4 * i];
#pragma unroll
          for (int jj = 0; jj < IP_RX; ++jj) acc[i][jj] = acc[i][jj] + l;  // after the chain
        }
        ip_fold_tile<1, CEIL, FLOORS, true>(a, fold_base, acc, 0, q0, n0 + r0, n1,
                                            side + cside * IP_TN + r0, lr);
        cside = cside + 1 == IP_STAGES ? 0 : cside + 1;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < IP_RX; ++jj) acc[i][jj] = 0.f;
        ck = 0;
        ++ct;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int e = t; e < IP_TM * a.k; e += IP_THREADS) {
      const int r = e / a.k, m = lr.m[r];
      if (m >= 0) {
        const size_t o = ((size_t)m * a.S + lr.slot[r]) * a.k + e % a.k;
        a.pv[o] = f.lv[e];
        a.pi[o] = f.li[e];
      }
    }
  }
  if (a.clocks && t == 0) {
    f.clk[IP_CLK_KERNEL] = clock64() - t_kernel;
    for (int c = 0; c < IP_CLK_N; ++c) atomicAdd(a.clocks + c, f.clk[c]);
  }
}

// Shared memory of one block of ip_list_kernel at list length k.
template <typename XT>
static size_t ip_list_smem(int k) {
  return (size_t)IP_STAGES * ip_stage_bytes<XT, 1>() + IP_LIST_HEAD + (size_t)IP_TM * k * 8 +
         (size_t)IP_TM * IP_CAP * 8 + IP_TM * 20 + IP_CLK_N * 8;
}

// One pass of the work-item scan (a.k <= TOPK_PASS_K) on `blocks` blocks
// (one an SM): the item counter and (k >= IP_FLOORS_MIN_K) the shared floors
// (a.M x 2 a.S) reset first.
template <typename XT, bool CEIL>
static cudaError_t launch_ip_list_pass(const IpListArgs& a, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(a.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const bool floors = a.k >= IP_FLOORS_MIN_K;
  const long long nf = (long long)a.M * a.S * 2;
  if (floors && nf > 0) {
    ip_floor_reset_kernel<<<(unsigned)((nf + 255) / 256), 256, 0, stream>>>(a.floors, nf);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = ip_list_smem<XT>(a.k);
  auto kernel = floors ? ip_list_kernel<XT, CEIL, true> : ip_list_kernel<XT, CEIL, false>;
  err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, IP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

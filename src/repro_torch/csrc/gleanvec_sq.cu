// gleanvec_sq_topk: fused GleanVec (and GleanVec o int8) scan + top-k on
// Hopper (sm_90a).
//
// Replaces the TPU kernel `gleanvec_sq_topk` in
// src/repro/kernels/gleanvec_sq/gleanvec_sq.py (pallas_call body
// `_topk_kernel`, score tile `_tile_scores`):
//   score[m, n] = <q_scaled[m, tag_n], codes_n> + q_lo[m, tag_n]
// with q_scaled (M, C, d) f32, q_lo (M, C) f32, codes (N, d) uint8 or f32,
// and ids taken from row_ids (N,) (-1 = masked, never wins; default: row).
// Two layouts:
//   * gathered: tags (N,) per row;
//   * sorted: the rows are tag-sorted and cluster-padded, tags hold one
//     entry per layout block.
//
// What bounds it on an H100 SXM: at M = 1024, N = 2,000,000 (sorted: the
// padded row count), d = 160, C = 48, k = 100, 2 d flops per query-row pair
// give 6.6e11 flop = 9.8 ms at the 67 TFLOP/s fp32 peak, against 0.33 GB of
// u8 codes (1.3 GB f32) plus tags = 0.1 (0.4) ms at 3.35 TB/s: fp32 FMA
// bound.
//
// What the design does about it: each tile is scored as a plain product of
// the queries' view of the tile's rows against them, with the view's
// offset added after the FMA chain.
//   * sorted: the pipelined scan of ip_scan.cuh (64 x 512 tiles, an 8 x 16
//     register tile a thread, a cp.async ring, one block an SM, one wave of
//     splits, the fold filtered by each query's k-th value and, for k >= 64,
//     by floors the splits share), with one view per layout block: tiles
//     cut at layout-block ends, or (layout blocks of 256 rows, the stream's)
//     one view per half tile, both views staged a chunk (`views` = 2,
//     gleanvec_sq_sorted_views). The tile's ids (row_ids) and offsets ride
//     with its first depth chunk. For k >= 64 the splits of a query share
//     the larger of two floors (ip_share_floor): a query's best rows sit in
//     the clusters of a few splits.
//   * gathered: a per-call bucketing (bucket_rows.cuh, three small launches)
//     lays each tag's rows out in 128-slot tiles of one tag, and the
//     register-tiled scan of scan_gemm.cuh stages x[rows[slot], :] through
//     that indirection; ids are row_ids[row] (or the row), padding
//     slots are -1 and never win.
// Each (query, row) score is the same FMA chain in either layout and scan,
// and the top-k order does not depend on the scan order. N is split across
// blocks; a second kernel merges the (M, S, k) partial lists
// (topk_common.cuh); k above TOPK_PASS_K runs in passes. All arithmetic is
// fp32 FMA, no TF32.
#include "scan_gemm.cuh"
#include "bucket_rows.cuh"
#include "error.cuh"
#include "ip_scan.cuh"

// Workspace bytes of the gathered path's bucketing (tags (N,), C views);
// off[0..3] get the byte offsets of its counts, tile_tags, rows and slot_of.
extern "C" long long gleanvec_sq_bucket_workspace(int N, int C, long long* off) {
  size_t o[4];
  const size_t bytes = bucket_offsets(N, C, o);
  for (int i = 0; i < 4; ++i) off[i] = (long long)o[i];
  return (long long)bytes;
}

// The bucketing alone, into ws: rows (T * 128,), tile_tags (T,) and
// slot_of (N,) at the offsets above.
extern "C" int gleanvec_sq_bucket_rows(const int* tags, int N, int C, void* ws,
                                       void* stream) {
  Buckets b;
  return (int)launch_buckets(tags, N, C, ws, &b, (cudaStream_t)stream);
}

template <typename XT>
static int gathered_impl(const float* qs, const float* qlo, const int* tags,
                         const int* row_ids, const XT* codes, int M, int C, int d,
                         int N, int k, int S, void* ws, float* pv, int* pi,
                         float* out_v, int* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Buckets b;
  cudaError_t err = launch_buckets(tags, N, C, ws, &b, st);
  if (err != cudaSuccess) return (int)err;
  GemmScanArgs a;
  a.q = qs;
  a.q_stride = (long long)C * d;
  a.d = d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = b.tile_tags;
  a.row_ids = row_ids;
  a.rows = b.rows;
  a.x = codes;
  a.N = bucket_tiles(N, C) * GT_N;
  a.L = GT_N;
  a.M = M;
  a.k = k;
  a.S = S;
  a.pv = pv;
  a.pi = pi;
  return (int)launch_gemm_scan_rows<XT>(a, out_v, out_i, st);
}

// S splits of the tiles; pv / pi: (M, S, min(k, TOPK_PASS_K)) partial
// lists; floors: (M, 2 S) int scratch (the splits' shared floors).
template <typename XT>
static int sorted_impl(const float* qs, const float* qlo, const int* block_tags,
                       const int* row_ids, const XT* codes, int M, int C, int d,
                       int N, int layout_block, int views, int k, int S, float* pv,
                       int* pi, int* floors, float* out_v, int* out_i, void* stream) {
  IpSegArgs a = ip_seg_args(qs, codes, M, N, d, k, S, pv, pi, floors);
  a.q_ld = (long long)C * d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = block_tags;
  a.row_ids = row_ids;
  a.L = layout_block;
  return (int)launch_ip_seg_scan<XT>(a, views, k, out_v, out_i, (cudaStream_t)stream);
}

extern "C" int gleanvec_sq_gathered_topk_f32(const float* qs, const float* qlo,
                                             const int* tags, const int* row_ids,
                                             const float* codes, int M, int C, int d,
                                             int N, int k, int S, void* ws, float* pv,
                                             int* pi, float* out_v, int* out_i,
                                             void* stream) {
  return gathered_impl<float>(qs, qlo, tags, row_ids, codes, M, C, d, N, k, S, ws, pv,
                              pi, out_v, out_i, stream);
}

extern "C" int gleanvec_sq_gathered_topk_u8(const float* qs, const float* qlo,
                                            const int* tags, const int* row_ids,
                                            const uint8_t* codes, int M, int C, int d,
                                            int N, int k, int S, void* ws, float* pv,
                                            int* pi, float* out_v, int* out_i,
                                            void* stream) {
  return gathered_impl<uint8_t>(qs, qlo, tags, row_ids, codes, M, C, d, N, k, S, ws,
                                pv, pi, out_v, out_i, stream);
}
// Sorted layout: block_tags (ceil(N / layout_block),), one view a layout
// block; views = gleanvec_sq_sorted_views(layout_block, k, u8).
extern "C" int gleanvec_sq_sorted_topk_f32(const float* qs, const float* qlo,
                                           const int* block_tags, const int* row_ids,
                                           const float* codes, int M, int C, int d,
                                           int N, int layout_block, int views, int k,
                                           int S, float* pv, int* pi, int* floors,
                                           float* out_v, int* out_i, void* stream) {
  return sorted_impl<float>(qs, qlo, block_tags, row_ids, codes, M, C, d, N,
                            layout_block, views, k, S, pv, pi, floors, out_v, out_i,
                            stream);
}

extern "C" int gleanvec_sq_sorted_topk_u8(const float* qs, const float* qlo,
                                          const int* block_tags, const int* row_ids,
                                          const uint8_t* codes, int M, int C, int d,
                                          int N, int layout_block, int views, int k,
                                          int S, float* pv, int* pi, int* floors,
                                          float* out_v, int* out_i, void* stream) {
  return sorted_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes, M, C, d, N,
                              layout_block, views, k, S, pv, pi, floors, out_v, out_i,
                              stream);
}

// The views (1 or 2) the sorted scan takes for layout blocks of L rows at
// list length k (ip_seg_views): its tiles are ceil(N / tile rows) when 2,
// else ceil(N / L) * ceil(L / tile rows).
extern "C" int gleanvec_sq_sorted_views(int L, int k, int u8) {
  return u8 ? ip_seg_views<uint8_t>(L, k) : ip_seg_views<float>(L, k);
}

// The sorted scan's block tile: 0 -> queries per block (IP_TM), 1 -> rows
// per tile (IP_TN).
extern "C" int gleanvec_sq_sorted_tile(int which) { return which == 0 ? IP_TM : IP_TN; }

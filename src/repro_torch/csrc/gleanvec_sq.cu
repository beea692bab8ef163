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
//     entry per layout block, so every tile has ONE view.
//
// What bounds it on an H100 SXM: at M = 1024, N = 2,000,000 (sorted: the
// padded row count), d = 160, C = 48, k = 100, 2 d flops per query-row pair
// give 6.6e11 flop = 9.8 ms at the 67 TFLOP/s fp32 peak, against 0.33 GB of
// u8 codes (1.3 GB f32) plus tags = 0.1 (0.4) ms at 3.35 TB/s: fp32 FMA
// bound.
//
// What the design does about it:
//   * sorted: the tile's one view makes scoring a plain (64 x d) x (d x 128)
//     product, run by the register-tiled fp32 scan of scan_gemm.cuh with the
//     tile's view q_scaled[:, tag, :] and offset q_lo[:, tag]. A tile never
//     crosses a layout block. Same FMA bound as ip_topk.
//   * gathered: the per-row-tag tile of gather_scan.cuh (views of <= 4
//     queries in shared memory, rows counting-sorted by tag per tile), bound
//     by shared-memory reads of the views: a quarter of the FMA peak at best.
//     That is the cost the sorted layout exists to remove.
// N is split across blocks; a second kernel merges the (M, S, k) partial
// lists (topk_common.cuh). All arithmetic is fp32 FMA, no TF32.
#include "scan_gemm.cuh"
#include "gather_scan.cuh"
#include "error.cuh"

// Queries per block of the gathered path: the most (4, 2 or 1) whose views
// fit the 227 KB a block may use; 0 = none fits.
extern "C" int gleanvec_sq_gathered_queries_per_block(int C, int d, int k) {
  return gathered_tmg(C, d, k);
}

template <typename XT>
static int gathered_impl(const float* qs, const float* qlo, const int* tags,
                         const int* row_ids, const XT* codes, int M, int C, int d,
                         int N, int k, int tmg, int S, float* pv, int* pi,
                         float* out_v, int* out_i, void* stream) {
  GatherArgs a{qs, qlo, tags, row_ids, codes, M, C, d, N, k, S, pv, pi};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_gathered_tmg<XT, false>(a, tmg, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(pv, pi, M, S, k, out_v, out_i, st);
}

template <typename XT>
static int sorted_impl(const float* qs, const float* qlo, const int* block_tags,
                       const int* row_ids, const XT* codes, int M, int C, int d,
                       int N, int layout_block, int k, int S, float* pv, int* pi,
                       float* out_v, int* out_i, void* stream) {
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
  a.L = layout_block;
  a.M = M;
  a.k = k;
  a.S = S;
  a.pv = pv;
  a.pi = pi;
  return (int)launch_gemm_scan<XT>(a, out_v, out_i, (cudaStream_t)stream);
}

extern "C" int gleanvec_sq_gathered_topk_f32(const float* qs, const float* qlo,
                                             const int* tags, const int* row_ids,
                                             const float* codes, int M, int C, int d,
                                             int N, int k, int tmg, int S, float* pv,
                                             int* pi, float* out_v, int* out_i,
                                             void* stream) {
  return gathered_impl<float>(qs, qlo, tags, row_ids, codes, M, C, d, N, k, tmg, S,
                              pv, pi, out_v, out_i, stream);
}

extern "C" int gleanvec_sq_gathered_topk_u8(const float* qs, const float* qlo,
                                            const int* tags, const int* row_ids,
                                            const uint8_t* codes, int M, int C, int d,
                                            int N, int k, int tmg, int S, float* pv,
                                            int* pi, float* out_v, int* out_i,
                                            void* stream) {
  return gathered_impl<uint8_t>(qs, qlo, tags, row_ids, codes, M, C, d, N, k, tmg, S,
                                pv, pi, out_v, out_i, stream);
}

extern "C" int gleanvec_sq_sorted_topk_f32(const float* qs, const float* qlo,
                                           const int* block_tags, const int* row_ids,
                                           const float* codes, int M, int C, int d,
                                           int N, int layout_block, int k, int S,
                                           float* pv, int* pi, float* out_v,
                                           int* out_i, void* stream) {
  return sorted_impl<float>(qs, qlo, block_tags, row_ids, codes, M, C, d, N,
                            layout_block, k, S, pv, pi, out_v, out_i, stream);
}

extern "C" int gleanvec_sq_sorted_topk_u8(const float* qs, const float* qlo,
                                          const int* block_tags, const int* row_ids,
                                          const uint8_t* codes, int M, int C, int d,
                                          int N, int layout_block, int k, int S,
                                          float* pv, int* pi, float* out_v,
                                          int* out_i, void* stream) {
  return sorted_impl<uint8_t>(qs, qlo, block_tags, row_ids, codes, M, C, d, N,
                              layout_block, k, S, pv, pi, out_v, out_i, stream);
}

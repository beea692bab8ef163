// Dense score kernels on Hopper (sm_90a): sq_dot, gleanvec_ip and dense
// gleanvec_sq. Each writes the whole (M, N) f32 score matrix; the streaming
// stores' live-masked scans (kernels.scorer_scores) and their top-k read it.
//
// Replaces three TPU kernels:
//   * `sq_dot` in src/repro/kernels/sq_dot/sq_dot.py (pallas_call body
//     `_sq_dot_kernel`): scores[m, n] = <q_scaled_m, u_n> + q_lo_m, the
//     int8 codes u (N, d) with the per-dimension scales folded into the
//     query outside (q_scaled = q * delta, q_lo = <q, lo>);
//   * `gleanvec_ip` in src/repro/kernels/gleanvec_ip/gleanvec_ip.py
//     (`_gleanvec_ip_kernel`): scores[m, n] = <q_views[m, tag_n], x_n>,
//     per-row tags, f32 rows (Alg. 4);
//   * `gleanvec_sq` in src/repro/kernels/gleanvec_sq/gleanvec_sq.py
//     (`_dense_kernel`): scores[m, n] = <q_scaled[m, tag_n], codes_n> +
//     q_lo[m, tag_n], codes u8 or f32, tags per row (gathered) or per layout
//     block (sorted).
//
// What bounds them on an H100 SXM: at the stream's shapes (M = 1024,
// N = 2,000,000 rows, or the sorted layout's padded rows, d = 160) each
// query-row pair costs 2 d flops: 6.6e11 flop = 9.8 ms at the 67 TFLOP/s
// fp32 peak, against 8.2 GB of f32 output (plus 0.3 GB of u8 or 1.3 GB of
// f32 rows) = 2.5-2.8 ms at 3.35 TB/s: fp32 FMA bound, as the fused scans.
//
// What the design does about it: the fused scans' tiles with a dense-store
// epilogue in place of the top-k fold.
//   * sq_dot and the sorted layout: the register-tiled fp32 product of
//     scan_gemm.cuh (64 x 128 tiles, each thread 4 x 8 scores; a tile's one
//     view and its offset per query); the tile goes through shared memory
//     and each warp writes a query row's 128 scores with consecutive lanes
//     on consecutive columns. sq_dot is the one-view case (C = 1).
//   * gleanvec_ip and the gathered layout: the per-row-tag tile of
//     gather_scan.cuh (views of <= 4 queries in shared memory, one thread
//     per row), bound by shared-memory reads of the views; gleanvec_ip is
//     its f32 case without an affine term.
// Row splits across blocks need no merge: every block writes its own
// columns. All arithmetic is fp32 FMA, no TF32.
#include "scan_gemm.cuh"
#include "gather_scan.cuh"
#include "error.cuh"

template <typename XT>
static int gemm_dense(const float* q, long long q_stride, const float* qlo, int C,
                      const int* seg_tags, const XT* x, int M, int d, int N, int L,
                      int S, float* out, void* stream) {
  GemmScanArgs a;
  a.q = q;
  a.q_stride = q_stride;
  a.d = d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = seg_tags;
  a.row_ids = nullptr;
  a.x = x;
  a.N = N;
  a.L = L;
  a.M = M;
  a.k = 0;
  a.S = S;
  a.pv = out;
  a.pi = nullptr;
  return (int)launch_gemm_dense<XT>(a, (cudaStream_t)stream);
}

template <typename XT>
static int gathered_dense(const float* qs, const float* qlo, const int* tags,
                          const XT* x, int M, int C, int d, int N, int tmg, int S,
                          float* out, void* stream) {
  GatherArgs a{qs, qlo, tags, nullptr, x, M, C, d, N, 0, S, out, nullptr};
  return (int)launch_gathered_tmg<XT, true>(a, tmg, (cudaStream_t)stream);
}

// Queries per block of the gathered tile (views of one query: C (d + 1)
// floats); 0 = they do not fit a block's shared memory.
extern "C" int dense_gathered_queries_per_block(int C, int d) {
  return gathered_tmg(C, d, 0);
}

// sq_dot: q_scaled (M, d) f32, q_lo (M,) f32, codes (N, d) u8 -> (M, N).
extern "C" int sq_dot_u8(const float* q_scaled, const float* q_lo,
                         const uint8_t* codes, int M, int d, int N, int S,
                         float* out, void* stream) {
  return gemm_dense<uint8_t>(q_scaled, d, q_lo, 1, nullptr, codes, M, d, N, GT_N,
                             S, out, stream);
}

// gleanvec_ip: q_views (M, C, d) f32, tags (N,) i32, x_low (N, d) f32 -> (M, N);
// zeros (M, C) is the tile's affine term (gleanvec_ip has none).
extern "C" int gleanvec_ip_f32(const float* q_views, const float* zeros,
                               const int* tags, const float* x_low, int M, int C,
                               int d, int N, int tmg, int S, float* out,
                               void* stream) {
  return gathered_dense<float>(q_views, zeros, tags, x_low, M, C, d, N, tmg, S, out,
                               stream);
}

// dense gleanvec_sq, gathered: tags (N,) per row.
extern "C" int gleanvec_sq_dense_gathered_f32(const float* qs, const float* qlo,
                                              const int* tags, const float* codes,
                                              int M, int C, int d, int N, int tmg,
                                              int S, float* out, void* stream) {
  return gathered_dense<float>(qs, qlo, tags, codes, M, C, d, N, tmg, S, out, stream);
}

extern "C" int gleanvec_sq_dense_gathered_u8(const float* qs, const float* qlo,
                                             const int* tags, const uint8_t* codes,
                                             int M, int C, int d, int N, int tmg,
                                             int S, float* out, void* stream) {
  return gathered_dense<uint8_t>(qs, qlo, tags, codes, M, C, d, N, tmg, S, out,
                                 stream);
}

// dense gleanvec_sq, sorted: block_tags (ceil(N / L),), one view per block.
extern "C" int gleanvec_sq_dense_sorted_f32(const float* qs, const float* qlo,
                                            const int* block_tags, const float* codes,
                                            int M, int C, int d, int N,
                                            int layout_block, int S, float* out,
                                            void* stream) {
  return gemm_dense<float>(qs, (long long)C * d, qlo, C, block_tags, codes, M, d, N,
                           layout_block, S, out, stream);
}

extern "C" int gleanvec_sq_dense_sorted_u8(const float* qs, const float* qlo,
                                           const int* block_tags,
                                           const uint8_t* codes, int M, int C, int d,
                                           int N, int layout_block, int S, float* out,
                                           void* stream) {
  return gemm_dense<uint8_t>(qs, (long long)C * d, qlo, C, block_tags, codes, M, d, N,
                             layout_block, S, out, stream);
}

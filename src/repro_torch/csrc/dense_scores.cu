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
//   * sq_dot: the pipelined scan of ip_scan.cuh, its one-view case (64 x
//     512 tiles, an 8 x 16 register tile a thread, a cp.async ring, one
//     block an SM, one wave of splits); each warp stages its finished
//     32 x 128 piece through shared memory, 4 queries at a time, and writes
//     whole 128-byte lines with streaming stores.
//   * dense gleanvec_sq, sorted layout: the same scan and store with the
//     query views (M, C, d) of the layout blocks: one view a tile, tiles cut
//     at layout-block ends (V = 1, any layout block), or two views a tile,
//     one a column half, for layout blocks of 256 (V = 2, the stream's);
//     each tile's offsets q_lo[m, tag] ride in with its first chunk and are
//     added after the FMA chain, as in the sorted top-k.
//   * gleanvec_ip and the gathered layout: the per-call bucketing of
//     bucket_rows.cuh gives every 128-slot tile one tag; the tile stages
//     x[rows[slot], :] and writes its scores in slot order to a buffer of a
//     chunk of queries (at most 2^28 floats), which bucket_unpermute_kernel
//     gathers into the rows' columns of the output: 2 x 8.2 GB more traffic
//     (~7 ms on an H100 at M = 1024, N = 2M) in place of 8.2 GB of 4-byte
//     stores scattered ~C columns apart (~70 ms more). gleanvec_ip is its
//     f32 case without an affine term.
// Row splits across blocks need no merge: every block writes its own
// columns. All arithmetic is fp32 FMA, no TF32.
#include "scan_gemm.cuh"
#include "bucket_rows.cuh"
#include "error.cuh"
#include "ip_scan.cuh"

// Dense sorted scores: qs (M, C, d) views, qlo (M, C), block_tags
// (ceil(N / L),) on ceil(M / IP_TM) x S blocks (V = ip_dense_views(L)).
template <typename XT>
static int sorted_dense(const float* qs, const float* qlo, const int* block_tags,
                        const XT* x, int M, int C, int d, int N, int L, int S, float* out,
                        void* stream) {
  IpSegArgs a = ip_seg_args(qs, x, M, N, d, 0, S, nullptr, nullptr, nullptr);
  a.q_ld = (long long)C * d;
  a.qlo = qlo;
  a.C = C;
  a.seg_tags = block_tags;
  a.L = L;
  a.out = out;
  a.out_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return (int)launch_ip_dense<XT>(a, (cudaStream_t)stream);
}

// qlo may be null (no affine term). buf holds mc * slots floats (slots =
// bucket_tiles(N, C) * GT_N); queries go through in chunks of mc.
template <typename XT>
static int gathered_dense(const float* qs, const float* qlo, const int* tags,
                          const XT* x, int M, int C, int d, int N, int S, void* ws,
                          float* buf, int mc, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Buckets b;
  cudaError_t err = launch_buckets(tags, N, C, ws, &b, st);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)bucket_tiles(N, C) * GT_N;
  for (int m0 = 0; m0 < M; m0 += mc) {
    const int mm = M - m0 < mc ? M - m0 : mc;
    GemmScanArgs a;
    a.q = qs + (size_t)m0 * C * d;
    a.q_stride = (long long)C * d;
    a.d = d;
    a.qlo = qlo ? qlo + (size_t)m0 * C : nullptr;
    a.C = C;
    a.seg_tags = b.tile_tags;
    a.row_ids = nullptr;
    a.rows = b.rows;
    a.x = x;
    a.N = (int)slots;
    a.L = GT_N;
    a.M = mm;
    a.k = 0;
    a.S = S;
    a.pv = buf;
    a.pi = nullptr;
    if ((err = launch_gemm_dense<XT>(a, st)) != cudaSuccess) return (int)err;
    if (N > 0) {
      const dim3 grid((unsigned)((N + BK_WINDOW - 1) / BK_WINDOW), (unsigned)mm);
      bucket_unpermute_kernel<<<grid, BK_THREADS, 0, st>>>(buf, b.slot_of, N, slots,
                                                           out + (size_t)m0 * N);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// Workspace bytes of the gathered kernels' bucketing (tags (N,), C views).
extern "C" long long dense_bucket_workspace_bytes(int N, int C) {
  size_t off[4];
  return (long long)bucket_offsets(N, C, off);
}

// sq_dot: q_scaled (M, d) f32, q_lo (M,) f32, codes (N, d) u8 -> (M, N), on
// ceil(M / IP_TM) x S blocks.
extern "C" int sq_dot_u8(const float* q_scaled, const float* q_lo,
                         const uint8_t* codes, int M, int d, int N, int S,
                         float* out, void* stream) {
  IpSegArgs a = ip_seg_args(q_scaled, codes, M, N, d, 0, S, nullptr, nullptr, nullptr);
  a.qlo = q_lo;
  a.L = N;  // one layout block: one view
  a.out = out;
  a.out_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return (int)launch_ip_dense_v<uint8_t, 1>(a, (cudaStream_t)stream);
}

// sq_dot's block tile: 0 -> queries per block (IP_TM), 1 -> rows per tile
// (IP_TN).
extern "C" int sq_dot_tile(int which) { return which == 0 ? IP_TM : IP_TN; }

// gleanvec_ip: q_views (M, C, d) f32, tags (N,) i32, x_low (N, d) f32 -> (M, N)
// (no affine term).
extern "C" int gleanvec_ip_f32(const float* q_views, const int* tags,
                               const float* x_low, int M, int C, int d, int N, int S,
                               void* ws, float* buf, int mc, float* out,
                               void* stream) {
  return gathered_dense<float>(q_views, nullptr, tags, x_low, M, C, d, N, S, ws, buf,
                               mc, out, stream);
}

// dense gleanvec_sq, gathered: tags (N,) per row.
extern "C" int gleanvec_sq_dense_gathered_f32(const float* qs, const float* qlo,
                                              const int* tags, const float* codes,
                                              int M, int C, int d, int N, int S,
                                              void* ws, float* buf, int mc,
                                              float* out, void* stream) {
  return gathered_dense<float>(qs, qlo, tags, codes, M, C, d, N, S, ws, buf, mc, out,
                               stream);
}

extern "C" int gleanvec_sq_dense_gathered_u8(const float* qs, const float* qlo,
                                             const int* tags, const uint8_t* codes,
                                             int M, int C, int d, int N, int S,
                                             void* ws, float* buf, int mc,
                                             float* out, void* stream) {
  return gathered_dense<uint8_t>(qs, qlo, tags, codes, M, C, d, N, S, ws, buf, mc,
                                 out, stream);
}

// dense gleanvec_sq, sorted: block_tags (ceil(N / L),), one view per block,
// on ceil(M / IP_TM) x S blocks over the tiles of
// gleanvec_sq_dense_sorted_views(layout_block, u8) views.
extern "C" int gleanvec_sq_dense_sorted_f32(const float* qs, const float* qlo,
                                            const int* block_tags, const float* codes,
                                            int M, int C, int d, int N,
                                            int layout_block, int S, float* out,
                                            void* stream) {
  return sorted_dense<float>(qs, qlo, block_tags, codes, M, C, d, N, layout_block, S,
                             out, stream);
}

extern "C" int gleanvec_sq_dense_sorted_u8(const float* qs, const float* qlo,
                                           const int* block_tags,
                                           const uint8_t* codes, int M, int C, int d,
                                           int N, int layout_block, int S, float* out,
                                           void* stream) {
  return sorted_dense<uint8_t>(qs, qlo, block_tags, codes, M, C, d, N, layout_block, S,
                               out, stream);
}

// The views (1 or 2) the sorted dense scan takes for layout blocks of L
// rows (ip_dense_views): its tiles are ceil(N / tile rows) when 2, else
// ceil(N / L) * ceil(L / tile rows).
extern "C" int gleanvec_sq_dense_sorted_views(int L, int u8) {
  return u8 ? ip_dense_views<uint8_t>(L) : ip_dense_views<float>(L);
}

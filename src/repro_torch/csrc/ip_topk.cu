// ip_topk: fused inner-product scan + top-k on Hopper (sm_90a).
//
// Replaces the TPU kernel `ip_topk` in src/repro/kernels/ip_topk/ip_topk.py
// (pallas_call body `_ip_topk_kernel`): for q (M, d) f32 and x (N, d) f32 or
// uint8 (cast on load), vals/ids (M, k) = the k largest <q_m, x_n> per query,
// ids = column index, columns >= N masked.
//
// What bounds it on an H100 SXM: at the flat path's shapes (M = 1024,
// N = 2,000,000; d = 512, k = 10 for `full`; d = 160, k = 100 for the
// sphering modes) each query-row pair costs 2 d flops. `full`:
// 2 * 1024 * 2e6 * 512 = 2.10e12 flop over the 67 TFLOP/s fp32 (non tensor
// core) peak = 31.3 ms, against 4.1 GB of x over 3.35 TB/s = 1.2 ms.
// `sphering`: 6.6e11 flop = 9.8 ms against 1.3 GB (f32) or 0.33 GB (u8) =
// 0.4 / 0.1 ms. So the kernel is bound by fp32 FMA throughput, not bytes.
//
// What the design does about it: a register-tiled fp32 product (each thread
// 4 x 8 scores, 3 vector shared loads per 32 FMAs) over 64 x 128 tiles
// (scan_gemm.cuh); the top-k fold only touches scores above the running
// k-th value, so after the first tiles it costs a compare per score.
// Query tiles are the fastest grid dimension, so the blocks resident at one
// time read the same x tiles and x streams from device memory about once.
// N is split across blocks (Hopper blocks run in parallel, unlike the TPU's
// sequential grid); a second kernel merges the (M, S, k) partial lists.
// No TF32 and no tensor cores: all arithmetic is fp32 FMA, as the reference's
// f32 dot. wgmma / TMA pipelining is later work.
#include "scan_gemm.cuh"
#include "error.cuh"

template <typename XT>
static int ip_topk_impl(const float* q, const XT* x, int M, int N, int d, int k,
                        int S, float* pv, int* pi, float* out_v, int* out_i,
                        void* stream) {
  GemmScanArgs a;
  a.q = q;
  a.q_stride = d;
  a.d = d;
  a.qlo = nullptr;
  a.C = 1;
  a.seg_tags = nullptr;
  a.row_ids = nullptr;
  a.x = x;
  a.N = N;
  a.L = GT_N;
  a.M = M;
  a.k = k;
  a.S = S;
  a.pv = pv;
  a.pi = pi;
  return (int)launch_gemm_scan<XT>(a, out_v, out_i, (cudaStream_t)stream);
}

extern "C" int ip_topk_f32(const float* q, const float* x, int M, int N, int d,
                           int k, int S, float* pv, int* pi, float* out_v,
                           int* out_i, void* stream) {
  return ip_topk_impl<float>(q, x, M, N, d, k, S, pv, pi, out_v, out_i, stream);
}

extern "C" int ip_topk_u8(const float* q, const uint8_t* x, int M, int N, int d,
                          int k, int S, float* pv, int* pi, float* out_v,
                          int* out_i, void* stream) {
  return ip_topk_impl<uint8_t>(q, x, M, N, d, k, S, pv, pi, out_v, out_i, stream);
}

// ip_topk: fused inner-product scan + top-k on Hopper (sm_90a).
//
// Replaces the TPU kernel `ip_topk` in src/repro/kernels/ip_topk/ip_topk.py
// (pallas_call body `_ip_topk_kernel`): for q (M, d) f32 and x (N, d) f32 or
// uint8 (cast on load), vals/ids (M, k) = the k largest <q_m, x_n> per query,
// ids = column index, columns >= N masked.
//
// What bounds it on an H100 SXM: at the main path's shapes (M = 1024,
// N = 2,000,000; d = 512, k = 10 for `full`; d = 160, k = 100 for the
// sphering modes; N = 1,000,000, d = 513, k = 49 for the graph build's
// self-join) each query-row pair costs 2 d flops. `full`:
// 2 * 1024 * 2e6 * 512 = 2.10e12 flop over the 67 TFLOP/s fp32 (non tensor
// core) peak = 31.3 ms, against 4.1 GB of x over 3.35 TB/s = 1.2 ms.
// `sphering`: 6.6e11 flop = 9.8 ms against 1.3 GB (f32) or 0.33 GB (u8) =
// 0.4 / 0.1 ms. So the kernel is bound by fp32 FMA throughput, not bytes.
//
// What the design does about it (ip_scan.cuh): an 8 x 16 register tile of
// scores per thread over 64 x 512 tiles, 21 FMAs per shared load, one block
// an SM, operands streamed by cp.async through a ring of three depth chunks
// so that copies overlap the FMAs; a score reaches the top-k fold only if
// it beats its query's k-th entry (and, for k >= 64, a floor the splits of
// a query share), so after the first tiles the fold costs a compare per
// score. Query blocks are the fastest grid dimension, so the
// blocks resident at one time read the same x tiles and x streams from
// device memory about once. N is split across blocks for one wave (Hopper
// blocks run in parallel, unlike the TPU's sequential grid); a second
// kernel merges the (M, S, k) partial lists. No TF32 and no tensor cores:
// all arithmetic is fp32 FMA, as the reference's f32 dot.
#include <cstdint>

#include "error.cuh"
#include "ip_scan.cuh"

// S splits of the row tiles; pv / pi: (M, S, min(k, TOPK_PASS_K)) partial
// lists; floors: (M, S) int scratch (the splits' shared floors).
template <typename XT>
static int ip_topk_impl(const float* q, const XT* x, int M, int N, int d, int k, int S,
                        float* pv, int* pi, int* floors, float* out_v, int* out_i,
                        void* stream) {
  const IpScanArgs a = ip_scan_args(q, x, M, N, d, k, S, pv, pi, floors);
  return (int)launch_ip_scan<XT>(a, k, out_v, out_i, (cudaStream_t)stream);
}

extern "C" int ip_topk_f32(const float* q, const float* x, int M, int N, int d, int k,
                           int S, float* pv, int* pi, int* floors, float* out_v,
                           int* out_i, void* stream) {
  return ip_topk_impl<float>(q, x, M, N, d, k, S, pv, pi, floors, out_v, out_i, stream);
}

extern "C" int ip_topk_u8(const float* q, const uint8_t* x, int M, int N, int d, int k,
                          int S, float* pv, int* pi, int* floors, float* out_v,
                          int* out_i, void* stream) {
  return ip_topk_impl<uint8_t>(q, x, M, N, d, k, S, pv, pi, floors, out_v, out_i, stream);
}

// One pass of the scan alone (k <= TOPK_PASS_K; no merge) with its fold
// profile summed into clocks[IP_CLK_N] (zeroed by the caller): thread 0's
// clock64 cycles in the kernel, in its folds, and in the folds' parts.
extern "C" int ip_topk_profile(const float* q, const void* x, int x_u8, int M, int N, int d,
                               int k, int S, float* pv, int* pi, int* floors,
                               unsigned long long* clocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > TOPK_PASS_K) return (int)cudaErrorInvalidValue;
  if (x_u8) {
    const uint8_t* xb = static_cast<const uint8_t*>(x);
    IpScanArgs a = ip_scan_args(q, xb, M, N, d, k, S, pv, pi, floors);
    a.clocks = clocks;
    return (int)launch_ip_scan_pass<uint8_t, 0, false>(a, st);
  }
  IpScanArgs a = ip_scan_args(q, static_cast<const float*>(x), M, N, d, k, S, pv, pi, floors);
  a.clocks = clocks;
  return (int)launch_ip_scan_pass<float, 0, false>(a, st);
}

// The block tile the wrapper sizes its grid and partial lists by: 0 ->
// queries per block (IP_TM), 1 -> rows per tile (IP_TN).
extern "C" int ip_topk_tile(int which) { return which == 0 ? IP_TM : IP_TN; }

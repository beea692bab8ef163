// kmeans_assign: spherical k-means assignment scan (paper Eq. 14 / 23) on
// Hopper (sm_90a).
//
// Replaces the TPU kernel `kmeans_assign` in
// src/repro/kernels/kmeans_assign/kmeans_assign.py (pallas_call body
// `_kmeans_assign_kernel`): for x (N, D) f32 and centers (C, D) f32,
// tags[n] = argmax_c <x_n, c> (ties to the first index, like jnp.argmax)
// and maxsim[n] = max_c <x_n, c>.
//
// What bounds it on an H100 SXM: at the flat path's fit (N = 2,000,000,
// D = 512, C = 48) one pass costs 2 N C D = 9.8e10 flop = 1.47 ms at the
// 67 TFLOP/s fp32 peak, and reads 4.1 GB of x = 1.22 ms at 3.35 TB/s
// (writes 16 MB). The two are within 20%: fp32 FMA throughput is the
// nominal bound, with memory close behind.
//
// What the design does about it: the centers stay resident in dynamic
// shared memory, transposed (D x C, 96 KB at C = 48, D = 512, so two blocks
// fit an SM), and are read from device memory once per block; persistent
// blocks stream x in tiles of 128 rows, each read once, staged through
// shared memory in depth chunks of 32 with coalesced loads. Each thread
// keeps a 4-row x CPT-center register tile (CPT = ceil(C / 8)), so a depth
// step costs 1 + CPT shared loads for 4 CPT FMAs. The argmax scans a
// thread's centers in ascending order with strict `>`, then combines the 8
// threads of a row by (larger value, else smaller index): the first maximum
// wins. More centers than one block's shared memory holds (C > 64, or fewer
// at a large D) run in chunks of at most 8 * CPT_MAX centers, one launch
// each over all rows: a later chunk replaces a row's (tag, maxsim) only
// where its best is strictly greater (RUNNING), so ties still go to the
// first center. All arithmetic is fp32 FMA, no TF32.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include "error.cuh"

constexpr int KA_ROWS = 128;
constexpr int KA_K = 32;
constexpr int KA_THREADS = 256;
constexpr int KA_XS = KA_ROWS + 4;

static size_t kmeans_smem(int D, int cpt) {
  const int dp = (D + KA_K - 1) / KA_K * KA_K;
  return ((size_t)dp * 8 * cpt + (size_t)KA_K * KA_XS) * 4;
}

// centers: this chunk's C rows, whose indices start at c0.
template <int CPT, bool RUNNING>
__global__ void __launch_bounds__(KA_THREADS)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ centers,
                         int N, int D, int C, int c0, int* __restrict__ tags,
                         float* __restrict__ maxsim) {
  extern __shared__ __align__(16) float ksm[];
  constexpr int CP = 8 * CPT;
  const int dp = (D + KA_K - 1) / KA_K * KA_K;
  float* cs = ksm;            // dp x CP, cs[j * CP + c] = centers[c, j]
  float* xs = cs + dp * CP;   // KA_K x KA_XS, xs[kk * KA_XS + row]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tr = t >> 3, tc = t & 7;

  for (int e = t; e < dp * CP; e += KA_THREADS) {
    const int j = e / CP, c = e % CP;
    cs[e] = (c < C && j < D) ? centers[(size_t)c * D + j] : 0.f;
  }
  __syncthreads();

  const int ntiles = (N + KA_ROWS - 1) / KA_ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * KA_ROWS;
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    for (int kc = 0; kc < D; kc += KA_K) {
      const int dd = kc + lane;
#pragma unroll
      for (int r = 0; r < KA_ROWS / 8; ++r) {
        const int rr = warp + 8 * r, n = r0 + rr;
        xs[lane * KA_XS + rr] = (n < N && dd < D) ? x[(size_t)n * D + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KA_K; ++kk) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[kk * KA_XS + tr * 4]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float* crow = cs + (kc + kk) * CP + tc * CPT;
        float cv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) cv[j] = crow[j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xa[i], cv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bv = -CUDART_INF_F;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tc * CPT + j;
        if (c < C && (bi == 0x7fffffff || acc[i][j] > bv)) {
          bv = acc[i][j];
          bi = c;
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const int n = r0 + tr * 4 + i;
      if (tc == 0 && n < N && (!RUNNING || bv > maxsim[n])) {
        tags[n] = c0 + bi;
        maxsim[n] = bv;
      }
    }
  }
}

template <int CPT, bool RUNNING>
static cudaError_t launch_kmeans(const float* x, const float* centers, int N, int D,
                                 int C, int c0, int* tags, float* maxsim,
                                 cudaStream_t stream) {
  auto kernel = kmeans_assign_kernel<CPT, RUNNING>;
  const size_t smem = kmeans_smem(D, CPT);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, KA_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ntiles = (N + KA_ROWS - 1) / KA_ROWS;
  int grid = sms * per_sm;
  if (grid > ntiles) grid = ntiles;
  if (grid < 1) grid = 1;
  kernel<<<grid, KA_THREADS, smem, stream>>>(x, centers, N, D, C, c0, tags, maxsim);
  return cudaGetLastError();
}

template <bool RUNNING>
static cudaError_t launch_chunk(const float* x, const float* centers, int N, int D,
                                int C, int c0, int* tags, float* maxsim,
                                cudaStream_t st) {
  switch ((C + 7) / 8) {
    case 1: return launch_kmeans<1, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 2: return launch_kmeans<2, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 3: return launch_kmeans<3, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 4: return launch_kmeans<4, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 5: return launch_kmeans<5, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 6: return launch_kmeans<6, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 7: return launch_kmeans<7, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    case 8: return launch_kmeans<8, RUNNING>(x, centers, N, D, C, c0, tags, maxsim, st);
    default: return cudaErrorInvalidValue;
  }
}

// The most centers a chunk takes at dimension D: 8 * CPT for the largest
// CPT <= 8 whose shared memory fits a block; 0 if not even 8 fit.
extern "C" int kmeans_assign_chunk_centers(int D) {
  for (int cpt = 8; cpt >= 1; --cpt)
    if (kmeans_smem(D, cpt) <= 232448) return 8 * cpt;
  return 0;
}

// Any C >= 1: the centers in ceil(C / chunk) chunks of equal size.
extern "C" int kmeans_assign_f32(const float* x, const float* centers, int N, int D,
                                 int C, int* tags, float* maxsim, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int most = kmeans_assign_chunk_centers(D);
  if (most == 0 || C < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (C + most - 1) / most;
  const int per = (C + chunks - 1) / chunks;
  for (int c0 = 0; c0 < C; c0 += per) {
    const int cc = C - c0 < per ? C - c0 : per;
    const float* chunk = centers + (size_t)c0 * D;
    const cudaError_t err =
        c0 == 0 ? launch_chunk<false>(x, chunk, N, D, cc, c0, tags, maxsim, st)
                : launch_chunk<true>(x, chunk, N, D, cc, c0, tags, maxsim, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

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
// (writes 16 MB); at the paper's largest C = 100 the flops take 3.06 ms.
// fp32 FMA throughput is the bound, with memory close behind at small C.
//
// What the design does about it: persistent blocks, one an SM, walk tiles
// of TR rows; for each tile they walk the centers in tiles of TC, and for
// each center tile the depth in chunks of KA_BK. Every chunk -- the tile's
// rows and the center tile's same depths -- reaches shared memory through a
// ring of KA_STAGES slots filled by cp.async (async_copy.cuh), so copies
// overlap the FMAs with one barrier a chunk, and the ring flows across
// tiles. The centers (at most a few hundred KB) stay in L2; shared memory
// does not grow with D or C, so any D runs. C up to one center tile (up to
// 64, or 65 to 128 split evenly: the paper's C = 100 is one tile of 104)
// costs one launch and one pass over x; a larger C re-reads each row tile
// once per further center tile (from L2 while the SMs' tiles, TR x D x 4
// bytes each, fit its 50 MB), still one launch.
// A thread keeps an RPT-row x CPT-center register tile (rows tr + 32 i,
// centers tc + 8 j; RPT = 16 up to 64 centers, else 8; up to 255
// registers) and reads 4 depths of a row or a center with one 16-byte
// load: RPT + CPT loads for 4 RPT CPT FMAs (C = 48: 22 loads for 384 FMAs;
// C = 100: 21 for 416). The rows a quarter-warp reads are one address (a
// broadcast), its centers 8 consecutive staged rows on distinct banks.
//
// The argmax scans a thread's centers in ascending order with strict `>`,
// combines the 8 threads of a row by (larger value, else smaller index),
// then keeps a later center tile's best only where it is strictly greater:
// the first maximum wins. Each score is one fp32 FMA chain over depth 0, 1,
// ..., D - 1 (zero-filled beyond D), bit-identical to a scan that holds the
// centers resident. No TF32.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "error.cuh"

constexpr int KA_THREADS = 256;    // 8 center lanes x 32 row lanes
constexpr int KA_BK = 16;          // depths per chunk
constexpr int KA_STR = KA_BK + 4;  // floats per staged row: 80 B
constexpr int KA_STAGES = 3;       // chunks in the ring

template <int RPT, int CPT>
__host__ __device__ constexpr int ka_stage_floats() {
  return (32 * RPT + 8 * CPT) * KA_STR;
}

template <int RPT, int CPT>
static size_t kmeans_smem() {
  return ((size_t)KA_STAGES * ka_stage_floats<RPT, CPT>() + 2 * 32 * RPT) * 4;
}

// Stage depths [kc, kc + KA_BK) of rows [r0, r0 + TR) and centers
// [c0, c0 + TC) into one ring slot; vec: 16-byte copies, else 4-byte.
template <int RPT, int CPT>
__device__ __forceinline__ void ka_load_chunk(const float* x, const float* centers, int N,
                                              int D, int C, bool vec, float* st, int r0,
                                              int c0, int kc) {
  constexpr int TR = 32 * RPT, TC = 8 * CPT, STR = KA_STR * 4;
  unsigned char* xs = reinterpret_cast<unsigned char*>(st);
  unsigned char* cs = xs + TR * STR;
  if (vec) {
    stage_chunk_rows<KA_THREADS, float, KA_BK, TR, 16>(xs, STR, x, r0, N, D, kc);
    stage_chunk_rows<KA_THREADS, float, KA_BK, TC, 16>(cs, STR, centers, c0, C, D, kc);
  } else {
    stage_chunk_rows<KA_THREADS, float, KA_BK, TR, 4>(xs, STR, x, r0, N, D, kc);
    stage_chunk_rows<KA_THREADS, float, KA_BK, TC, 4>(cs, STR, centers, c0, C, D, kc);
  }
}

template <int RPT, int CPT>
__global__ void __launch_bounds__(KA_THREADS, 1)
    kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ centers,
                         int N, int D, int C, int vec, int* __restrict__ tags,
                         float* __restrict__ maxsim) {
  constexpr int TR = 32 * RPT, TC = 8 * CPT, STAGE = ka_stage_floats<RPT, CPT>();
  extern __shared__ __align__(16) float ksm[];
  float* run_v = ksm + KA_STAGES * STAGE;  // TR: best over the earlier center tiles
  int* run_i = reinterpret_cast<int*>(run_v + TR);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tc = lane & 7, tr = warp * 4 + (lane >> 3);
  const int nk = (D + KA_BK - 1) / KA_BK;
  const int U = (C + TC - 1) / TC;
  const int ntiles = (N + TR - 1) / TR;
  const int mine = (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = (long long)mine * U * nk;

  // producer position: the block's lt-th row tile, center tile lu, chunk lk
  int lt = 0, lu = 0, lk = 0;
  auto load_next = [&](float* st) {
    ka_load_chunk<RPT, CPT>(x, centers, N, D, C, vec, st,
                            (blockIdx.x + lt * gridDim.x) * TR, lu * TC, lk * KA_BK);
    if (++lk == nk) {
      lk = 0;
      if (++lu == U) {
        lu = 0;
        ++lt;
      }
    }
  };
  for (int g = 0; g < KA_STAGES - 1; ++g) {
    if (g < total) load_next(ksm + g * STAGE);
    cp_async_commit();
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int ct = 0, cu = 0, ck = 0, slot = 0;  // consumer position and ring slot
  for (long long g = 0; g < total; ++g) {
    cp_async_wait<KA_STAGES - 2>();
    __syncthreads();  // chunk g visible; every warp is done with chunk g - 1
    if (g + KA_STAGES - 1 < total)
      load_next(ksm + (slot == 0 ? KA_STAGES - 1 : slot - 1) * STAGE);
    cp_async_commit();

    const float* xs = ksm + slot * STAGE + tr * KA_STR;
    const float* cs = ksm + slot * STAGE + (TR + tc) * KA_STR;
#pragma unroll
    for (int s4 = 0; s4 < KA_BK; s4 += 4) {
      float4 xv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + 32 * i * KA_STR + s4);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + 8 * j * KA_STR + s4);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][j] = fmaf(xv[i].x, cv.x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, cv.y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, cv.z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, cv.w, acc[i][j]);
        }
      }
    }
    slot = slot + 1 == KA_STAGES ? 0 : slot + 1;
    if (++ck < nk) continue;

    // the center tile is done: each row's best of it, then of all so far
    const int r0 = (blockIdx.x + ct * gridDim.x) * TR;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float bv = -CUDART_INF_F;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cu * TC + tc + 8 * j;
        if (c < C && (bi == 0x7fffffff || acc[i][j] > bv)) {
          bv = acc[i][j];
          bi = c;
        }
        acc[i][j] = 0.f;
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
      const int row = tr + 32 * i;
      if (tc == 0) {
        if (cu > 0 && !(bv > run_v[row])) {
          bv = run_v[row];
          bi = run_i[row];
        }
        if (cu + 1 < U) {
          run_v[row] = bv;
          run_i[row] = bi;
        } else if (r0 + row < N) {
          tags[r0 + row] = bi;
          maxsim[r0 + row] = bv;
        }
      }
    }
    ck = 0;
    if (++cu == U) {
      cu = 0;
      ++ct;
    }
  }
  cp_async_wait<0>();
}

template <int RPT, int CPT>
static cudaError_t launch_kmeans(const float* x, const float* centers, int N, int D, int C,
                                 int* tags, float* maxsim, cudaStream_t stream) {
  auto kernel = kmeans_assign_kernel<RPT, CPT>;
  const size_t smem = kmeans_smem<RPT, CPT>();
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, KA_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ntiles = (N + 32 * RPT - 1) / (32 * RPT);
  int grid = sms * per_sm;
  if (grid > ntiles) grid = ntiles;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(centers) % 16 == 0;
  kernel<<<grid, KA_THREADS, smem, stream>>>(x, centers, N, D, C, vec, tags, maxsim);
  return cudaGetLastError();
}

// The center tile of a C: up to 64 centers, 16 rows x ceil(C / 8) centers
// a thread; above, 8 rows x 9 to 16 centers (tiles of <= 128, split evenly:
// 65 or more each).
static int kmeans_assign_center_tile(int C) {
  if (C <= 64) return 8 * ((C + 7) / 8);
  const int tiles = (C + 127) / 128, per = (C + tiles - 1) / tiles;
  return 8 * ((per + 7) / 8);
}

// Any C >= 1, any D >= 1, N >= 1: one launch.
extern "C" int kmeans_assign_f32(const float* x, const float* centers, int N, int D, int C,
                                 int* tags, float* maxsim, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  switch (kmeans_assign_center_tile(C) / 8) {
    case 1: return (int)launch_kmeans<16, 1>(x, centers, N, D, C, tags, maxsim, st);
    case 2: return (int)launch_kmeans<16, 2>(x, centers, N, D, C, tags, maxsim, st);
    case 3: return (int)launch_kmeans<16, 3>(x, centers, N, D, C, tags, maxsim, st);
    case 4: return (int)launch_kmeans<16, 4>(x, centers, N, D, C, tags, maxsim, st);
    case 5: return (int)launch_kmeans<16, 5>(x, centers, N, D, C, tags, maxsim, st);
    case 6: return (int)launch_kmeans<16, 6>(x, centers, N, D, C, tags, maxsim, st);
    case 7: return (int)launch_kmeans<16, 7>(x, centers, N, D, C, tags, maxsim, st);
    case 8: return (int)launch_kmeans<16, 8>(x, centers, N, D, C, tags, maxsim, st);
    case 9: return (int)launch_kmeans<8, 9>(x, centers, N, D, C, tags, maxsim, st);
    case 10: return (int)launch_kmeans<8, 10>(x, centers, N, D, C, tags, maxsim, st);
    case 11: return (int)launch_kmeans<8, 11>(x, centers, N, D, C, tags, maxsim, st);
    case 12: return (int)launch_kmeans<8, 12>(x, centers, N, D, C, tags, maxsim, st);
    case 13: return (int)launch_kmeans<8, 13>(x, centers, N, D, C, tags, maxsim, st);
    case 14: return (int)launch_kmeans<8, 14>(x, centers, N, D, C, tags, maxsim, st);
    case 15: return (int)launch_kmeans<8, 15>(x, centers, N, D, C, tags, maxsim, st);
    case 16: return (int)launch_kmeans<8, 16>(x, centers, N, D, C, tags, maxsim, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

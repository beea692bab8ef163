// flash_attention: causal / sliding-window attention forward with GQA on
// Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (pallas_call body
// `_flash_kernel`): for q (B, H, S, dh) and k, v (B, KV, S, dh), H % KV == 0,
// o[b, h, i] = sum_j softmax_j(<q_i, k_j> / sqrt(dh)) v_j over the keys j of
// kv head h / (H / KV) with j <= i (causal) and i - j < window (sliding
// window); online softmax in f32, a row with no valid key gives 0, the
// output in q's type.
//
// What bounds it on an H100 SXM: at the LM path's prefill (B = 4, H = 32,
// KV = 8, S = 8192, dh = 120, window 4096) the unmasked (query, key) pairs
// are 25.2M per (b, h), 4 dh flops each: 1.55 TFLOP, 1.56 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 0.63 GB of q, k, v and o (0.19 ms
// at 3.35 TB/s). Operations bound it, by a wide margin.
//
// Three kernels; the wrapper picks one per call (`_variant`) and the entry
// point refuses a variant whose requirements fail:
//
// * flash_wgmma_kernel -- bf16, dh % 8 == 0, 64 < dh <= 128, 16-byte
//   aligned bases and 16-byte multiple strides (the transformer's strided
//   (B, S, H, dh) views). The first design (flash_bf16_kernel, below) reached
//   16 % of the bound at the LM shape, for four reasons: (1) each of its 4
//   warps owns 16 query rows and ldmatrix-reads the whole K and V tile, 16
//   flops a shared-memory byte, which caps the tensor cores near half their
//   rate; (2) the softmax (ex2 on the 16-a-clock MUFU, max, sum, rescale)
//   runs in series with the products in the same warp; (3) mma.sync cannot
//   reach Hopper's tensor-core rate, only wgmma can; (4) every thread issues
//   cp.async copies, with two __syncthreads per 64-key tile. This kernel:
//   one block of 3 warpgroups takes 128 queries of one (b, h). Warpgroup 0
//   is the producer: one thread issues TMA loads (Q once, then 128-key K and
//   V tiles into a 2-stage ring with full and empty mbarriers), so copies
//   cost no instructions or registers in the consumers (4). Warpgroups 1
//   and 2 each own 64 query rows and run S = Q K^T as wgmma m64n128k16 from
//   shared memory and O += P V with P from registers (the S accumulator,
//   packed to bf16, is the A fragment) and V read MN-major through the
//   transpose bit (3); a warpgroup's 64 rows share each read of K and V, 64
//   flops a byte (1). TMA writes the 128-byte swizzle that the wgmma
//   descriptors read, in two 64-column panels; dh pads to 128 by TMA's
//   zero fill and ragged S by the same fill plus masking by key position,
//   so no input is copied. The two consumers ping-pong through named
//   barriers 1 and 2 (one's softmax overlaps the other's wgmma), and within
//   a warpgroup the next tile's S = Q K^T is issued with this tile's P V and
//   waited on first, so the softmax runs while P V is on the tensor cores
//   (2). Masks are evaluated only on tiles that cross the diagonal, the
//   window's edge or S; fully masked tiles are never loaded. The heads of
//   one GQA group for one query tile are adjacent in the launch order (a
//   K / V tile comes from HBM once, then from L2), and query tiles go
//   heaviest first. Where the group is even, two such heads form a cluster
//   of two blocks that share every K / V tile: each block's producer loads
//   one 64-column panel into both blocks (TMA multicast), so a tile costs
//   L2 half the bytes -- the fills from L2, 64 KB a tile a block, are what
//   held the one-block version once the softmax overlapped. The TMA maps
//   are encoded per call on the host, dims in the order of their strides,
//   through the runtime's driver entry point.
// * flash_bf16_kernel -- the other bf16 shapes: `mma.sync.m16n8k16` (bf16
//   in, f32 accumulate), FlashAttention-2 style. One block of 4 warps takes
//   64 queries of one (b, h); each warp owns 16 query rows, keeps its Q
//   fragments in registers, and walks the KV tiles of 64 keys that the
//   masks reach. S = Q K^T stays in registers; the online softmax runs on
//   the accumulator fragments (row max and sum across the 4 threads of a
//   row by shuffles); P is rounded to bf16 and reused in place as the A
//   operand of O += P V. K and V tiles are double-buffered by cp.async,
//   row-major with a padded stride, every fragment from one ldmatrix.x4
//   (V's by ldmatrix.trans). dh is padded with zeros to DP in {32, 64, 128};
//   ragged S is masked by key position; rows that are not 16-byte aligned
//   are staged by plain loads.
// * flash_f32_kernel -- f32: the same tiling logic on fp32 FMA (32 x 32
//   tiles, no TF32).
//
// All three take strides, so the transformer passes transposed (B, S, H,
// dh) views without a copy, and causal=False works too.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its encode's types (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include "error.cuh"

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, KV, S, dh, causal, window;  // window <= 0: no window
  int vec;                           // 16-byte loads of q, k, v rows
  float scale_log2;                  // log2(e) / sqrt(dh)
};

// KV tiles [t0, t1) that the masks reach for queries [q0, q0 + bq).
template <typename Args>
__device__ __forceinline__ void kv_tiles(const Args& a, int q0, int bq, int bk,
                                         int& t0, int& t1) {
  int lo = 0;
  if (a.window > 0) lo = max(0, q0 - a.window + 1);
  const int hi = a.causal ? min(a.S, q0 + bq) : a.S;
  t0 = lo / bk;
  t1 = (hi + bk - 1) / bk;
}

template <typename Args>
__device__ __forceinline__ bool key_valid(const Args& a, int qp, int kp) {
  return kp < a.S && (!a.causal || kp <= qp) && (a.window <= 0 || qp - kp < a.window);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int FB_Q = 64;
constexpr int FB_K = 64;
constexpr int FB_THREADS = 128;

template <int DP>
struct BfLayout {
  static constexpr int ST = DP + 8;  // row stride (elements) of every tile:
                                     // 8 rows of 16 bytes hit 32 banks
  static constexpr int TILE = 64 * ST;
  // K0, V0, K1, V1 (double-buffered); Q is staged in K1 and lives in
  // registers before K1 is first filled, so three blocks fit an SM
  static constexpr size_t BYTES = (size_t)4 * TILE * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [0, 64) of a tile into shared memory, row-major with stride DP + 8,
// zero past `nvalid` rows and past dh. With 16-byte aligned rows (`vec`)
// each 16-byte chunk is one cp.async (zero-filled where out of range),
// which completes at the next wait; otherwise plain loads and stores.
template <int DP>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* base,
                                           long long row_stride, int nvalid, int dh,
                                           bool vec) {
  constexpr int CH = DP / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += FB_THREADS) {
    const int r = c / CH, d0 = (c % CH) * 8;
    uint16_t* d = dst + r * BfLayout<DP>::ST + d0;
    const bool in = r < nvalid && d0 < dh;
    const uint16_t* src = in ? base + (long long)r * row_stride + d0 : base;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(d)),
                   "l"(src), "r"(in ? 16 : 0));
    } else {
      union {
        uint4 u;
        uint16_t s[8];
      } c8;
      c8.u = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
#pragma unroll
        for (int e = 0; e < 8; ++e) c8.s[e] = (d0 + e < dh) ? src[e] : (uint16_t)0;
      }
      *reinterpret_cast<uint4*>(d) = c8.u;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (relative error ~2^-22, far below the
// bf16 rounding of P); exp2(-inf) = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
__global__ void __launch_bounds__(FB_THREADS, 3) flash_bf16_kernel(AttnArgs a) {
  using L = BfLayout<DP>;
  extern __shared__ __align__(16) uint16_t bf_smem[];
  uint16_t* kv = bf_smem;  // K0, V0, K1, V1
  uint16_t* qs = kv + 2 * L::TILE;
  const int q0 = blockIdx.x * FB_Q, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const uint16_t* qg = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kg = static_cast<const uint16_t*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const uint16_t* vg = static_cast<const uint16_t*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  uint16_t* og = static_cast<uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix
  const bool vec = a.vec != 0;

  int t0, t1;
  kv_tiles(a, q0, FB_Q, FB_K, t0, t1);
  stage_rows<DP>(qs, qg + q0 * a.q_ss, a.q_ss, a.S - q0, a.dh, vec);
  cp_async_commit();
  {
    const int k0 = t0 * FB_K;
    stage_rows<DP>(kv, kg + k0 * a.k_ss, a.k_ss, a.S - k0, a.dh, vec);
    stage_rows<DP>(kv + L::TILE, vg + k0 * a.v_ss, a.v_ss, a.S - k0, a.dh, vec);
    cp_async_commit();
  }
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + lr + (lm & 1) * 8) * L::ST + 16 * kk + (lm >> 1) * 8);
  __syncthreads();  // Q's space is K1's from here on

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  const int qa = q0 + warp * 16 + g, qb = qa + 8;  // this thread's two rows

  for (int kt = t0; kt < t1; ++kt) {
    const int buf = (kt - t0) & 1, k0 = kt * FB_K;
    if (kt + 1 < t1) {  // the next tile streams in while this one computes
      const int k1 = k0 + FB_K;
      uint16_t* nb = kv + 2 * (buf ^ 1) * L::TILE;
      stage_rows<DP>(nb, kg + k1 * a.k_ss, a.k_ss, a.S - k1, a.dh, vec);
      stage_rows<DP>(nb + L::TILE, vg + k1 * a.v_ss, a.v_ss, a.S - k1, a.dh, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = kv + 2 * buf * L::TILE;
    const uint16_t* vs = ks + L::TILE;

    float s[FB_K / 8][4];
#pragma unroll
    for (int j = 0; j < FB_K / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < FB_K / 16; ++jj) {
        uint32_t kb[4];  // b0, b1 of key tiles 2jj and 2jj + 1
        ldsm_x4(kb, ks + (16 * jj + lr + (lm >> 1) * 8) * L::ST + 16 * kk + (lm & 1) * 8);
        mma_bf16(s[2 * jj], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // masks only on tiles that cross the diagonal, the window's edge or S
    const bool full = k0 + FB_K <= a.S && (!a.causal || k0 + FB_K - 1 <= q0) &&
                      (a.window <= 0 || q0 + FB_Q - 1 - k0 < a.window);
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < FB_K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * t + e;
        s[j][e] = (full || key_valid(a, qa, kp)) ? s[j][e] * a.scale_log2 : -CUDART_INF_F;
        s[j][2 + e] =
            (full || key_valid(a, qb, kp)) ? s[j][2 + e] * a.scale_log2 : -CUDART_INF_F;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with no valid key yet keeps m = -inf: subtract 0 instead, so
    // every weight is exp2(-inf) = 0 and never exp2(-inf + inf)
    const float sa = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float sb = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    const float al_a = fast_exp2(m_a - sa), al_b = fast_exp2(m_b - sb);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < FB_K / 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - sa);
      s[j][1] = fast_exp2(s[j][1] - sa);
      s[j][2] = fast_exp2(s[j][2] - sb);
      s[j][3] = fast_exp2(s[j][3] - sb);
      ps_a += s[j][0] + s[j][1];
      ps_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + ps_a;  // this thread's part of the row sum
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }
#pragma unroll
    for (int kk = 0; kk < FB_K / 16; ++kk) {
      // P's accumulator fragments of key tiles 2kk, 2kk + 1 are the A
      // fragment of keys 16kk..16kk + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t vb[4];  // b0, b1 of dim tiles 2nn and 2nn + 1
        ldsm_x4_trans(vb, vs + (16 * kk + lr + (lm & 1) * 8) * L::ST + 16 * nn + (lm >> 1) * 8);
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float div_a = l_a == 0.f ? 1.f : l_a, div_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * n + 2 * t + e;
      if (d >= a.dh) continue;
      if (qa < a.S)
        og[qa * a.o_ss + d] = __bfloat16_as_ushort(__float2bfloat16_rn(o[n][e] / div_a));
      if (qb < a.S)
        og[qb * a.o_ss + d] = __bfloat16_as_ushort(__float2bfloat16_rn(o[n][2 + e] / div_b));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: fp32 FMA on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int FF_Q = 32;       // 4 warps x 8 query rows
constexpr int FF_K = 32;       // one key per lane
constexpr int FF_THREADS = 128;

template <int DP>
struct F32Layout {
  static constexpr int QST = DP + 4;  // float4 rows; a quarter-warp's
                                      // float4 loads of 8 rows hit 32 banks
  static constexpr int PST = FF_K + 1;
  static constexpr int Q_ELEMS = FF_Q * QST;
  static constexpr int K_ELEMS = FF_K * QST;
  static constexpr int V_ELEMS = FF_K * DP;
  static constexpr int P_ELEMS = FF_Q * PST;
  static constexpr size_t BYTES = (size_t)(Q_ELEMS + K_ELEMS + V_ELEMS + P_ELEMS) * 4;
};

// Rows [0, 32) of an f32 tile with row stride `st`, zero past S and dh.
template <int DP>
__device__ __forceinline__ void stage_rows_f32(float* dst, int st, const float* base,
                                               long long row_stride, int nvalid, int dh,
                                               bool vec) {
  constexpr int CH = DP / 4;
  for (int c = threadIdx.x; c < 32 * CH; c += FF_THREADS) {
    const int r = c / CH, d0 = (c % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid && d0 < dh) {
      const float* src = base + (long long)r * row_stride + d0;
      if (vec) {
        val = *reinterpret_cast<const float4*>(src);
      } else {
        val.x = src[0];
        val.y = d0 + 1 < dh ? src[1] : 0.f;
        val.z = d0 + 2 < dh ? src[2] : 0.f;
        val.w = d0 + 3 < dh ? src[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * st + d0) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(FF_THREADS) flash_f32_kernel(AttnArgs a) {
  using L = F32Layout<DP>;
  constexpr int DJ = DP / 32;  // output dims per lane
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;
  float* ks = qs + L::Q_ELEMS;
  float* vs = ks + L::K_ELEMS;
  float* ps = vs + L::V_ELEMS;
  const int q0 = blockIdx.x * FF_Q, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = a.vec != 0;

  stage_rows_f32<DP>(qs, L::QST, qg + q0 * a.q_ss, a.q_ss, a.S - q0, a.dh, vec);
  float o[8][DJ], m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[r][j] = 0.f;
  }

  int t0, t1;
  kv_tiles(a, q0, FF_Q, FF_K, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * FF_K;
    __syncthreads();
    stage_rows_f32<DP>(ks, L::QST, kg + k0 * a.k_ss, a.k_ss, a.S - k0, a.dh, vec);
    stage_rows_f32<DP>(vs, DP, vg + k0 * a.v_ss, a.v_ss, a.S - k0, a.dh, vec);
    __syncthreads();

    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + lane * L::QST + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (8 * warp + r) * L::QST + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qp = q0 + 8 * warp + r;
      const float sv = key_valid(a, qp, kp) ? s[r] * a.scale_log2 : -CUDART_INF_F;
      const float mn = fmaxf(m[r], warp_max(sv));
      const float safe = mn == -CUDART_INF_F ? 0.f : mn;
      const float al = exp2f(m[r] - safe);
      const float p = exp2f(sv - safe);
      l[r] = l[r] * al + warp_sum(p);
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[r][j] *= al;
      ps[(8 * warp + r) * L::PST + lane] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < FF_K; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * DP + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float pr = ps[(8 * warp + r) * L::PST + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[r][j] = fmaf(pr, vv[j], o[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qp = q0 + 8 * warp + r;
    if (qp >= a.S) continue;
    const float div = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < a.dh) og[qp * a.o_ss + d] = o[r][j] / div;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, 64 < dh <= 128: wgmma fed by TMA, one producer and two consumer
// warpgroups.
// ---------------------------------------------------------------------------

constexpr int FW_Q = 128;              // queries a block, 64 a consumer warpgroup
constexpr int FW_K = 128;              // keys a KV tile
constexpr int FW_STAGES = 2;           // K and V tiles in flight
constexpr int FW_THREADS = 384;        // producer + two consumer warpgroups
constexpr int FW_PANEL = 128 * 128;    // bytes: 128 rows of 64 bf16, one 128-byte swizzle span
constexpr int FW_TILE = 2 * FW_PANEL;  // 128 rows x dh 128 (two panels)
constexpr int FW_BAR = (1 + 2 * FW_STAGES) * FW_TILE;  // Q, K[], V[], then the mbarriers
constexpr size_t FW_BYTES = (size_t)FW_BAR + 128 + 1024;  // + slack to align to 1024
constexpr int FW_ENCODE_ERROR = 10000;  // + the CUresult of a failed map encode

struct WgArgs {
  void* o;
  long long o_sb, o_sh, o_ss;
  int B, H, KV, S, dh, causal, window;
  int n_qt;                    // query tiles of FW_Q
  int q_axes, k_axes, v_axes;  // the map dim (1..3) of S, head, batch: 2 bits each
  float scale_log2;            // log2(e) / sqrt(dh)
  unsigned long long* clocks;  // the profile's FP_N sums (PROF only)
};

// Profile (PROF): thread 0 of each consumer warpgroup sums its clock64
// cycles by part over the blocks: the whole consumer, waiting for Q / K / V
// to land, waiting its turn (the other consumer's issue), issuing, waiting
// for S, the softmax, waiting for P V, rescaling O and packing P, and the
// epilogue (normalise and store).
enum { FP_KERNEL, FP_DATA, FP_TURN, FP_ISSUE, FP_WAIT_S, FP_SOFTMAX, FP_WAIT_PV, FP_PACK,
       FP_STORE, FP_N };

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// Named barriers 1 and 2 (0 is __syncthreads') between the two consumers.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Panels [p0, p0 + np) (64 columns of dh each) of 128 rows of S from `s0`
// of one head of one batch; `axes` says which map dimension each of S,
// head and batch is. MULTICAST: into both blocks of the cluster, at the
// same offsets, each block's barrier told of its bytes.
template <bool MULTICAST>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int axes, int s0, int head, int b, int p0, int np) {
  const int ps = axes & 3, ph = (axes >> 2) & 3;
  const int c1 = ps == 1 ? s0 : (ph == 1 ? head : b);
  const int c2 = ps == 2 ? s0 : (ph == 2 ? head : b);
  const int c3 = ps == 3 ? s0 : (ph == 3 ? head : b);
  for (int p = p0; p < p0 + np; ++p) {
    if (MULTICAST)
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(
              dst + p * FW_PANEL),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * p), "r"(c1), "r"(c2), "r"(c3),
          "r"(bar), "h"((uint16_t)3)
          : "memory");
    else
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst + p * FW_PANEL),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * p), "r"(c1), "r"(c2), "r"(c3),
          "r"(bar)
          : "memory");
  }
}

// An arrival on the barrier at the same offset in block `rank` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes): LBO and SBO in bytes.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the issue or the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FW_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FW_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FW_ACC64(d)                                                                     \
  FW_ACC8(d, 0), FW_ACC8(d, 8), FW_ACC8(d, 16), FW_ACC8(d, 24), FW_ACC8(d, 32),        \
      FW_ACC8(d, 40), FW_ACC8(d, 48), FW_ACC8(d, 56)

// d (64 x 128, f32) = (acc ? d : 0) + A B: A 64 x 16 and B 16 x 128 from
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FW_ACC64(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B: A 64 x 16 from registers (the m64k16 A fragment), B 16 x 128
// from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FW_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S = Q K^T over dh 128 (8 steps of 16): Q's 64 rows of this warpgroup, K's
// 128 keys; a step moves 32 bytes along the swizzled row, a panel on.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t q_desc, uint32_t k_tile) {
  const uint64_t k_desc = wg_desc(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t off = (uint64_t)(((kk >> 2) * FW_PANEL + (kk & 3) * 32) >> 4);
    wgmma_ss(s, q_desc + off, k_desc + off, kk > 0);
  }
}

// O += P V over the tile's 128 keys (8 steps of 16 rows of V, 2048 bytes
// each); V is MN-major: LBO the panel (dh 64 on), SBO 8 keys.
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  const uint64_t v_desc = wg_desc(v_tile, FW_PANEL, 1024);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wgmma_rs(o, p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3],
             v_desc + (uint64_t)((j * 2048) >> 4));
}

// The online softmax of one 64 x 128 tile of S in place: S becomes the
// weights exp2(S scale - m) (f32); m, l updated; alpha the rescale of O.
// This thread holds rows qa and qb = qa + 8, keys k0 + 8 j + 2 t + {0, 1}.
__device__ __forceinline__ void fw_softmax(float (&s)[64], const WgArgs& a, bool full, int qa,
                                           int qb, int k0, int t, float& m_a, float& m_b,
                                           float& l_a, float& l_b, float& al_a, float& al_b) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * t + e;
        if (!key_valid(a, qa, kp)) s[4 * j + e] = -CUDART_INF_F;
        if (!key_valid(a, qb, kp)) s[4 * j + 2 + e] = -CUDART_INF_F;
      }
    }
  }
  float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float sc = a.scale_log2;
  const float mn_a = fmaxf(m_a, quad_max(mx_a) * sc);
  const float mn_b = fmaxf(m_b, quad_max(mx_b) * sc);
  // a row with no valid key yet keeps m = -inf: subtract 0 instead
  const float sa = mn_a == -CUDART_INF_F ? 0.f : mn_a;
  const float sb = mn_b == -CUDART_INF_F ? 0.f : mn_b;
  al_a = fast_exp2(m_a - sa);
  al_b = fast_exp2(m_b - sb);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = fast_exp2(fmaf(s[4 * j], sc, -sa));
    s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sc, -sa));
    s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sc, -sb));
    s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sc, -sb));
    ps_a += s[4 * j] + s[4 * j + 1];
    ps_b += s[4 * j + 2] + s[4 * j + 3];
  }
  l_a = l_a * al_a + ps_a;  // this thread's part of the row sum
  l_b = l_b * al_b + ps_b;
}

// P (bf16) as the A fragments of the 8 key steps: the accumulator of keys
// 16 kk .. 16 kk + 15 is the A fragment of step kk.
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ void rescale_o(float (&o)[64], float al_a, float al_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
}

// CL: blocks a cluster, 1 or 2. With 2 the cluster's blocks are two heads
// of one GQA group at one query tile, so they read the same K / V tiles:
// each producer loads one panel of every tile into both blocks (multicast),
// halving what the tiles cost L2; every consumer warp releases a stage in
// both blocks.
template <bool PROF, int CL>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const WgArgs a) {
  extern __shared__ uint8_t fw_smem[];
  const uint32_t base = (smem_addr(fw_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, bars = base + FW_BAR;
  // mbarriers: Q, then per stage full K, full V, empty K, empty V
#define FW_FULL_K(st) (bars + 8u * (1 + (st)))
#define FW_FULL_V(st) (bars + 8u * (1 + FW_STAGES + (st)))
#define FW_EMPTY_K(st) (bars + 8u * (1 + 2 * FW_STAGES + (st)))
#define FW_EMPTY_V(st) (bars + 8u * (1 + 3 * FW_STAGES + (st)))
#define FW_K_TILE(st) (base + FW_TILE * (1 + (st)))
#define FW_V_TILE(st) (base + FW_TILE * (1 + FW_STAGES + (st)))

  // launch order: the heads of a GQA group, then kv heads, then batches,
  // then query tiles heaviest first (causal: the last tile first)
  const int group = a.H / a.KV;
  int w = blockIdx.x;
  const int hg = w % group;
  w /= group;
  const int kvh = w % a.KV;
  w /= a.KV;
  const int b = w % a.B;
  w /= a.B;
  const int qt = a.causal ? a.n_qt - 1 - w : w;
  const int h = kvh * group + hg, q0 = qt * FW_Q;
  int t0, t1;
  kv_tiles(a, q0, FW_Q, FW_K, t0, t1);
  const int n = t1 - t0;  // >= 1: the row q0 keeps its own key
  const int wg = threadIdx.x >> 7;

  uint32_t rank = 0;  // this block's rank in its cluster
  if (CL > 1) asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int st = 0; st < FW_STAGES; ++st) {
      mbar_init(FW_FULL_K(st), 1);
      mbar_init(FW_FULL_V(st), 1);
      mbar_init(FW_EMPTY_K(st), 8 * CL);  // one lane of each consumer warp
      mbar_init(FW_EMPTY_V(st), 8 * CL);  // of the cluster's blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cluster's barriers exist before any block signals another's
  if (CL > 1)
    cluster_sync();
  else
    __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, FW_TILE);
      tma_tile<false>(q_s, &tm_q, bars, a.q_axes, q0, h, b, 0, 2);
      // K and V: both panels, or (CL = 2) panel `rank` into both blocks
      const int p0 = CL > 1 ? (int)rank : 0, np = CL > 1 ? 1 : 2;
      for (int i = 0; i < n; ++i) {
        const int st = i % FW_STAGES;
        const uint32_t ph = (i / FW_STAGES) & 1;
        const int k0 = (t0 + i) * FW_K;
        mbar_wait(FW_EMPTY_K(st), ph ^ 1);
        mbar_expect_tx(FW_FULL_K(st), FW_TILE);
        tma_tile<(CL > 1)>(FW_K_TILE(st), &tm_k, FW_FULL_K(st), a.k_axes, k0, kvh, b, p0, np);
        mbar_wait(FW_EMPTY_V(st), ph ^ 1);
        mbar_expect_tx(FW_FULL_V(st), FW_TILE);
        tma_tile<(CL > 1)>(FW_V_TILE(st), &tm_v, FW_FULL_V(st), a.v_axes, k0, kvh, b, p0, np);
      }
      // the tail: the block stays until every consumer of the cluster has
      // released its last tiles here (no arrival reaches a block that left)
      for (int i = n > FW_STAGES ? n - FW_STAGES : 0; i < n; ++i) {
        const uint32_t ph = (i / FW_STAGES) & 1;
        mbar_wait(FW_EMPTY_K(i % FW_STAGES), ph);
        mbar_wait(FW_EMPTY_V(i % FW_STAGES), ph);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // consumer 0 or 1: query rows q0 + 64 cw ..
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * cw;
    const int qa = r0 + 16 * warp + g, qb = qa + 8;
    const uint64_t q_desc = wg_desc(q_s + 64 * 128 * cw, 16, 1024);
    // a stage released in this block and, with CL = 2, in the other
    auto release = [rank](uint32_t bar) {
      mbar_arrive(bar);
      if (CL > 1) mbar_arrive_cluster(bar, rank ^ 1u);
    };
    float s[64], o[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f, al_a, al_b;
    long long clk[FP_N] = {}, t_prof = PROF ? clock64() : 0;
    const long long t_start = t_prof;
#define FW_MARK(part)                    \
  if (PROF) {                            \
    const long long now_ = clock64();    \
    clk[part] += now_ - t_prof;          \
    t_prof = now_;                       \
  }
    // the tile needs no mask for this warpgroup's 64 rows
#define FW_FULL(k0)                                                     \
  ((k0) + FW_K <= a.S && (!a.causal || (k0) + FW_K - 1 <= r0) && \
   (a.window <= 0 || r0 + 63 - (k0) < a.window))

    // rounds of issue: S of tile 0; S of tile i with P V of tile i - 1;
    // P V of the last tile. The consumers take turns (named barrier 1 + cw
    // is this one's turn), consumer 0 first.
    if (cw == 1) named_arrive(1);
    mbar_wait(bars, 0);
    mbar_wait(FW_FULL_K(0), 0);
    FW_MARK(FP_DATA);
    named_sync(1 + cw);
    FW_MARK(FP_TURN);
    reg_fence(s);
    wg_fence();
    issue_qk(s, q_desc, FW_K_TILE(0));
    wg_commit();
    named_arrive(2 - cw);
    FW_MARK(FP_ISSUE);
    wg_wait<0>();
    reg_fence(s);
    if (lane == 0) release(FW_EMPTY_K(0));
    FW_MARK(FP_WAIT_S);
    fw_softmax(s, a, FW_FULL(t0 * FW_K), qa, qb, t0 * FW_K, t, m_a, m_b, l_a, l_b, al_a, al_b);
    FW_MARK(FP_SOFTMAX);
    pack_p(p, s);
    FW_MARK(FP_PACK);

    for (int i = 1; i < n; ++i) {
      const int st = i % FW_STAGES, sv = (i - 1) % FW_STAGES;
      const int k0 = (t0 + i) * FW_K;
      mbar_wait(FW_FULL_K(st), (i / FW_STAGES) & 1);
      mbar_wait(FW_FULL_V(sv), ((i - 1) / FW_STAGES) & 1);
      FW_MARK(FP_DATA);
      named_sync(1 + cw);
      FW_MARK(FP_TURN);
      reg_fence(s);
      reg_fence(o);
      reg_fence(p);
      wg_fence();
      issue_qk(s, q_desc, FW_K_TILE(st));
      wg_commit();
      issue_pv(o, p, FW_V_TILE(sv));
      wg_commit();
      named_arrive(2 - cw);
      FW_MARK(FP_ISSUE);
      wg_wait<1>();  // S is in; P V may still run
      reg_fence(s);
      if (lane == 0) release(FW_EMPTY_K(st));
      FW_MARK(FP_WAIT_S);
      fw_softmax(s, a, FW_FULL(k0), qa, qb, k0, t, m_a, m_b, l_a, l_b, al_a, al_b);
      FW_MARK(FP_SOFTMAX);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(p);
      if (lane == 0) release(FW_EMPTY_V(sv));
      FW_MARK(FP_WAIT_PV);
      rescale_o(o, al_a, al_b);  // O's tiles so far were weighted by the old max
      pack_p(p, s);
      FW_MARK(FP_PACK);
    }

    {
      const int sv = (n - 1) % FW_STAGES;
      mbar_wait(FW_FULL_V(sv), ((n - 1) / FW_STAGES) & 1);
      FW_MARK(FP_DATA);
      named_sync(1 + cw);
      FW_MARK(FP_TURN);
      reg_fence(o);
      reg_fence(p);
      wg_fence();
      issue_pv(o, p, FW_V_TILE(sv));
      wg_commit();
      // consumer 1's last turn is this one: nothing waits on its arrival
      if (cw == 0) named_arrive(2);
      FW_MARK(FP_ISSUE);
      wg_wait<0>();
      reg_fence(o);
      if (lane == 0) release(FW_EMPTY_V(sv));
      FW_MARK(FP_WAIT_PV);
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a, inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
    uint16_t* og = static_cast<uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * t;  // dh % 8 == 0: d < dh holds for d + 1 too
      if (d >= a.dh) continue;
      if (qa < a.S)
        *reinterpret_cast<uint32_t*>(og + qa * a.o_ss + d) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (qb < a.S)
        *reinterpret_cast<uint32_t*>(og + qb * a.o_ss + d) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    FW_MARK(FP_STORE);
    if (PROF && tid == 0) {
      clk[FP_KERNEL] = t_prof - t_start;
#pragma unroll
      for (int i = 0; i < FP_N; ++i) atomicAdd(a.clocks + i, (unsigned long long)clk[i]);
    }
  }
#undef FW_MARK
#undef FW_FULL
#undef FW_FULL_K
#undef FW_FULL_V
#undef FW_EMPTY_K
#undef FW_EMPTY_V
#undef FW_K_TILE
#undef FW_V_TILE
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <typename Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, int threads, int q_tile, int B,
                          const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = open_dynamic_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + q_tile - 1) / q_tile, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// What a TMA map of a bf16 (B, heads, S, dh) view needs: a 16-byte aligned
// base and, on every axis longer than 1, a positive stride of a multiple of
// 8 elements (16 bytes).
static bool tma_view(const void* p, long long nb, long long nh, long long ns, long long sb,
                     long long sh, long long ss) {
  auto ok = [](long long n, long long st) { return n == 1 || (st > 0 && st % 8 == 0); };
  return aligned16(p) && ok(nb, sb) && ok(nh, sh) && ok(ns, ss);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of a bf16 (B, heads, S, dh) view (strides in elements): dims
// dh, then S, heads and batch in the order of their strides (an axis of
// length 1 last, its stride past the others' extent), 128-byte swizzle, a
// box of 64 dh x 128 rows of S, zero fill out of bounds. `axes` gets the
// map dim of S, heads and batch (2 bits each). Returns 0 or
// FW_ENCODE_ERROR + the CUresult.
static int encode_view(CUtensorMap* map, const void* base, int dh, long long nb, long long nh,
                       long long ns, long long sb, long long sh, long long ss, int* axes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return FW_ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  struct Axis {
    long long n, st;
    int id;  // 0 S, 1 heads, 2 batch
  } ax[3] = {{ns, ss, 0}, {nh, sh, 1}, {nb, sb, 2}};
  auto before = [](const Axis& x, const Axis& y) {
    return (x.n == 1) != (y.n == 1) ? y.n == 1 : x.st < y.st;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(ax[j], ax[j - 1]); --j) {
      const Axis tmp = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)dh, 1, 1, 1}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  long long extent = 2LL * dh;  // bytes spanned by the dims so far
  *axes = 0;
  for (int i = 0; i < 3; ++i) {
    long long st = 2 * ax[i].st;
    if (ax[i].n == 1) st = (extent + 15) / 16 * 16;
    dims[1 + i] = (cuuint64_t)ax[i].n;
    strides[i] = (cuuint64_t)st;
    extent = st * ax[i].n > extent ? st * ax[i].n : extent;
    if (ax[i].id == 0) box[1 + i] = FW_K;
    *axes |= (1 + i) << (2 * ax[i].id);
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FW_ENCODE_ERROR + (int)r;
}

static int launch_wgmma(const AttnArgs& a, int B, unsigned long long* clocks,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  WgArgs w;
  int err = encode_view(&tq, a.q, a.dh, B, a.H, a.S, a.q_sb, a.q_sh, a.q_ss, &w.q_axes);
  if (err == 0)
    err = encode_view(&tk, a.k, a.dh, B, a.KV, a.S, a.k_sb, a.k_sh, a.k_ss, &w.k_axes);
  if (err == 0)
    err = encode_view(&tv, a.v, a.dh, B, a.KV, a.S, a.v_sb, a.v_sh, a.v_ss, &w.v_axes);
  if (err != 0) return err;
  w.o = a.o;
  w.o_sb = a.o_sb;
  w.o_sh = a.o_sh;
  w.o_ss = a.o_ss;
  w.B = B;
  w.H = a.H;
  w.KV = a.KV;
  w.S = a.S;
  w.dh = a.dh;
  w.causal = a.causal;
  w.window = a.window;
  w.n_qt = (a.S + FW_Q - 1) / FW_Q;
  w.scale_log2 = a.scale_log2;
  w.clocks = clocks;
  const long long blocks = (long long)w.n_qt * B * a.H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a cluster of two heads of one GQA group where the group is even
  const int cl = (a.H / a.KV) % 2 == 0 ? 2 : 1;
  auto kernel = cl == 2 ? (clocks ? flash_wgmma_kernel<true, 2> : flash_wgmma_kernel<false, 2>)
                        : (clocks ? flash_wgmma_kernel<true, 1> : flash_wgmma_kernel<false, 1>);
  cudaError_t e = open_dynamic_smem((const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(FW_THREADS);
  cfg.dynamicSmemBytes = FW_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, w);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// variant 0: flash_f32_kernel (f32), 1: flash_bf16_kernel (bf16, mma.sync),
// 2: flash_wgmma_kernel (bf16, dh % 8 == 0, 64 < dh <= 128, TMA-able views,
// see tma_view); a variant whose requirements fail is refused, never
// replaced. dtype 0: f32, 1: bf16. Strides in elements; the last dim is
// contiguous. window <= 0 means no window. `clocks` (variant 2 only, else
// null): FP_N zeroed sums that the profiled instantiation adds to. Returns
// a cudaError_t, or FW_ENCODE_ERROR + the CUresult of a TMA map that
// failed to encode.
extern "C" int flash_attention_fwd(int variant, int dtype, const void* q, const void* k,
                                   const void* v, void* o, long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh,
                                   long long v_ss, long long o_sb, long long o_sh,
                                   long long o_ss, int B, int H, int KV, int S, int dh,
                                   int causal, int window, void* clocks, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || dh < 1 || dh > 128 || B > 65535 ||
      H > 65535 || (clocks != nullptr && variant != 2))
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.dh = dh;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  const long long e = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  a.vec = dh % e == 0 && q_sb % e == 0 && q_sh % e == 0 && q_ss % e == 0 &&
          k_sb % e == 0 && k_sh % e == 0 && k_ss % e == 0 && v_sb % e == 0 &&
          v_sh % e == 0 && v_ss % e == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  cudaStream_t st = (cudaStream_t)stream;
  const int dp = dh <= 32 ? 32 : (dh <= 64 ? 64 : 128);
  if (variant == 2) {
    const bool ok = dtype == 1 && dh % 8 == 0 && dh > 64 &&
                    tma_view(q, B, H, S, q_sb, q_sh, q_ss) &&
                    tma_view(k, B, KV, S, k_sb, k_sh, k_ss) &&
                    tma_view(v, B, KV, S, v_sb, v_sh, v_ss) &&
                    (reinterpret_cast<uintptr_t>(o) & 3u) == 0 && o_sb % 2 == 0 &&
                    o_sh % 2 == 0 && o_ss % 2 == 0;
    return ok ? launch_wgmma(a, B, static_cast<unsigned long long*>(clocks), st)
              : (int)cudaErrorInvalidValue;
  }
  if (variant == 1 && dtype == 1) {
    switch (dp) {
      case 32: return (int)launch(flash_bf16_kernel<32>, BfLayout<32>::BYTES, FB_THREADS, FB_Q, B, a, st);
      case 64: return (int)launch(flash_bf16_kernel<64>, BfLayout<64>::BYTES, FB_THREADS, FB_Q, B, a, st);
      default: return (int)launch(flash_bf16_kernel<128>, BfLayout<128>::BYTES, FB_THREADS, FB_Q, B, a, st);
    }
  }
  if (variant == 0 && dtype == 0) {
    switch (dp) {
      case 32: return (int)launch(flash_f32_kernel<32>, F32Layout<32>::BYTES, FF_THREADS, FF_Q, B, a, st);
      case 64: return (int)launch(flash_f32_kernel<64>, F32Layout<64>::BYTES, FF_THREADS, FF_Q, B, a, st);
      default: return (int)launch(flash_f32_kernel<128>, F32Layout<128>::BYTES, FF_THREADS, FF_Q, B, a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

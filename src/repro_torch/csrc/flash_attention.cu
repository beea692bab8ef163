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
// What the design does about it: bf16 inputs run on the tensor cores with
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate), FlashAttention-2 style.
// One block of 4 warps takes 64 queries of one (b, h); each warp owns 16
// query rows, keeps its Q fragments in registers for the whole loop, and
// walks the KV tiles of 64 keys that the masks reach (from the window's
// first tile to the diagonal): fully masked tiles are skipped, not computed.
// S = Q K^T stays in registers; the online softmax runs on the
// accumulator fragments (row max and sum across the 4 threads of a row by
// shuffles; the masks are evaluated only on tiles that cross the diagonal,
// the window's edge or S); P is rounded to bf16 and reused in place as the
// A operand of O += P V (the accumulator layout of m16n8 is the A layout
// of m16k16). K and V tiles are double-buffered in shared memory by
// cp.async, the next tile streaming in while this one computes, row-major
// with a padded stride; every fragment comes from one ldmatrix.x4 (V's
// transposed by ldmatrix.trans) without bank conflicts. dh
// is padded with zeros to DP in {32, 64, 128} (danube's 120 -> 128); ragged
// S is masked by key position (k_pos < S) and the rows past S are not
// stored, so no padding of the inputs is needed and causal=False works too.
// f32 inputs run a SIMT kernel with the same tiling logic (32 x 32 tiles,
// fp32 FMA, no TF32). Both take strides, so the transformer passes
// transposed (B, S, H, dh) views without a copy; rows that are not 16-byte
// aligned are staged by plain loads. Later work: wgmma with TMA, one KV
// tile shared by the heads of a group, warp specialisation.
#include <cstdint>
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
__device__ __forceinline__ void kv_tiles(const AttnArgs& a, int q0, int bq, int bk,
                                         int& t0, int& t1) {
  int lo = 0;
  if (a.window > 0) lo = max(0, q0 - a.window + 1);
  const int hi = a.causal ? min(a.S, q0 + bq) : a.S;
  t0 = lo / bk;
  t1 = (hi + bk - 1) / bk;
}

__device__ __forceinline__ bool key_valid(const AttnArgs& a, int qp, int kp) {
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
// Host side.
// ---------------------------------------------------------------------------

template <typename Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, int threads, int q_tile, int B,
                          const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + q_tile - 1) / q_tile, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// dtype 0: f32, 1: bf16. Strides in elements; the last dim is contiguous.
// window <= 0 means no window. Returns a cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, int B,
                                   int H, int KV, int S, int dh, int causal, int window,
                                   void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || dh < 1 || dh > 128 || B > 65535 ||
      H > 65535)
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
  if (dtype == 1) {
    switch (dp) {
      case 32: return (int)launch(flash_bf16_kernel<32>, BfLayout<32>::BYTES, FB_THREADS, FB_Q, B, a, st);
      case 64: return (int)launch(flash_bf16_kernel<64>, BfLayout<64>::BYTES, FB_THREADS, FB_Q, B, a, st);
      default: return (int)launch(flash_bf16_kernel<128>, BfLayout<128>::BYTES, FB_THREADS, FB_Q, B, a, st);
    }
  }
  if (dtype == 0) {
    switch (dp) {
      case 32: return (int)launch(flash_f32_kernel<32>, F32Layout<32>::BYTES, FF_THREADS, FF_Q, B, a, st);
      case 64: return (int)launch(flash_f32_kernel<64>, F32Layout<64>::BYTES, FF_THREADS, FF_Q, B, a, st);
      default: return (int)launch(flash_f32_kernel<128>, F32Layout<128>::BYTES, FF_THREADS, FF_Q, B, a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// pipelined fp32 scans (ip_scan.cuh, kmeans_assign.cu), and the staging of
// a depth chunk of rows built on them.
//
// A copy that is not `valid` reads nothing and writes zeros (the src-size
// operand is 0); its src must still be a mapped address, so callers pass
// the array's base pointer there. Each thread commits its copies in groups
// (one group per ring stage) and waits until at most N groups are still in
// flight; a barrier after the wait makes the whole stage visible to the
// block.
#pragma once
#include <cstddef>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes; dst and src 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + ROWS) of a row-major array of n_rows rows of
// `ld` elements (depths [0, d) used), depths [kc, kc + BK), into a shared
// slot of `stride` bytes a row, with THREADS threads and UNIT bytes a copy
// (16 or 4: cp.async; 1: a plain load and store). Thread t copies unit
// t % UPR of rows t / UPR + i * (THREADS / UPR), so its depth and its
// pointer step are fixed for the call. Units past d or n_rows are zeros.
template <int THREADS, typename T, int BK, int ROWS, int UNIT>
__device__ __forceinline__ void stage_chunk_rows(unsigned char* dst, int stride,
                                                 const T* src, int row0, int n_rows, int d,
                                                 int kc, long long ld) {
  constexpr int PER = UNIT >= (int)sizeof(T) ? UNIT / (int)sizeof(T) : 1;  // T a copy
  constexpr int UPR = BK / PER;                // copies a row
  constexpr int STEP = THREADS / UPR;          // rows a pass
  static_assert(THREADS % UPR == 0, "whole rows a pass");
  const int u = threadIdx.x % UPR, r = threadIdx.x / UPR, dd = kc + u * PER;
  const bool in_depth = dd < d;
  unsigned char* out = dst + r * stride + u * UNIT;
  const T* in = src + (size_t)(row0 + r) * ld + dd;
#pragma unroll
  for (int i = 0; i < (ROWS + STEP - 1) / STEP; ++i) {
    if (ROWS % STEP != 0 && r + i * STEP >= ROWS) break;
    const bool ok = in_depth && row0 + r + i * STEP < n_rows;
    const T* p = ok ? in + (size_t)i * STEP * ld : src;
    unsigned char* o = out + i * STEP * stride;
    if constexpr (UNIT == 16) cp_async16(o, p, ok);
    else if constexpr (UNIT == 4) cp_async4(o, p, ok);
    else *reinterpret_cast<T*>(o) = ok ? *p : T(0);
  }
}

// Rows of exactly d elements (ld = d).
template <int THREADS, typename T, int BK, int ROWS, int UNIT>
__device__ __forceinline__ void stage_chunk_rows(unsigned char* dst, int stride,
                                                 const T* src, int row0, int n_rows, int d,
                                                 int kc) {
  stage_chunk_rows<THREADS, T, BK, ROWS, UNIT>(dst, stride, src, row0, n_rows, d, kc, d);
}

// As stage_chunk_rows, for the rows rows[0 .. ROWS) of a row-major array
// (row i at src + rows[i] * ld; rows[i] < 0: zeros), `rows` in shared
// memory: one shared load a copy for the row's index.
template <int THREADS, typename T, int BK, int ROWS, int UNIT>
__device__ __forceinline__ void stage_chunk_rows_at(unsigned char* dst, int stride,
                                                    const T* src, const int* rows, int d,
                                                    int kc, long long ld) {
  constexpr int PER = UNIT >= (int)sizeof(T) ? UNIT / (int)sizeof(T) : 1;
  constexpr int UPR = BK / PER;
  constexpr int STEP = THREADS / UPR;
  static_assert(THREADS % UPR == 0 && UNIT >= 4, "whole rows a pass, cp.async copies");
  const int u = threadIdx.x % UPR, r = threadIdx.x / UPR, dd = kc + u * PER;
  const bool in_depth = dd < d;
  unsigned char* out = dst + r * stride + u * UNIT;
#pragma unroll
  for (int i = 0; i < (ROWS + STEP - 1) / STEP; ++i) {
    if (ROWS % STEP != 0 && r + i * STEP >= ROWS) break;
    const int row = rows[r + i * STEP];
    const bool ok = in_depth && row >= 0;
    const T* p = ok ? src + (size_t)row * ld + dd : src;
    unsigned char* o = out + i * STEP * stride;
    if constexpr (UNIT == 16) cp_async16(o, p, ok);
    else cp_async4(o, p, ok);
  }
}

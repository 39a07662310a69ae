// Shared-memory staging shared by the kernels of this directory
// (flash_attention's forward and backward and flash_decode's bf16 routes,
// matmul_qi8, rwkv6_scan's chunks): 16-byte cp.async copies with zero
// fill, their commit and wait, ldmatrix, and the bf16 row-tile copy of the
// flash-attention kernels.  _build.py hashes this header into each
// library's name, so an edit here rebuilds every kernel.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices (8 x 16 bytes each); lanes 8i .. 8i + 7 give
// the row addresses of matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix with row stride `ld`
// (elements) -> shared (ROWS, D + 8) by 16-byte cp.async; rows at or past
// `n` are zero-filled.  Where a row's D / 8 chunks divide THREADS, thread t
// copies chunk t % (D / 8) of every (THREADS / (D / 8))-th row from row
// t / (D / 8) on, so consecutive threads read consecutive bytes and its
// source address only steps; else (D 96: 12 chunks) thread t copies chunks
// t, t + THREADS, ... of the tile, in row-major order.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long ld, int r0, int n) {
  constexpr int kChunks = D / 8;      // 16-byte chunks a row
  constexpr int kLd = D + 8;
  if constexpr (THREADS % kChunks == 0) {
    constexpr int kStep = THREADS / kChunks;
    const int c = threadIdx.x % kChunks;
    const int r = threadIdx.x / kChunks;
    const __nv_bfloat16* from = src + (r0 + r) * ld + c * 8;
    __nv_bfloat16* to = dst + r * kLd + c * 8;
    const int left = n - r0 - r;      // rows of this thread still inside
#pragma unroll
    for (int j = 0; j < (ROWS + kStep - 1) / kStep; ++j) {
      if (ROWS % kStep != 0 && r + j * kStep >= ROWS) break;
      const bool ok = j * kStep < left;
      cp_async16(to + j * kStep * kLd, ok ? from : src, ok ? 16 : 0);
      from += kStep * ld;
    }
  } else {
#pragma unroll
    for (int j = 0; j < (ROWS * kChunks + THREADS - 1) / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if ((ROWS * kChunks) % THREADS != 0 && i >= ROWS * kChunks) break;
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r0 + r < n;
      cp_async16(dst + r * kLd + c * 8,
                 ok ? src + (r0 + r) * ld + c * 8 : src, ok ? 16 : 0);
    }
  }
}

}  // namespace

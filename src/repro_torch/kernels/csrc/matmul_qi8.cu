// int8 x int8 -> int32 matrix product for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/matmul_qi8.py (`matmul_qi8`,
// its pl.pallas_call at line 56; the Edge TPU systolic-array analogue):
//   x (M, K) int8 row-major, w (K, N) int8 row-major -> (M, N) int32,
//   every product and sum exact in int32.
// Unlike the Pallas kernel it takes any (M, K, N): the ragged edge tiles are
// zero-filled on load (a zero adds nothing to an exact sum), so K need not
// be a multiple of 4 and N = 1000 (the ResNet head) needs no padding.
//
// Bound: 2*M*N*K int8 operations at the 1,979 TOPS int8 tensor-core peak
// against M*K + K*N bytes in and 4*M*N bytes out at 3.35 TB/s.  At 512^3 the
// operations take 0.14 us and the bytes 0.39 us; at the 1x1-conv shape
// (25088 x 64 x 256) the int32 output alone is 25.7 MB (7.7 us), so most
// shapes of the CNN path are bound by bytes.
//
// Design (simple and correct first): one block of 256 threads per 64 x 64
// output tile; it walks K in steps of 32, staging the x tile (64 x 32) and
// the w tile transposed on load (64 columns x 32, K contiguous) in shared
// memory, so each thread reads 4 packed int8 of a row and of a column as one
// 32-bit word and feeds them to __dp4a (four int8 MACs into an int32).  Each
// thread keeps a 4 x 4 tile of int32 accumulators in registers.  The loads
// are byte-wide and coalesced in global memory.  No tensor cores: mma.sync
// or wgmma with s8 operands, and a deeper load pipeline, are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;               // output rows per block
constexpr int kBN = 64;               // output columns per block
constexpr int kBK = 32;               // K per step (int8)
constexpr int kPad = 4;               // keeps rows 4-byte aligned
constexpr int kLd = kBK + kPad;       // shared row stride (bytes)
constexpr int kTX = 16;               // threads across the columns
constexpr int kTY = 16;               // threads down the rows
constexpr int kThreads = kTX * kTY;   // 256
constexpr int kRM = kBM / kTY;        // rows per thread
constexpr int kRN = kBN / kTX;        // columns per thread

__global__ void __launch_bounds__(kThreads)
    matmul_qi8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int32_t* __restrict__ o,
                      int m, int n, int k) {
  __shared__ __align__(16) int8_t xs[kBM * kLd];   // (row, k)
  __shared__ __align__(16) int8_t wt[kBN * kLd];   // (column, k)
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  int32_t acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile: consecutive threads read consecutive k of one row
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      xs[r * kLd + c] =
          gr < m && gc < k ? x[static_cast<long long>(gr) * k + gc] : 0;
    }
    // w tile, transposed: consecutive threads read consecutive columns
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      wt[c * kLd + r] =
          gr < k && gc < n ? w[static_cast<long long>(gr) * n + gc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      int a[kRM], b[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        a[i] = *reinterpret_cast<const int*>(&xs[(ty + i * kTY) * kLd + kk]);
#pragma unroll
      for (int j = 0; j < kRN; ++j)
        b[j] = *reinterpret_cast<const int*>(&wt[(tx + j * kTX) * kLd + kk]);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();                  // tiles read before the next load
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gr = row0 + ty + i * kTY;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int gc = col0 + tx + j * kTX;
      if (gc < n) o[static_cast<long long>(gr) * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

// x (m, k), w (k, n) int8 and o (m, n) int32, all row-major and contiguous;
// m, n >= 1, k >= 0.  Returns the launch's cudaError_t (0 on success); the
// caller raises on anything else.
extern "C" int matmul_qi8_fwd(const void* x, const void* w, void* o, int m,
                              int n, int k, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_qi8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(o), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// RG-LRU linear recurrence h_t = a_t * h_{t-1} + g_t (diagonal, per
// channel), one pass over the sequence with the carry in a register, for
// sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (`rglru_scan`,
// its pl.pallas_call at line 56): the same function.
//   a, g (B, S, R), h0 (B, R) fp32 -> y (B, S, R) in a's dtype (y_t = h_t),
//   h_last (B, R) fp32; the carry is fp32 whatever the input type.
// Unlike the Pallas kernel it has no chunk: any S, including the S = 1
// decode step.  a and g must be contiguous.
//
// Bound at the model's shape (B=2, S=1024, R=4096, fp32): a, g and y are
// 33.6 MB each, 100.7 MB -> 30 us at 3.35 TB/s; 2 flops per element (8.4
// MFLOP) are nothing.  So the bound is bytes: every element must be read
// and written once, in coalesced loads, with enough loads in flight.
//
// Design: one thread per (batch row, channel), 128 threads a block over
// consecutive channels (grid (R / 128, B)), so each step's loads and stores
// of a warp are 32 consecutive elements.  The recurrence is sequential in t,
// but a_t and g_t do not depend on h: a thread loads kUnroll steps of both
// into registers before it runs their kUnroll fused multiply-adds, which
// keeps 2 * kUnroll loads in flight per thread.  Only B * R threads exist
// (8192 at the model's shape, 64 blocks on 132 SMs), so the kernel is bound
// by load latency, not bandwidth; a chunked two-pass scan that spreads S
// over more blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;           // steps loaded ahead of their FMAs

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ g,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, int s, int r) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= r) return;
  const long long base = static_cast<long long>(b) * s * r + c;
  float h = h0[static_cast<long long>(b) * r + c];
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(t0 + u) * r;
      const bool ok = t0 + u < s;
      av[u] = ok ? to_float(a[i]) : 0.f;
      gv[u] = ok ? to_float(g[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < s) {
        h = fmaf(av[u], h, gv[u]);
        y[base + static_cast<long long>(t0 + u) * r] = from_float<T>(h);
      }
    }
  }
  h_last[static_cast<long long>(b) * r + c] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* g, const float* h0, void* y,
                   float* h_last, int b, int s, int r, cudaStream_t stream) {
  const dim3 grid((r + kThreads - 1) / kThreads, b);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), h0,
      static_cast<T*>(y), h_last, s, r);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, g and y; h0 and h_last are fp32).
// Every array is contiguous.  Returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int rglru_scan_fwd(const void* a, const void* g, const float* h0,
                              void* y, float* h_last, int dtype, int b, int s,
                              int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? launch<float>(a, g, h0, y, h_last, b, s, r, st)
      : dtype == 1 ? launch<__nv_bfloat16>(a, g, h0, y, h_last, b, s, r, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

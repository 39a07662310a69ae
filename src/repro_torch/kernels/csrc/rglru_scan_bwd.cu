// The gradient of the RG-LRU recurrence h_t = a_t h_{t-1} + g_t
// (csrc/rglru_scan.cu) with respect to a, g and h0, for sm_90a.
//
// The TPU kernel src/repro/kernels/rglru_scan.py (`rglru_scan`, its
// pl.pallas_call at line 56) has no backward: the reference differentiates
// its jnp recurrence.  This kernel computes that gradient, the reverse
// recurrence of kernels/ref.py `rglru_scan_bwd_ref`, per channel:
//   G_t  = dy_t + a_{t+1} G_{t+1},   G_{S-1} = dy_{S-1} + dh_last
//   dg_t = G_t,   da_t = G_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 G_0
// a, dy (B, S, R) fp32 or bf16 (one dtype), h0 and dh_last (B, R) fp32, the
// carry hs (B, S, R) fp32 -> da, dg (B, S, R) in a's dtype, dh0 (B, R)
// fp32.  Every array contiguous; any S and R.  For fp32 inputs hs is the
// forward's output y (then exactly the carry).  For bf16 inputs y is the
// carry rounded, so the kernel first walks the forward recurrence (the
// forward kernel's FMAs, g read in bf16) and writes the fp32 carry to the
// scratch hs, which each thread then reads back for its own channel.
//
// Bound at recurrentgemma-9b's training shape (B 8, S 1024, R 4096, fp32):
// a, hs and dy read and da and dg written once, 5 x 134 MB, 671 MB -> 0.20
// ms at 3.35 TB/s; 3 flops per element are nothing.  So the bound is bytes:
// enough loads in flight on every SM to cover the memory's latency.
//
// Design: the forward's step route run backwards.  One thread per (batch
// row, channel), 128 threads a block over consecutive channels (coalesced
// rows), walking S from the end in batches of kUnroll (16) steps whose a,
// dy and h_{t-1} are loaded before their FMAs: 32768 threads at the
// training shape, each with 48 loads in flight.  fp32 arithmetic, bf16
// widened on load and rounded on store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;           // steps loaded ahead of their FMAs

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ g,
                     const float* __restrict__ h0, float* __restrict__ hs,
                     const T* __restrict__ dy,
                     const float* __restrict__ dh_last, T* __restrict__ da,
                     T* __restrict__ dg, float* __restrict__ dh0, int s,
                     int r, int recompute) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= r) return;
  const long long base = static_cast<long long>(b) * s * r + c;
  const float h_init = h0[static_cast<long long>(b) * r + c];
  if (recompute) {                    // the fp32 carry of bf16 inputs
    float h = h_init;
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
          hs[base + static_cast<long long>(t0 + u) * r] = h;
        }
      }
    }
  }
  float grad = dh_last ? dh_last[static_cast<long long>(b) * r + c] : 0.f;
  // steps t1, t1 - 1, ..., t1 - kUnroll + 1 (those >= 0)
  for (int t1 = s - 1; t1 >= 0; t1 -= kUnroll) {
    float av[kUnroll], dv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      const long long i = base + static_cast<long long>(t) * r;
      const bool ok = t >= 0;
      av[u] = ok ? to_float(a[i]) : 0.f;
      dv[u] = ok ? to_float(dy[i]) : 0.f;
      hp[u] = t > 0 ? hs[i - r] : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long i = base + static_cast<long long>(t) * r;
        grad += dv[u];
        dg[i] = from_float<T>(grad);
        da[i] = from_float<T>(grad * hp[u]);
        grad *= av[u];
      }
    }
  }
  dh0[static_cast<long long>(b) * r + c] = grad;
}

template <typename T>
cudaError_t launch(const void* a, const void* g, const float* h0, float* hs,
                   const void* dy, const float* dh_last, void* da, void* dg,
                   float* dh0, int b, int s, int r, int recompute,
                   cudaStream_t stream) {
  const dim3 grid((r + kThreads - 1) / kThreads, b);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), h0, hs,
      static_cast<const T*>(dy), dh_last, static_cast<T*>(da),
      static_cast<T*>(dg), dh0, s, r, recompute);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, g, dy, da and dg; h0, hs, dh_last
// and dh0 are fp32).  recompute 0: hs holds the carry (fp32 inputs: the
// forward's y); 1: hs is (B, S, R) fp32 scratch the kernel first fills
// with the carry from a, g and h0.  dh_last may be null (a zero gradient).
// Every array contiguous.  One launch; returns its cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int rglru_scan_bwd(const void* a, const void* g, const float* h0,
                              float* hs, const void* dy,
                              const float* dh_last, void* da, void* dg,
                              float* dh0, int dtype, int b, int s, int r,
                              int recompute, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(a, g, h0, hs, dy, dh_last, da, dg, dh0, b,
                                 s, r, recompute, st)
      : dtype == 1
          ? launch<__nv_bfloat16>(a, g, h0, hs, dy, dh_last, da, dg, dh0, b,
                                  s, r, recompute, st)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

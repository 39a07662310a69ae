// RWKV6 WKV recurrence (the Finch time-mix core), one pass over the
// sequence with the state on chip, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py (`rwkv6_scan`,
// its pl.pallas_call at line 63): the same function.  Per (batch, head),
// with state S (K x V, K == V == D) in fp32:
//   y_t = r_t (S + diag(u) k_t^T v_t)
//   S   <- diag(w_t) S + k_t^T v_t
// r/k/v/w (B, H, S, D), u (H, D), s0 (B, H, D, D) fp32 -> y (B, H, S, D) in
// r's dtype, s_last (B, H, D, D) fp32.
// Unlike the Pallas kernel it has no chunk (any S, including the S = 1
// decode step: the state stays in registers for the whole sequence), and it
// takes element strides for the batch, head and sequence axes of r/k/v/w
// and y (the head dim must be contiguous), so the model's (B, S, H, D)
// projections are read as (B, H, S, D) views and y is written straight into
// a (B, S, H, D) buffer.
//
// Bound at the model's shape (B=4, H=32, S=1024, D=64, fp32): r/k/v/w and y
// are 33.6 MB each and s0/s_last 2.1 MB each, 172 MB -> 51 us at 3.35 TB/s;
// the work is 4 flops per state element per step (the rank-1 product, the
// u term, the r contraction and the decay), 2.1 GFLOP -> 32 us at the
// 67 TFLOP/s fp32 CUDA-core peak.  So the bound is bytes, but only a kernel
// with thousands of independent steps in flight reaches it; the recurrence
// walks S dependent steps.
//
// Design: one warp per (32 state columns, head, batch row): grid (D / 32,
// H, B) (D <= 32: one block of D active lanes).  Lane j holds its state
// column S[:, j] (D floats) in registers for the whole scan.  Each step the
// warp stages the step's r/k/w rows (and u) in shared memory as one float4
// per k, so a lane reads (r_k, k_k, w_k, u_k) in one broadcast load; the
// next step's rows and v are loaded into registers before the current step
// computes (they do not depend on the state), and a double-buffered stage
// needs one __syncwarp per step.  Lane j then computes
//   y_j = sum_k r_k (S_kj + u_k k_k v_j),  S_kj <- w_k S_kj + k_k v_j
// with four partial sums, and writes y_j: the warp's 32 outputs of a step
// are contiguous.  fp32 arithmetic throughout, bf16 inputs widened on load.
// Far from the bound by design (S dependent steps, few warps per SM):
// splitting the state further and chunked two-pass forms are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

constexpr int kLanes = 32;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;                     // (H, D) contiguous
  const float* s0;                    // (B, H, D, D) contiguous
  void* y;
  float* s_last;                      // (B, H, D, D) contiguous
  int s;
  long long rs[3], ks[3], vs[3], ws[3], ys[3];   // (batch, head, seq)
};

template <typename T, int D>
__global__ void __launch_bounds__(kLanes) rwkv6_scan_kernel(Args a) {
  constexpr int kCols = D < kLanes ? D : kLanes;   // state columns a warp owns
  constexpr int kPer = (D + kLanes - 1) / kLanes;  // row elements a lane loads
  __shared__ float4 rows[2][D];                    // (r, k, w, u) per k

  const int lane = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col = blockIdx.x * kCols + lane;
  const bool owns_col = lane < kCols;
  const T* rp = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const T* wp = static_cast<const T*>(a.w) + b * a.ws[0] + h * a.ws[1];
  T* yp = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[1];
  const long long sbase = (static_cast<long long>(b) * gridDim.y + h) * D * D;

  float st[D];
#pragma unroll
  for (int kk = 0; kk < D; ++kk)
    st[kk] = owns_col ? a.s0[sbase + kk * D + col] : 0.f;
  float uu[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + i * kLanes;
    uu[i] = e < D ? a.u[h * D + e] : 0.f;
  }

  // step t's row elements of this lane, and v of its column
  float pr[kPer], pk[kPer], pw[kPer], pv = 0.f;
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + i * kLanes;
      if (e < D) {
        pr[i] = to_float(rp[t * a.rs[2] + e]);
        pk[i] = to_float(kp[t * a.ks[2] + e]);
        pw[i] = to_float(wp[t * a.ws[2] + e]);
      }
    }
    if (owns_col) pv = to_float(vp[t * a.vs[2] + col]);
  };
  load_step(0);

  for (int t = 0; t < a.s; ++t) {
    float4* buf = rows[t & 1];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + i * kLanes;
      if (e < D) buf[e] = make_float4(pr[i], pk[i], pw[i], uu[i]);
    }
    const float v = pv;
    if (t + 1 < a.s) load_step(t + 1);
    __syncwarp();

    float y4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D; ++kk) {
      const float4 q = buf[kk];
      const float kv = q.y * v;
      y4[kk & 3] = fmaf(q.x, fmaf(q.w, kv, st[kk]), y4[kk & 3]);
      st[kk] = fmaf(q.z, st[kk], kv);
    }
    if (owns_col)
      yp[t * a.ys[2] + col] = from_float<T>((y4[0] + y4[1]) + (y4[2] + y4[3]));
  }

  if (owns_col) {
#pragma unroll
    for (int kk = 0; kk < D; ++kk) a.s_last[sbase + kk * D + col] = st[kk];
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int h, cudaStream_t stream) {
  constexpr int kCols = D < kLanes ? D : kLanes;
  const dim3 grid(D / kCols, h, b);
  rwkv6_scan_kernel<T, D><<<grid, kLanes, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, int h, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, b, h, stream);
    case 32: return launch<T, 32>(a, b, h, stream);
    case 64: return launch<T, 64>(a, b, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y; u, s0 and s_last are
// fp32).  strides: 15 element strides, the (batch, head, seq) strides of r,
// k, v, w and y in that order.  Returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              void* y, float* s_last, int dtype, int b, int h,
                              int s, int d, const long long* strides,
                              void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_last = s_last;
  a.s = s;
  long long* dst[5] = {a.rs, a.ks, a.vs, a.ws, a.ys};
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(a, b, h, d, st)
                    : dtype == 1
                        ? dispatch_d<__nv_bfloat16>(a, b, h, d, st)
                        : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
// Unlike the Pallas kernel it takes any S, including the S = 1 decode step
// (no S % chunk requirement), and element strides for the batch, head and
// sequence axes of r/k/v/w and y (the head dim contiguous, r/k/v/w rows
// 16-byte aligned), so the model's (B, S, H, D) projections are read as
// (B, H, S, D) views and y is written straight into a (B, S, H, D) buffer.
// It keeps the step recurrence, which is exact for any decay w in [0, 1]:
// the chunked form divides by cumulative decay products, which overflow
// for small w.
//
// Bound at the model's shape (B=4, H=32, S=1024, D=64, fp32): r/k/v/w and y
// are 33.6 MB each and s0/s_last 2.1 MB each, 172 MB -> 51 us at 3.35 TB/s;
// the work is 4 flops per state element per step (the rank-1 product, the
// u term, the r contraction and the decay), 2.1 GFLOP -> 32 us at the
// 67 TFLOP/s fp32 CUDA-core peak.  So the bound is bytes, but the
// recurrence walks S dependent steps: what sets the time is the latency of
// one step, and how many threads share its work.
//
// Design: one block of 256 threads (8 warps) per (head, batch row), grid
// (H, B): 128 blocks at the model's (4, 32), one per SM.  (The columns
// are not split over two blocks: 256 half-head blocks would still leave
// some SM with two, and each would stage the whole r/k/w rows.)  The
// state is split over KS = 256 / D threads per column (4 at D 64): thread
// (part p, column j), p = tid / D, holds the k-rows k = 4 (p + KS i) + c of
// column j (D / KS of them, 16 at D 64) in registers for the whole scan,
// so a step is D / KS updates a thread, not D.  The lanes of a warp share
// p, so a step's loads of r, k and w (4 consecutive k in one 16-byte load,
// 8 bytes in bf16) are broadcasts, one shared-memory wavefront a warp;
// with the KS parts of a column in one warp they were 4, and the scan was
// bound by shared-memory wavefronts.  The r/k/w/v rows of a chunk of 64
// steps are staged in shared memory by 16-byte cp.async, double-buffered:
// chunk c + 1 is in flight while chunk c is scanned, so the inner loop
// reads shared memory only and pays one memory round trip a chunk, not a
// step.  Each step writes the thread's partial y to shared memory; after
// the chunk the block sums the KS partials of each (step, column) and
// writes y a row at a time.  The decode step (S = 1) runs an
// instantiation that stages one step (3 KB of shared memory, not 192).
// fp32 arithmetic throughout, bf16 inputs widened on load.
//
// Checkpoint epilogue (training): given `ckpt`, an instantiation of its
// own also writes the state at the start of every kPiece-step piece, S
// after 8p steps (s0 for p = 0), to ckpt (B, H, ceil(S / 8), D, D) fp32,
// the same values its FMAs carry, so equal bit for bit to the s_last of
// the kernel run on the first 8p steps.  The backward kernel
// (rwkv6_scan_bwd.cu) starts from them instead of walking the forward
// again.  Serving (ckpt null) runs the instantiation without it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunkSteps = 64;       // steps staged a chunk
constexpr int kPiece = 8;             // steps between checkpoints

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;                     // (H, D) contiguous
  const float* s0;                    // (B, H, D, D) contiguous
  void* y;
  float* s_last;                      // (B, H, D, D) contiguous
  float* ckpt;                        // (B, H, ceil(S / 8), D, D) or null
  int s;
  long long rs[3], ks[3], vs[3], ws[3], ys[3];   // (batch, head, seq)
};

// N consecutive elements of shared memory -> floats
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_float(p[i]);
}
template <>
__device__ __forceinline__ void load_n<4, float>(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
template <>
__device__ __forceinline__ void load_n<4, __nv_bfloat16>(
    const __nv_bfloat16* p, float* f) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <typename T, int D, int kChunk, bool kCkpt>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(Args a) {
  constexpr int kKs = kThreads / D;   // threads a column
  constexpr int kPer = D / kKs;       // k-rows a thread holds
  constexpr int kVw = kPer < 4 ? kPer : 4;   // consecutive k a load
  constexpr int kGroups = kPer / kVw;
  constexpr int kRowPieces = D * sizeof(T) / 16;   // 16-byte pieces a row
  static_assert(kPer % kVw == 0, "whole groups of consecutive k");
  static_assert(kRowPieces >= 1, "a row is whole 16-byte pieces");
  // (buffer, array r/k/w/v, step, D) staged rows, 128 KB at fp32 D 64,
  // then (step, thread) partial sums of y, 64 KB
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T (*rows)[4][kChunk][D] = reinterpret_cast<T (*)[4][kChunk][D]>(smem_raw);
  float (*ypart)[kThreads] = reinterpret_cast<float (*)[kThreads]>(
      smem_raw + 2 * 4 * kChunk * D * sizeof(T));

  // the lanes of a warp share a part (all of them when D >= 32), so a
  // step's r/k/w loads are one broadcast a warp
  const int col = threadIdx.x % D;
  const int part = threadIdx.x / D;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* src[4] = {
      static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[1],
      static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1],
      static_cast<const T*>(a.w) + b * a.ws[0] + h * a.ws[1],
      static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1]};
  const long long sstep[4] = {a.rs[2], a.ks[2], a.ws[2], a.vs[2]};
  constexpr int kRowT = 16 / sizeof(T);       // elements a 16-byte piece
  T* yp = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[1];
  const long long sbase =
      (static_cast<long long>(b) * gridDim.x + h) * D * D;
  const int n_chunks = (a.s + kChunk - 1) / kChunk;
  // this (b, h)'s checkpoints: ceil(S / kPiece) states of D x D
  float* ck = kCkpt ? a.ckpt + sbase * ((a.s + kPiece - 1) / kPiece)
                    : nullptr;

  // chunk c's rows -> buffer c & 1, 16 bytes a copy (the array index is
  // a constant of the unrolled loop, so src and sstep stay in registers)
  auto stage = [&](int c) {
    if (c < n_chunks) {
      const int t0 = c * kChunk;
      const int pieces = min(kChunk, a.s - t0) * kRowPieces;
#pragma unroll
      for (int arr = 0; arr < 4; ++arr)
        for (int i = threadIdx.x; i < pieces; i += kThreads) {
          const int t = i / kRowPieces, e = (i % kRowPieces) * kRowT;
          cp_async16(&rows[c & 1][arr][t][e],
                     src[arr] + (t0 + t) * sstep[arr] + e, 16);
        }
    }
    cp_async_commit();
  };
  stage(0);

  // k index of this thread's i-th k-row: kVw consecutive k a group
  auto kidx = [&](int i) { return kVw * (part + kKs * (i / kVw)) + i % kVw; };
  float st[kPer], uu[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    st[i] = a.s0[sbase + kidx(i) * D + col];
    uu[i] = a.u[h * D + kidx(i)];
  }

  for (int c = 0; c < n_chunks; ++c) {
    // buffer (c + 1) & 1 was read in chunk c - 1, before the barrier that
    // ended it
    stage(c + 1);
    cp_async_wait<1>();               // this thread's copies of chunk c
    __syncthreads();                  // everyone's
    const int t0 = c * kChunk;
    const int steps = min(kChunk, a.s - t0);
    const T (*buf)[kChunk][D] = rows[c & 1];
#pragma unroll 2
    for (int t = 0; t < steps; ++t) {
      if constexpr (kCkpt) {
        if ((t0 + t) % kPiece == 0) {   // the state after t0 + t steps
          float* out = ck + (t0 + t) / kPiece * D * D;
#pragma unroll
          for (int i = 0; i < kPer; ++i) out[kidx(i) * D + col] = st[i];
        }
      }
      const float v = to_float(buf[3][t][col]);
      float y4[kVw];
#pragma unroll
      for (int j = 0; j < kVw; ++j) y4[j] = 0.f;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int k0 = kVw * (part + kKs * gi);
        float r[kVw], kk[kVw], w[kVw];
        load_n<kVw>(&buf[0][t][k0], r);
        load_n<kVw>(&buf[1][t][k0], kk);
        load_n<kVw>(&buf[2][t][k0], w);
#pragma unroll
        for (int j = 0; j < kVw; ++j) {
          const int i = gi * kVw + j;
          const float kv = kk[j] * v;
          y4[j] = fmaf(r[j], fmaf(uu[i], kv, st[i]), y4[j]);
          st[i] = fmaf(w[j], st[i], kv);
        }
      }
      float y = y4[0];
#pragma unroll
      for (int j = 1; j < kVw; ++j) y += y4[j];
      ypart[t][threadIdx.x] = y;      // thread = part * D + col
    }
    __syncthreads();                  // chunk c's buffer is free
    // y of the chunk: the kKs partial sums of each (step, column), written
    // a row of D at a time
    for (int i = threadIdx.x; i < steps * D; i += kThreads) {
      const int t = i / D, j = i % D;
      float y = 0.f;
#pragma unroll
      for (int p = 0; p < kKs; ++p) y += ypart[t][p * D + j];
      yp[(t0 + t) * a.ys[2] + j] = from_float<T>(y);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) a.s_last[sbase + kidx(i) * D + col] = st[i];
}

template <typename T, int D, int kChunk, bool kCkpt>
cudaError_t launch_chunk(const Args& a, int b, int h, cudaStream_t stream) {
  constexpr int smem = (2 * 4 * D * sizeof(T) + kThreads * 4) * kChunk;
  auto kernel = rwkv6_scan_kernel<T, D, kChunk, kCkpt>;
  {  // state of the current device: set on every call, on every card
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the decode step (S = 1) stages one step: 3 KB of shared memory, not 192
template <typename T, int D, bool kCkpt>
cudaError_t launch_ckpt(const Args& a, int b, int h, cudaStream_t stream) {
  return a.s == 1 ? launch_chunk<T, D, 1, kCkpt>(a, b, h, stream)
                  : launch_chunk<T, D, kChunkSteps, kCkpt>(a, b, h, stream);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int h, cudaStream_t stream) {
  return a.ckpt ? launch_ckpt<T, D, true>(a, b, h, stream)
                : launch_ckpt<T, D, false>(a, b, h, stream);
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

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y; u, s0, s_last and
// ckpt are fp32).  strides: 15 element strides, the (batch, head, seq)
// strides of r, k, v, w and y in that order; r/k/v/w's base pointers and
// strides 16-byte aligned (the caller checks).  ckpt: null, or (B, H,
// ceil(S / 8), D, D) contiguous, which receives the state at the start of
// every 8-step piece.  Returns the launch's cudaError_t (0 on success);
// the caller raises on anything else.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              void* y, float* s_last, float* ckpt, int dtype,
                              int b, int h, int s, int d,
                              const long long* strides, void* stream) {
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_last = s_last;
  a.ckpt = ckpt;
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

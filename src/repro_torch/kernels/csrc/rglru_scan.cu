// RG-LRU linear recurrence h_t = a_t * h_{t-1} + g_t (diagonal, per
// channel) for sm_90a: S staged in pieces through shared memory, several
// pieces in flight a block, each walked in order.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (`rglru_scan`,
// its pl.pallas_call at line 56): the same function.
//   a, g (B, S, R), h0 (B, R) fp32 -> y (B, S, R) in a's dtype (y_t = h_t),
//   h_last (B, R) fp32; the carry is fp32 whatever the input type.
// Unlike the Pallas kernel it takes any S (no S % chunk requirement).  a
// and g must be contiguous.
//
// Bound at the model's shape (B=2, S=1024, R=4096, fp32): a, g and y are
// 33.6 MB each, 100.7 MB -> 30 us at 3.35 TB/s; 2 flops per element (8.4
// MFLOP) are nothing.  So the bound is bytes: every element must be read
// and written once, in whole sectors, with enough bytes in flight on every
// SM to cover the memory's latency.
//
// The Pallas kernel walks S in order on a sequential grid, carrying h in
// VMEM.  One thread per (row, channel) walking S with its loads in
// registers, as the port's first kernel did, has only B * R = 8192 threads
// at the model's shape (64 blocks on 132 SMs) and so about 1 MB in flight
// on the card: it ran at a quarter of the bandwidth.  The FMAs are not the
// cost (S dependent FMAs a channel, a few microseconds at S = 1024): the
// loads are.  So the staged route splits S into pieces that every thread
// of a block loads, and keeps the recurrence's order:
//
// Staged route (S >= 64 in the wrapper's plan): one block of kThreads (256)
// per (tile of kRowBytes (128) of a row = 32 fp32 or 64 bf16 channels,
// batch row): 256 blocks at the model's shape.  The block walks S in
// pieces of kPiece (64) steps; piece p is copied into stage p % kStages of
// shared memory by 16-byte cp.async spread over all the block's threads (a
// tile row is 4 whole 32-byte sectors), and kStages - 1 = 3 pieces of 16 KB
// are in flight while one is scanned.  The first kRowBytes / sizeof(T)
// threads, one a channel, then run the step recurrence over the piece out
// of shared memory (8 steps of a and g read ahead of their FMAs), writing
// y over g's tile; after a barrier the block stores y's tile with 16-byte
// stores.  The carry stays in the scanning thread's register from piece to
// piece, so any S fits one block and no block waits on another.  a and g
// are read from device memory once and y written once.
//
// The FMAs are the step recurrence's, in its order, so the staged route
// and the step route give the same bits, and the kernel agrees with the
// sequential plain version at any decays.  (A three-phase scan -- chunk
// aggregates, composed carry-ins, a rescan -- reassociates the sum: on
// decays of exactly 1 over a long prompt it departed from the sequential
// fp32 sum by several times the check's tolerance, so it was not kept.)
//
// Step route (S < 64, the S = 1 decode step, or rows the 16-byte copies
// cannot take: R * sizeof(T) % 16 != 0): one thread per (row, channel), 128
// threads a block over consecutive channels, loads of kUnroll steps ahead
// of their FMAs; at S = 1 it is one load of a and g and one store a
// channel.  fp32 arithmetic throughout, bf16 widened on load and rounded
// on store.
//
// Checkpoint epilogue (the training forward only: ckpt non-null): the
// kernel also writes the fp32 carry at the start of every piece of
// kCkptPiece (64) steps to ckpt (B, ceil(S / 64), R), piece p the carry
// after 64p steps (h0 for p = 0), for csrc/rglru_scan_bwd.cu to start each
// piece from.  The staged route holds that carry in the scanning thread's
// register at each piece boundary (its pieces are the checkpoints'); the
// step route writes it at each multiple of 64 as it walks.  2.1 MB at
// recurrentgemma-9b's training shape (8, 1024, 4096), beside 403 MB of a, g
// and y.  A serving launch passes null and runs the instantiation without
// the epilogue (kCkpt false), the same code as before it existed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "convert.cuh"

namespace {

constexpr int kStepThreads = 128;
constexpr int kUnroll = 16;           // steps loaded ahead of their FMAs
constexpr int kAhead = 8;             // the staged scan's steps read ahead
constexpr int kCkptPiece = 64;        // steps between checkpoints (ref.py)
static_assert(kCkptPiece % kUnroll == 0, "a checkpoint starts a batch");

template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kStepThreads)
    rglru_step_kernel(const T* __restrict__ a, const T* __restrict__ g,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, float* __restrict__ ckpt,
                      int s, int r) {
  const int c = blockIdx.x * kStepThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= r) return;
  const long long base = static_cast<long long>(b) * s * r + c;
  const int n_ckpt = (s + kCkptPiece - 1) / kCkptPiece;
  float h = h0[static_cast<long long>(b) * r + c];
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    if (kCkpt && t0 % kCkptPiece == 0)
      ckpt[(static_cast<long long>(b) * n_ckpt + t0 / kCkptPiece) * r + c] = h;
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

template <typename T, int kRowBytes, int kPiece, int kStages, int kThreads,
          bool kCkpt>
__global__ void __launch_bounds__(kThreads)
    rglru_staged_kernel(const T* __restrict__ a, const T* __restrict__ g,
                        const float* __restrict__ h0, T* __restrict__ y,
                        float* __restrict__ h_last, float* __restrict__ ckpt,
                        int s, int r) {
  constexpr int kTile = kRowBytes / sizeof(T);       // channels a block
  static_assert(kPiece == kCkptPiece, "a piece is a checkpoint's");
  constexpr int kRowT = 16 / sizeof(T);              // elements a copy
  constexpr int kCopies = kPiece * kRowBytes / 16;   // 16-byte copies a piece
  static_assert(kTile <= kThreads, "one scanning thread a channel");
  // (stage, step, channel) tiles of a and of g; the scan overwrites g's
  // with y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T (*sa)[kPiece][kTile] = reinterpret_cast<T (*)[kPiece][kTile]>(smem_raw);
  T (*sg)[kPiece][kTile] = reinterpret_cast<T (*)[kPiece][kTile]>(
      smem_raw + kStages * kPiece * kRowBytes);
  const int c0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const long long row0 = static_cast<long long>(b) * s * r + c0;
  const T* ap = a + row0;                            // step t at ap + t * r
  const T* gp = g + row0;
  T* yp = y + row0;
  const int n_pieces = (s + kPiece - 1) / kPiece;

  // piece p -> stage p % kStages; steps past S and channels past R are
  // zero-filled (R is a multiple of kRowT, so a copy is all in or all out)
  auto stage = [&](int p) {
    if (p < n_pieces) {
      const int t0 = p * kPiece;
      const int slot = p % kStages;
      for (int i = threadIdx.x; i < kCopies; i += kThreads) {
        const int t = i / (kRowBytes / 16);
        const int e = i % (kRowBytes / 16) * kRowT;
        const bool ok = t0 + t < s && c0 + e < r;
        const long long off = ok ? (t0 + t) * static_cast<long long>(r) + e
                                 : 0;
        cp_async16(&sa[slot][t][e], ap + off, ok ? 16 : 0);
        cp_async16(&sg[slot][t][e], gp + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int c = threadIdx.x;                         // scanning thread
  const bool scans = c < kTile && c0 + c < r;
  float h = scans ? h0[static_cast<long long>(b) * r + c0 + c] : 0.f;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) stage(p);

  for (int p = 0; p < n_pieces; ++p) {
    cp_async_wait<kStages - 2>();                    // this thread's piece p
    __syncthreads();    // everyone's; and piece p - 1's stage is free
    stage(p + kStages - 1);
    const int slot = p % kStages;
    const int t0 = p * kPiece;
    const int steps = min(kPiece, s - t0);
    if (kCkpt && scans)                              // the carry after t0
      ckpt[(static_cast<long long>(b) * n_pieces + p) * r + c0 + c] = h;
    if (scans) {
      // the step recurrence in order, the step route's FMAs: kAhead steps'
      // a and g read from shared memory before their FMAs
      int t = 0;
      for (; t + kAhead <= steps; t += kAhead) {
        float av[kAhead], gv[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          av[u] = to_float(sa[slot][t + u][c]);
          gv[u] = to_float(sg[slot][t + u][c]);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          h = fmaf(av[u], h, gv[u]);
          sg[slot][t + u][c] = from_float<T>(h);
        }
      }
      for (; t < steps; ++t) {
        h = fmaf(to_float(sa[slot][t][c]), h, to_float(sg[slot][t][c]));
        sg[slot][t][c] = from_float<T>(h);
      }
    }
    __syncthreads();                                 // y of piece p staged
    for (int i = threadIdx.x; i < steps * (kRowBytes / 16); i += kThreads) {
      const int t = i / (kRowBytes / 16);
      const int e = i % (kRowBytes / 16) * kRowT;
      if (c0 + e < r)
        *reinterpret_cast<uint4*>(yp + (t0 + t) * static_cast<long long>(r) +
                                  e) =
            *reinterpret_cast<const uint4*>(&sg[slot][t][e]);
    }
  }
  if (scans) h_last[static_cast<long long>(b) * r + c0 + c] = h;
}

struct Io {
  const void* a;
  const void* g;
  const float* h0;
  void* y;
  float* h_last;
  float* ckpt;                        // null: no checkpoint epilogue
  int b, s, r;
};

template <typename T, bool kCkpt>
cudaError_t launch_step(const Io& io, cudaStream_t stream) {
  const dim3 grid((io.r + kStepThreads - 1) / kStepThreads, io.b);
  rglru_step_kernel<T, kCkpt><<<grid, kStepThreads, 0, stream>>>(
      static_cast<const T*>(io.a), static_cast<const T*>(io.g), io.h0,
      static_cast<T*>(io.y), io.h_last, io.ckpt, io.s, io.r);
  return cudaGetLastError();
}

template <typename T, int kRowBytes, int kPiece, int kStages, int kThreads,
          bool kCkpt>
cudaError_t launch_staged(const Io& io, cudaStream_t stream) {
  constexpr int smem = 2 * kStages * kPiece * kRowBytes;
  constexpr int tile = kRowBytes / sizeof(T);
  auto kernel =
      rglru_staged_kernel<T, kRowBytes, kPiece, kStages, kThreads, kCkpt>;
  {  // state of the current device: set on every call, on every card
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((io.r + tile - 1) / tile, io.b), kThreads, smem, stream>>>(
      static_cast<const T*>(io.a), static_cast<const T*>(io.g), io.h0,
      static_cast<T*>(io.y), io.h_last, io.ckpt, io.s, io.r);
  return cudaGetLastError();
}

// the staged instantiation the wrapper's plan names: (bytes of a row of the
// tile, steps a piece, stages, threads)
template <typename T, bool kCkpt>
cudaError_t launch_plan(const Io& io, int row_bytes, int piece, int stages,
                        int threads, cudaStream_t stream) {
  if (piece == 0) return launch_step<T, kCkpt>(io, stream);
#define RGLRU_PLAN(RB, PC, ST, TH)                                       \
  if (row_bytes == RB && piece == PC && stages == ST && threads == TH)   \
    return launch_staged<T, RB, PC, ST, TH, kCkpt>(io, stream);
  RGLRU_PLAN(128, 64, 4, 256)
#undef RGLRU_PLAN
  return cudaErrorInvalidValue;
}

// the instantiation with the checkpoint epilogue where io.ckpt is given
template <typename T>
cudaError_t launch(const Io& io, int row_bytes, int piece, int stages,
                   int threads, cudaStream_t stream) {
  return io.ckpt ? launch_plan<T, true>(io, row_bytes, piece, stages,
                                        threads, stream)
                 : launch_plan<T, false>(io, row_bytes, piece, stages,
                                         threads, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, g and y; h0, h_last and ckpt are
// fp32).  ckpt: null, or (B, ceil(S / 64), R) for the checkpoint epilogue.
// piece 0: the step route; else the staged route of (row_bytes, piece,
// stages, threads), the instantiation above, which needs a, g and
// y 16-byte aligned and R * sizeof(T) a multiple of 16 (the caller checks).
// Every array is contiguous.  One launch; returns its cudaError_t (0 on
// success, cudaErrorInvalidValue for a plan not instantiated); the caller
// raises on anything else.
extern "C" int rglru_scan_fwd(const void* a, const void* g, const float* h0,
                              void* y, float* h_last, float* ckpt,
                              int dtype, int b, int s, int r, int row_bytes,
                              int piece, int stages, int threads,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Io io{a, g, h0, y, h_last, ckpt, b, s, r};
  cudaError_t err =
      dtype == 0 ? launch<float>(io, row_bytes, piece, stages, threads, st)
      : dtype == 1
          ? launch<__nv_bfloat16>(io, row_bytes, piece, stages, threads, st)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

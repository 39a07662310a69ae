// The gradient of the RG-LRU recurrence h_t = a_t h_{t-1} + g_t
// (csrc/rglru_scan.cu) with respect to a, g and h0, for sm_90a.
//
// The TPU kernel src/repro/kernels/rglru_scan.py (`rglru_scan`, its
// pl.pallas_call at line 56) has no backward: the reference differentiates
// its jnp recurrence.  This kernel computes that gradient, the reverse
// recurrence of kernels/ref.py `rglru_scan_bwd_ref`, per channel:
//   G_t  = dy_t + a_{t+1} G_{t+1},   G_{S-1} = dy_{S-1} + dh_last
//   dg_t = G_t,   da_t = G_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 G_0
// a, g, dy (B, S, R) fp32 or bf16 (one dtype), the checkpoints ckpt (B,
// ceil(S / 64), R) fp32 that the forward kernel's epilogue writes (piece p:
// the carry after 64p steps, piece 0 = h0) and dh_last (B, R) fp32 -> da, dg
// (B, S, R) in a's dtype, dh0 (B, R) fp32.  Every array contiguous; any S
// and R.
//
// Bound at recurrentgemma-9b's training shape (B 8, S 1024, R 4096): a, g
// and dy read and da and dg written once, 5 rows of 134 MB in fp32 (67 MB
// in bf16), 671 MB -> 0.20 ms at 3.35 TB/s (bf16 0.10 ms); 3 flops per
// element are nothing.  So the bound is bytes.  The carry h_{t-1} is not
// among them: the kernel recomputes it from a and g, which it reads anyway,
// starting each piece of 64 steps from its checkpoint (4 bytes a channel a
// piece, 2.1 MB at that shape).
//
// The kernel this replaces read the carry from the forward's fp32 y (a
// sixth row) or, for bf16, first walked the recurrence into a (B, S, R)
// fp32 scratch and read it back (about 20 bytes an element against the
// floor's 10), one thread per (row, channel) loading 2 or 4 bytes a step:
// bf16 ran at 28.5% of its bound.  The recurrence cannot be reassociated
// into a parallel scan (see csrc/rglru_scan.cu: on decays of exactly 1 a
// three-phase scan departs from the sequential fp32 sum), so the design
// keeps each channel's FMAs sequential and in the forward's order, and
// makes the loads wide instead:
//
// Staged route (rows the 16-byte copies take: R * sizeof(T) % 16 == 0):
// one block of kThreads (256) per (tile of kRowBytes (128) of a row = 32
// fp32 or 64 bf16 channels, batch row), as the forward's staged route:
// 1024 (fp32) or 512 (bf16) blocks at the training shape.  The block walks
// the pieces from the last to the first; piece q's a, g and dy tiles and
// its checkpoint row are copied into stage i % kStages of shared memory by
// 16-byte cp.async spread over all the block's threads, the next piece
// (24 KB) in flight while one is scanned (kStages = 2, two blocks an SM as
// the registers allow: faster on the H100 than 3 or 4 stages, or than
// blocks of 64 or 128 threads).  One scanning thread a channel takes the
// checkpoint, recomputes the piece's 64 carries with fmaf(a_t, h, g_t)
// into registers (the forward's FMAs in its order, so the carries are the
// forward's bits), then walks the piece backwards: G += dy,
// dg = G, da = G h_{t-1}, G *= a (each rounded on its own, no contraction),
// writing da over a's tile and dg over dy's.  After a barrier the block
// stores both tiles with 16-byte stores.  dh0 is G after piece 0.  a, g and
// dy are read once, da and dg written once, the checkpoints read once.
//
// Step route (rows off 16 bytes): one thread per (row, channel), 128 a
// block over consecutive channels, the same pieces from the last: a piece's
// a and g loaded into registers, its carries recomputed from the checkpoint
// with the same FMAs, then the backward walk with dy loaded kUnroll steps
// ahead.  The two routes give equal bits.  fp32 arithmetic throughout, bf16
// widened on load and rounded on store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "convert.cuh"

namespace {

constexpr int kPiece = 64;            // steps between checkpoints (ref.py)
constexpr int kStepThreads = 128;
constexpr int kUnroll = 16;           // the step route's dy loaded ahead

// one step of the backward walk: G += dy_t; dg_t = G; da_t = G h_{t-1};
// G *= a_t (explicit roundings, so neither route contracts them)
__device__ __forceinline__ void bwd_step(float& grad, float at, float dyt,
                                         float hprev, float& dgt,
                                         float& dat) {
  grad = __fadd_rn(grad, dyt);
  dgt = grad;
  dat = __fmul_rn(grad, hprev);
  grad = __fmul_rn(at, grad);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
    rglru_bwd_step_kernel(const T* __restrict__ a, const T* __restrict__ g,
                          const float* __restrict__ ckpt,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          T* __restrict__ da, T* __restrict__ dg,
                          float* __restrict__ dh0, int s, int r) {
  const int c = blockIdx.x * kStepThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= r) return;
  const long long base = static_cast<long long>(b) * s * r + c;
  const int n_pieces = (s + kPiece - 1) / kPiece;
  float grad = dh_last ? dh_last[static_cast<long long>(b) * r + c] : 0.f;
  for (int q = n_pieces - 1; q >= 0; --q) {
    const int t0 = q * kPiece;
    const int steps = min(kPiece, s - t0);
    const long long p0 = base + static_cast<long long>(t0) * r;
    float av[kPiece], hv[kPiece];     // a_t; g_t, then h_{t-1}
#pragma unroll
    for (int t = 0; t < kPiece; ++t) {
      const bool ok = t < steps;
      av[t] = ok ? to_float(a[p0 + static_cast<long long>(t) * r]) : 0.f;
      hv[t] = ok ? to_float(g[p0 + static_cast<long long>(t) * r]) : 0.f;
    }
    float h = ckpt[(static_cast<long long>(b) * n_pieces + q) * r + c];
#pragma unroll
    for (int t = 0; t < kPiece; ++t) {
      if (t < steps) {
        const float gt = hv[t];
        hv[t] = h;
        h = fmaf(av[t], h, gt);
      }
    }
#pragma unroll
    for (int t1 = kPiece - 1; t1 >= 0; t1 -= kUnroll) {
      float dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t1 - u;
        dv[u] = t < steps ? to_float(dy[p0 + static_cast<long long>(t) * r])
                          : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t1 - u;
        if (t < steps) {
          float dgt, dat;
          bwd_step(grad, av[t], dv[u], hv[t], dgt, dat);
          const long long i = p0 + static_cast<long long>(t) * r;
          dg[i] = from_float<T>(dgt);
          da[i] = from_float<T>(dat);
        }
      }
    }
  }
  dh0[static_cast<long long>(b) * r + c] = grad;
}

template <typename T, int kRowBytes, int kStages, int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
    rglru_bwd_staged_kernel(const T* __restrict__ a, const T* __restrict__ g,
                            const float* __restrict__ ckpt,
                            const T* __restrict__ dy,
                            const float* __restrict__ dh_last,
                            T* __restrict__ da, T* __restrict__ dg,
                            float* __restrict__ dh0, int s, int r) {
  constexpr int kTile = kRowBytes / sizeof(T);       // channels a block
  constexpr int kRowT = 16 / sizeof(T);              // elements a copy
  constexpr int kChunks = kRowBytes / 16;            // copies a tile row
  constexpr int kCkptCopies = kTile * 4 / 16;        // copies a checkpoint
  static_assert(kTile <= kThreads, "one scanning thread a channel");
  // (stage, step, channel) tiles of a, g and dy, then (stage, channel)
  // checkpoint rows; the walk overwrites a's tile with da and dy's with dg
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTileBytes = kStages * kPiece * kRowBytes;
  T (*sa)[kPiece][kTile] = reinterpret_cast<T (*)[kPiece][kTile]>(smem_raw);
  T (*sg)[kPiece][kTile] =
      reinterpret_cast<T (*)[kPiece][kTile]>(smem_raw + kTileBytes);
  T (*sd)[kPiece][kTile] =
      reinterpret_cast<T (*)[kPiece][kTile]>(smem_raw + 2 * kTileBytes);
  float (*sh)[kTile] =
      reinterpret_cast<float (*)[kTile]>(smem_raw + 3 * kTileBytes);
  const int c0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const long long row0 = static_cast<long long>(b) * s * r + c0;
  const int n_pieces = (s + kPiece - 1) / kPiece;
  const float* hp = ckpt + static_cast<long long>(b) * n_pieces * r + c0;

  // walk step i takes piece n_pieces - 1 - i into stage i % kStages; steps
  // past S and channels past R are zero-filled (R is a multiple of kRowT and
  // of 4, so a copy is all in or all out)
  auto stage = [&](int i) {
    if (i < n_pieces) {
      const int q = n_pieces - 1 - i;
      const int t0 = q * kPiece;
      const int slot = i % kStages;
      for (int k = threadIdx.x; k < kPiece * kChunks; k += kThreads) {
        const int t = k / kChunks;
        const int e = k % kChunks * kRowT;
        const bool ok = t0 + t < s && c0 + e < r;
        const long long off =
            row0 + (ok ? (t0 + t) * static_cast<long long>(r) + e : 0);
        cp_async16(&sa[slot][t][e], a + off, ok ? 16 : 0);
        cp_async16(&sg[slot][t][e], g + off, ok ? 16 : 0);
        cp_async16(&sd[slot][t][e], dy + off, ok ? 16 : 0);
      }
      for (int k = threadIdx.x; k < kCkptCopies; k += kThreads) {
        const bool ok = c0 + 4 * k < r;
        cp_async16(&sh[slot][4 * k],
                   hp + (ok ? q * static_cast<long long>(r) + 4 * k : 0),
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int c = threadIdx.x;                         // scanning thread
  const bool scans = c < kTile && c0 + c < r;
  float grad = scans && dh_last
                   ? dh_last[static_cast<long long>(b) * r + c0 + c]
                   : 0.f;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  for (int i = 0; i < n_pieces; ++i) {
    cp_async_wait<kStages - 2>();                    // this thread's piece
    __syncthreads();    // everyone's; and the last piece's stage is free
    stage(i + kStages - 1);
    const int slot = i % kStages;
    const int t0 = (n_pieces - 1 - i) * kPiece;
    const int steps = min(kPiece, s - t0);
    if (scans) {
      float hv[kPiece];                              // h_{t-1}
      float h = sh[slot][c];
#pragma unroll
      for (int t = 0; t < kPiece; ++t) {
        if (t < steps) {
          hv[t] = h;
          h = fmaf(to_float(sa[slot][t][c]), h, to_float(sg[slot][t][c]));
        }
      }
#pragma unroll
      for (int t = kPiece - 1; t >= 0; --t) {
        if (t < steps) {
          float dgt, dat;
          bwd_step(grad, to_float(sa[slot][t][c]), to_float(sd[slot][t][c]),
                   hv[t], dgt, dat);
          sd[slot][t][c] = from_float<T>(dgt);
          sa[slot][t][c] = from_float<T>(dat);
        }
      }
    }
    __syncthreads();                                 // da, dg staged
    for (int k = threadIdx.x; k < steps * kChunks; k += kThreads) {
      const int t = k / kChunks;
      const int e = k % kChunks * kRowT;
      if (c0 + e < r) {
        const long long off = row0 + (t0 + t) * static_cast<long long>(r) + e;
        *reinterpret_cast<uint4*>(da + off) =
            *reinterpret_cast<const uint4*>(&sa[slot][t][e]);
        *reinterpret_cast<uint4*>(dg + off) =
            *reinterpret_cast<const uint4*>(&sd[slot][t][e]);
      }
    }
  }
  if (scans) dh0[static_cast<long long>(b) * r + c0 + c] = grad;
}

struct Io {
  const void* a;
  const void* g;
  const float* ckpt;
  const void* dy;
  const float* dh_last;
  void* da;
  void* dg;
  float* dh0;
  int b, s, r;
};

template <typename T>
cudaError_t launch_step(const Io& io, cudaStream_t stream) {
  const dim3 grid((io.r + kStepThreads - 1) / kStepThreads, io.b);
  rglru_bwd_step_kernel<T><<<grid, kStepThreads, 0, stream>>>(
      static_cast<const T*>(io.a), static_cast<const T*>(io.g), io.ckpt,
      static_cast<const T*>(io.dy), io.dh_last, static_cast<T*>(io.da),
      static_cast<T*>(io.dg), io.dh0, io.s, io.r);
  return cudaGetLastError();
}

template <typename T, int kRowBytes, int kStages, int kThreads>
cudaError_t launch_staged(const Io& io, cudaStream_t stream) {
  constexpr int tile = kRowBytes / sizeof(T);
  constexpr int smem = kStages * (3 * kPiece * kRowBytes + tile * 4);
  auto kernel = rglru_bwd_staged_kernel<T, kRowBytes, kStages, kThreads>;
  {  // state of the current device: set on every call, on every card
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((io.r + tile - 1) / tile, io.b), kThreads, smem, stream>>>(
      static_cast<const T*>(io.a), static_cast<const T*>(io.g), io.ckpt,
      static_cast<const T*>(io.dy), io.dh_last, static_cast<T*>(io.da),
      static_cast<T*>(io.dg), io.dh0, io.s, io.r);
  return cudaGetLastError();
}

// the staged instantiation the wrapper's plan names: (bytes of a row of the
// tile, steps a piece, stages, threads)
template <typename T>
cudaError_t launch(const Io& io, int row_bytes, int piece, int stages,
                   int threads, cudaStream_t stream) {
  if (piece == 0) return launch_step<T>(io, stream);
#define RGLRU_BWD_PLAN(RB, ST, TH)                                         \
  if (row_bytes == RB && piece == kPiece && stages == ST && threads == TH) \
    return launch_staged<T, RB, ST, TH>(io, stream);
  RGLRU_BWD_PLAN(128, 2, 256)
#undef RGLRU_BWD_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, g, dy, da and dg; ckpt, dh_last and
// dh0 are fp32).  ckpt: the (B, ceil(S / 64), R) checkpoints of the
// forward's epilogue.  dh_last may be null (a zero gradient).  piece 0: the
// step route; else the staged route of (row_bytes, piece, stages,
// threads), the instantiation above, which needs a, g, dy, da, dg and ckpt
// 16-byte aligned and R * sizeof(T) a multiple of 16 (the caller checks).
// Every array contiguous.  One launch; returns its cudaError_t (0 on
// success, cudaErrorInvalidValue for a plan not instantiated); the caller
// raises on anything else.
extern "C" int rglru_scan_bwd(const void* a, const void* g, const float* ckpt,
                              const void* dy, const float* dh_last, void* da,
                              void* dg, float* dh0, int dtype, int b, int s,
                              int r, int row_bytes, int piece, int stages,
                              int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Io io{a, g, ckpt, dy, dh_last, da, dg, dh0, b, s, r};
  cudaError_t err =
      dtype == 0
          ? launch<float>(io, row_bytes, piece, stages, threads, st)
      : dtype == 1
          ? launch<__nv_bfloat16>(io, row_bytes, piece, stages, threads, st)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The gradient of the RWKV6 WKV recurrence (csrc/rwkv6_scan.cu) with
// respect to r, k, v, w, u and s0, for sm_90a.
//
// The TPU kernel src/repro/kernels/rwkv6_scan.py (`rwkv6_scan`, its
// pl.pallas_call at line 63) has no backward: the reference differentiates
// its jnp recurrence.  This kernel computes that gradient, the reverse
// recurrence of kernels/ref.py `rwkv6_scan_bwd_ref`.  Per (batch, head),
// with S_t the state after step t (S_{-1} = s0), G_t = dL/dS_t (G_{S-1} =
// ds_last, or 0) and K == V == D:
//   dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
//   dk_t = G_t v_t + (r_t * u)(v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
//   dw_t = rowsum(G_t * S_{t-1})
//   du   = sum over (batch, time) of r_t * k_t (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_{-1}
// r/k/v/w/dy (B, H, S, D) fp32 or bf16 (one dtype) with element strides
// for the batch, head and sequence axes (rows 16-byte aligned), u (H, D),
// s0 and ds_last (B, H, D, D) fp32 -> dr/dk/dv/dw in the inputs' dtype
// with their own strides, du (H, D) and ds0 (B, H, D, D) fp32.  Any S.
//
// S_{t-1} and G_t are needed at the same step, one walked forward and one
// backward.  Going back from S_t to S_{t-1} would divide by w_t, and decays
// of 0 and 1 are legal (w 1e-30 underflows the quotient), so nothing here
// divides: the kernel recomputes S in pieces of kSub (8) steps.  Phase 1
// walks the forward recurrence (the forward kernel's FMAs) and writes the
// state at the start of every piece to a scratch buffer (B, H, ceil(S/8),
// D, D) fp32.  Phase 2 walks the pieces in reverse: it loads a piece's
// start, recomputes its kSub states into shared memory, then walks the
// piece's steps backwards with G in registers.
//
// Bound at rwkv6-1.6b's training shape (B 8, H 32, S 1024, D 64, fp32):
// r/k/v/w/dy read and dr/dk/dv/dw written once, 9 x 67.1 MB, plus s0 and
// ds0, 612 MB -> 0.18 ms at 3.35 TB/s; about 8 operations per state
// element per step, 8.6 GFLOP -> 0.13 ms at the 67 TFLOP/s fp32 CUDA-core
// peak.  So the bound is bytes; what sets the time is the walk over S
// dependent steps (three times: phase 1, the recompute, the reverse walk)
// and the checkpoints' 537 MB written and read once.
//
// Design: one block of 256 threads per (head, batch row), grid (H, B).
// Thread (row k, part q), k = tid / (256 / D), holds the D^2 / 256 columns
// v = 4 (256 / D) m + 4 q + c of row k of S and of G in registers (16 at
// D 64), so the reductions over v (dr, dk, dw) are a thread's own FMAs
// and a shuffle over the 256 / D threads of the row, and the reduction
// over k (dv) a reduce-scatter over the warp's rows by shuffles, then a
// fixed-order sum over the 8 warps through shared memory after each
// piece.  A piece's rows (r, k, v, w, dy) and its start state are copied
// by 16-byte cp.async, double-buffered: piece p - 1 is in flight while p
// is walked.  The recomputed states sit in shared memory thread by thread
// (each thread reads back only its own), 128 KB at D 64.  du: each (b, h)
// block writes its partial sum over time; a second launch sums the batch
// rows in order.  No atomics, so the gradients are equal bit for bit from
// call to call.  fp32 arithmetic throughout, bf16 widened on load and
// rounded on store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;               // steps a piece (checkpoint interval)
static_assert(kSub <= kWarps, "one warp a step for the per-step scalars");

struct Args {
  const void* x[5];                   // r, k, v, w, dy
  const float* u;                     // (H, D) contiguous
  const float* s0;                    // (B, H, D, D) contiguous
  const float* ds_last;               // (B, H, D, D) contiguous, or null
  void* dx[4];                        // dr, dk, dv, dw
  float* du_part;                     // (B, H, D)
  float* ds0;                         // (B, H, D, D)
  float* ckpt;                        // (B, H, pieces, D * D)
  int s;
  long long xs[5][3];                 // (batch, head, seq) strides
  long long ds[4][3];
};

enum { kR = 0, kK = 1, kV = 2, kW = 3, kDy = 4 };

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

// Sum of x over the lanes that differ in the bits of [STOP, MASK]
template <int MASK, int STOP>
__device__ __forceinline__ float lane_sum(float x) {
  if constexpr (MASK >= STOP) {
    x += __shfl_xor_sync(0xffffffffu, x, MASK);
    return lane_sum<MASK / 2, STOP>(x);
  }
  return x;
}

// Reduce-scatter of vals[0, N) over the lanes that differ in the bits of
// [STOP, MASK]: at each bit a lane keeps half of its values (the upper
// half where the bit is set) plus its partner's same half, until one value
// is left; below that the lanes add.  vals[0, N >> levels) then hold sums
// over all those lanes, of the indices from scatter_offset.
template <int N, int MASK, int STOP>
__device__ __forceinline__ void reduce_scatter(float* vals, int lane) {
  if constexpr (MASK >= STOP) {
    if constexpr (N >= 2) {
      const bool upper = lane & MASK;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? vals[i] : vals[i + N / 2];
        const float keep = upper ? vals[i + N / 2] : vals[i];
        vals[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      reduce_scatter<N / 2, MASK / 2, STOP>(vals, lane);
    } else {
      vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], MASK);
      reduce_scatter<1, MASK / 2, STOP>(vals, lane);
    }
  }
}

template <int N, int MASK, int STOP>
__device__ __forceinline__ int scatter_offset(int lane) {
  if constexpr (MASK >= STOP && N >= 2) {
    return ((lane & MASK) ? N / 2 : 0) +
           scatter_offset<N / 2, MASK / 2, STOP>(lane);
  }
  return 0;
}

template <typename T, int D>
struct Layout {
  static constexpr int kTpr = kThreads / D;          // threads a row
  static constexpr int kCpt = D / kTpr;              // columns a thread
  static constexpr int kVw = kCpt < 4 ? kCpt : 4;    // consecutive columns
  static constexpr int kRpw = 32 / kTpr;             // rows a warp
  // lane sums left after the reduce-scatter over a warp's rows
  static constexpr int kLeft = kCpt >= kRpw ? kCpt / kRpw : 1;
  static constexpr int kRowPieces = D * sizeof(T) / 16;
  // shared memory: states [kSub][kCpt][kThreads] f32, two slots of rows
  // [5][kSub][D] T and a start state [D * D] f32, dv partials
  // [kSub][kWarps][D] f32, per-step scalars [2][kSub] f32
  static constexpr int kStates = kSub * D * D * 4;
  static constexpr int kRows = 5 * kSub * D * sizeof(T);
  static constexpr int kSlot = kRows + D * D * 4;
  static constexpr int kDvp = kSub * kWarps * D * 4;
  static constexpr int kSmem = kStates + 2 * kSlot + kDvp + 2 * kSub * 4;
  static_assert(kCpt % kVw == 0 && kRowPieces >= 1, "whole pieces");
  static_assert(kSmem <= 232448, "shared memory of one block");
  // column of a thread's j-th value
  __device__ static int col(int q, int j) {
    return kVw * kTpr * (j / kVw) + kVw * q + j % kVw;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) rwkv6_bwd_kernel(Args a) {
  using L = Layout<T, D>;
  constexpr int kCpt = L::kCpt, kVw = L::kVw, kTpr = L::kTpr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* states = reinterpret_cast<float*>(smem_raw);
  unsigned char* slots = smem_raw + L::kStates;
  float (*dvp)[kWarps][D] = reinterpret_cast<float (*)[kWarps][D]>(
      slots + 2 * L::kSlot);
  float (*scal)[kSub] = reinterpret_cast<float (*)[kSub]>(
      slots + 2 * L::kSlot + L::kDvp);
  auto rows = [&](int slot) {
    return reinterpret_cast<T (*)[kSub][D]>(slots + slot * L::kSlot);
  };
  auto start = [&](int slot) {
    return reinterpret_cast<float*>(slots + slot * L::kSlot + L::kRows);
  };

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row = tid / kTpr, q = tid % kTpr;
  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int n_pieces = (a.s + kSub - 1) / kSub;
  const long long bh = static_cast<long long>(b) * nh + h;
  const long long sbase = bh * D * D;
  float* ck = a.ckpt + bh * n_pieces * D * D;
  const T* src[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    src[i] = static_cast<const T*>(a.x[i]) + b * a.xs[i][0] + h * a.xs[i][1];

  // rows [t0, t0 + n) of the arrays in `mask` (and, with `with_start`, the
  // start state of piece p) -> slot, 16 bytes a copy
  constexpr int kRowT = 16 / sizeof(T);
  auto stage = [&](int p, int slot, unsigned mask, bool with_start) {
    if (p >= 0 && p < n_pieces) {
      const int t0 = p * kSub;
      const int n = min(kSub, a.s - t0);
      T (*dst)[kSub][D] = rows(slot);
#pragma unroll
      for (int arr = 0; arr < 5; ++arr) {
        if (!(mask & (1u << arr))) continue;
        for (int i = tid; i < n * L::kRowPieces; i += kThreads) {
          const int t = i / L::kRowPieces, e = (i % L::kRowPieces) * kRowT;
          cp_async16(&dst[arr][t][e], src[arr] + (t0 + t) * a.xs[arr][2] + e,
                     16);
        }
      }
      if (with_start) {
        float* st = start(slot);
        const float* from = ck + static_cast<long long>(p) * D * D;
        for (int i = tid; i < D * D / 4; i += kThreads)
          cp_async16(st + 4 * i, from + 4 * i, 16);
      }
    }
    cp_async_commit();
  };

  // one forward step of this thread's columns: the forward kernel's FMAs
  auto step = [&](float* st, const T (*buf)[kSub][D], int t) {
    const float kk = to_float(buf[kK][t][row]);
    const float ww = to_float(buf[kW][t][row]);
#pragma unroll
    for (int j0 = 0; j0 < kCpt; j0 += kVw) {
      float vv[kVw];
      load_n<kVw>(&buf[kV][t][L::col(q, j0)], vv);
#pragma unroll
      for (int c = 0; c < kVw; ++c)
        st[j0 + c] = fmaf(ww, st[j0 + c], kk * vv[c]);
    }
  };

  // phase 1: the forward recurrence from s0, each piece's start state
  // written to the scratch ([j][tid] order, so the writes coalesce)
  float st[kCpt];
#pragma unroll
  for (int j = 0; j < kCpt; ++j) st[j] = a.s0[sbase + row * D + L::col(q, j)];
  constexpr unsigned kFwdRows = (1u << kK) | (1u << kV) | (1u << kW);
  stage(0, 0, kFwdRows, false);
  for (int p = 0; p < n_pieces; ++p) {
    stage(p + 1, (p + 1) & 1, kFwdRows, false);   // its slot was freed
    cp_async_wait<1>();
    __syncthreads();
    float* out = ck + static_cast<long long>(p) * D * D;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) out[j * kThreads + tid] = st[j];
    if (p + 1 < n_pieces) {           // the last piece's end is not needed
      const int n = min(kSub, a.s - p * kSub);
      for (int t = 0; t < n; ++t) step(st, rows(p & 1), t);
    }
    __syncthreads();                  // slot p & 1 is free
  }
  cp_async_wait<0>();
  __threadfence();                    // the start states, for cp.async
  __syncthreads();

  // phase 2: the pieces in reverse, G in registers
  float g[kCpt];
#pragma unroll
  for (int j = 0; j < kCpt; ++j)
    g[j] = a.ds_last ? a.ds_last[sbase + row * D + L::col(q, j)] : 0.f;
  const float uu = a.u[h * D + row];
  float du = 0.f;
  T* dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = static_cast<T*>(a.dx[i]) + b * a.ds[i][0] + h * a.ds[i][1];
  constexpr unsigned kAllRows = 0x1fu;
  stage(n_pieces - 1, 0, kAllRows, true);
  for (int i = 0; i < n_pieces; ++i) {
    const int p = n_pieces - 1 - i;
    stage(p - 1, (i + 1) & 1, kAllRows, true);    // its slot was freed
    cp_async_wait<1>();
    __syncthreads();
    const T (*buf)[kSub][D] = rows(i & 1);
    const int t0 = p * kSub;
    const int n = min(kSub, a.s - t0);
    // the per-step scalars v_t . dy_t and r_t . (u * k_t), a warp a step
    if (warp < n) {
      float vdy = 0.f, ruk = 0.f;
      for (int e = lane; e < D; e += 32) {
        vdy = fmaf(to_float(buf[kV][warp][e]), to_float(buf[kDy][warp][e]),
                   vdy);
        ruk = fmaf(to_float(buf[kR][warp][e]) * a.u[h * D + e],
                   to_float(buf[kK][warp][e]), ruk);
      }
      vdy = lane_sum<16, 1>(vdy);
      ruk = lane_sum<16, 1>(ruk);
      if (lane == 0) {
        scal[0][warp] = vdy;
        scal[1][warp] = ruk;
      }
    }
    // the piece's states S_{t-1}, from its start, each thread its own
    const float* from = start(i & 1);
#pragma unroll
    for (int j = 0; j < kCpt; ++j) st[j] = from[j * kThreads + tid];
    for (int t = 0; t < n; ++t) {
#pragma unroll
      for (int j = 0; j < kCpt; ++j)
        states[(t * kCpt + j) * kThreads + tid] = st[j];
      if (t + 1 < n) step(st, buf, t);
    }
    __syncthreads();                  // the scalars
    for (int t = n - 1; t >= 0; --t) {
      const float rr = to_float(buf[kR][t][row]);
      const float kk = to_float(buf[kK][t][row]);
      const float ww = to_float(buf[kW][t][row]);
      const float vdy = scal[0][t];
      float dr = 0.f, dk = 0.f, dw = 0.f;
      float dv[kCpt];
#pragma unroll
      for (int j0 = 0; j0 < kCpt; j0 += kVw) {
        float vv[kVw], dy[kVw];
        load_n<kVw>(&buf[kV][t][L::col(q, j0)], vv);
        load_n<kVw>(&buf[kDy][t][L::col(q, j0)], dy);
#pragma unroll
        for (int c = 0; c < kVw; ++c) {
          const int j = j0 + c;
          const float sp = states[(t * kCpt + j) * kThreads + tid];
          dr = fmaf(sp, dy[c], dr);
          dk = fmaf(g[j], vv[c], dk);
          dw = fmaf(g[j], sp, dw);
          dv[j] = g[j] * kk;
          g[j] = fmaf(ww, g[j], rr * dy[c]);       // G_{t-1}
        }
      }
      dr = lane_sum<kTpr / 2, 1>(dr);
      dk = lane_sum<kTpr / 2, 1>(dk);
      dw = lane_sum<kTpr / 2, 1>(dw);
      if (q == 0) {
        const long long tt = t0 + t;
        dst[kR][tt * a.ds[kR][2] + row] = from_float<T>(fmaf(uu * kk, vdy,
                                                             dr));
        dst[kK][tt * a.ds[kK][2] + row] = from_float<T>(fmaf(rr * uu, vdy,
                                                             dk));
        dst[kW][tt * a.ds[kW][2] + row] = from_float<T>(dw);
        du = fmaf(rr * kk, vdy, du);
      }
      // dv: the sum over the warp's rows, then the warps' partials below
      reduce_scatter<kCpt, 16, kTpr>(dv, lane);
      const int off = scatter_offset<kCpt, 16, kTpr>(lane);
      if ((lane / kTpr) % (L::kRpw / (kCpt / L::kLeft)) == 0) {
#pragma unroll
        for (int j = 0; j < L::kLeft; ++j) dvp[t][warp][L::col(q, off + j)] =
            dv[j];
      }
    }
    __syncthreads();                  // dv's partials
    for (int e = tid; e < n * D; e += kThreads) {
      const int t = e / D, c = e % D;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += dvp[t][w][c];
      sum = fmaf(scal[1][t], to_float(buf[kDy][t][c]), sum);
      dst[kV][(t0 + t) * a.ds[kV][2] + c] = from_float<T>(sum);
    }
    __syncthreads();                  // slot i & 1, dvp and scal are free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < kCpt; ++j) a.ds0[sbase + row * D + L::col(q, j)] = g[j];
  if (q == 0) a.du_part[bh * D + row] = du;
}

// du[h, k] = sum over batch rows, in order, of du_part[b, h, k]
__global__ void rwkv6_du_kernel(const float* __restrict__ part,
                                float* __restrict__ du, int b, int hd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hd) return;
  float sum = 0.f;
  for (int r = 0; r < b; ++r) sum += part[static_cast<long long>(r) * hd + i];
  du[i] = sum;
}

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int h, cudaStream_t stream) {
  constexpr int smem = Layout<T, D>::kSmem;
  auto kernel = rwkv6_bwd_kernel<T, D>;
  static bool configured = false;     // set once; a repeat is harmless
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(a);
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

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dy and dr, dk, dv, dw; u,
// s0, ds_last, du, ds0 and the scratch are fp32).  strides: 27 element
// strides, the (batch, head, seq) strides of r, k, v, w, dy, dr, dk, dv and
// dw in that order; r/k/v/w/dy's base pointers and strides 16-byte aligned
// (the caller checks).  ds_last may be null (a zero gradient).  du_part is
// (B, H, D) fp32 and ckpt (B, H, ceil(S / 8), D, D) fp32 scratch.  Two
// launches (the gradient, then du's sum over the batch); returns the first
// failing launch's cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u, const float* s0,
                              const void* dy, const float* ds_last, void* dr,
                              void* dk, void* dv, void* dw, float* du_part,
                              float* du, float* ds0, float* ckpt, int dtype,
                              int b, int h, int s, int d,
                              const long long* strides, void* stream) {
  Args a;
  const void* xs[5] = {r, k, v, w, dy};
  void* dxs[4] = {dr, dk, dv, dw};
  for (int i = 0; i < 5; ++i) {
    a.x[i] = xs[i];
    for (int j = 0; j < 3; ++j) a.xs[i][j] = strides[3 * i + j];
  }
  for (int i = 0; i < 4; ++i) {
    a.dx[i] = dxs[i];
    for (int j = 0; j < 3; ++j) a.ds[i][j] = strides[15 + 3 * i + j];
  }
  a.u = u;
  a.s0 = s0;
  a.ds_last = ds_last;
  a.du_part = du_part;
  a.ds0 = ds0;
  a.ckpt = ckpt;
  a.s = s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(a, b, h, d, st)
                    : dtype == 1
                        ? dispatch_d<__nv_bfloat16>(a, b, h, d, st)
                        : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hd = h * d;
  rwkv6_du_kernel<<<(hd + 127) / 128, 128, 0, st>>>(du_part, du, b, hd);
  return static_cast<int>(cudaGetLastError());
}

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
// s0 and ds_last (B, H, D, D) fp32, and the forward's checkpoints: the
// state at the start of every 8-step piece, (B, H, ceil(S/8), D, D) fp32,
// written by the forward kernel's checkpoint epilogue -> dr/dk/dv/dw in the
// inputs' dtype with their own strides, du (H, D) and ds0 (B, H, D, D)
// fp32.  Any S.
//
// S_{t-1} and G_t are needed at the same step, one walked forward and one
// backward.  Going back from S_t to S_{t-1} would divide by w_t, and decays
// of 0 and 1 are legal (w 1e-30 underflows the quotient), so nothing here
// divides: the kernel walks the pieces in reverse, recomputes a piece's
// states from its checkpoint (the forward kernel's FMAs), then walks the
// piece's steps backwards with G.
//
// Bound at rwkv6-1.6b's training shape (B 8, H 32, S 1024, D 64, fp32):
// r/k/v/w/dy read and dr/dk/dv/dw written once, 9 x 67.1 MB, plus s0 and
// ds0, 612 MB -> 0.18 ms at 3.35 TB/s; about 8 operations per state
// element per step, 8.6 GFLOP -> 0.13 ms at the 67 TFLOP/s fp32 CUDA-core
// peak.  So the bound is bytes (the checkpoints, 537 MB read here, are
// the forward's to write).
//
// What held the previous design back: it walked S's 1024
// dependent steps three times (phase 1 replayed the forward to save the
// checkpoints, 537 MB written and read back; phase 2 recomputed each
// piece; then G stepped back), and its grid of (H, B) = 256 blocks of 8
// warps, each with 200 KB of shared memory, put one block on an SM in two
// waves: 8 warps could not hide a dependent chain with shuffle reductions
// every step.  Now:
//   - the forward writes the checkpoints (the remat's second forward runs
//     anyway), so one walk and its 1.07 GB of traffic are gone;
//   - S and G scale rows, so their columns are independent: each
//     (head, row) is split over D / 16 blocks of 16 columns, grid (D / 16,
//     H, B), 1024 blocks at the training shape, each 2D threads: thread
//     (row k, half q) holds 8 columns of row k of S and of G in registers,
//     and a piece's 8 recomputed states too (64 registers), so shared
//     memory holds only the staged rows (73 KB a block at D 64 fp32) and
//     three blocks share an SM;
//   - dr, dk and dw sum over all D columns: a thread's 8 FMAs and one
//     shuffle give its block's 16-column part, and the D / 16 blocks of a
//     (head, row) form a thread block cluster that exchanges the parts
//     through distributed shared memory; block g sums rows [16 g, 16 g +
//     16) over the cluster's parts in rank order (no atomics: equal bits
//     from call to call) and adds the u terms, whose v_t . dy_t is the
//     cluster's sum of each block's 16 columns too.  dv sums over rows: a
//     reduce-scatter over the warp's 16 rows, then a fixed-order sum over
//     the warps.  du: each block its rows' sum over time; a second launch
//     sums the batch rows in order;
//   - no barrier a step: a round of two pieces (16 steps) has the ring's,
//     the cluster's and one for r_t . (u * k_t), which is only added in the
//     combine and so is summed between the cluster barrier's arrive and its
//     wait, while the other blocks catch up.
// A round's rows (r, k, w whole; the block's 16 columns of v and dy) and
// its two checkpoints' 16 columns are copied by 16-byte cp.async,
// double-buffered: round m - 1 is in flight while m is walked.  fp32
// arithmetic throughout, bf16 widened on load and rounded on store.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "convert.cuh"

namespace cg = cooperative_groups;

namespace {

// the two halves of a cluster barrier (release, acquire): work between
// them overlaps the wait for the cluster's other blocks
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kSub = 8;               // steps a piece (the forward's)
constexpr int kPieces = 2;            // pieces a round: one exchange
constexpr int kRound = kPieces * kSub;  // steps a round
constexpr int kCols = 16;             // state columns a block
constexpr int kTpr = 2;               // threads a row
constexpr int kCpt = kCols / kTpr;    // columns a thread
// after dv's reduce-scatter over a warp's rows, lanes that differ only in
// these bits hold the same sums
constexpr int kSameSums = (32 / kCpt - 1) & ~(kTpr - 1);

struct Args {
  const void* x[5];                   // r, k, v, w, dy
  const float* u;                     // (H, D) contiguous
  const float* ckpt;                  // (B, H, pieces, D, D) contiguous
  const float* ds_last;               // (B, H, D, D) contiguous, or null
  void* dx[4];                        // dr, dk, dv, dw
  float* du_part;                     // (B, H, D)
  float* ds0;                         // (B, H, D, D)
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
__device__ __forceinline__ void load_n<8, float>(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
  f[4] = y.x;
  f[5] = y.y;
  f[6] = y.z;
  f[7] = y.w;
}
template <>
__device__ __forceinline__ void load_n<8, __nv_bfloat16>(
    const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
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
// is left; below that the lanes add.  vals[0] then holds a sum over all
// those lanes, of the index scatter_offset.
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

// a round's slot of the staging ring: the full rows of r, k, w, the
// block's 16 columns of v and dy, and its columns of the two pieces'
// checkpoints
template <typename T, int D>
struct Slot {
  T full[3][kRound][D];               // r, k, w
  T own[2][kRound][kCols];            // v, dy
  float ck[kPieces][D][kCols];
};
enum { kFr = 0, kFk = 1, kFw = 2, kOv = 0, kOdy = 1 };

// what the cluster reads of a block after a round: its parts of dr, dk, dw
// (rows) and of v_t . dy_t
template <int D>
struct Parts {
  float x[3][kRound][D];
  float vdy[kRound];
};

template <typename T, int D>
struct Layout {
  static constexpr int kGroups = D / kCols;          // blocks a (head, row)
  static constexpr int kThreads = D * kTpr;
  static constexpr int kWarps = kThreads / 32;       // 32 / kTpr rows each
  static constexpr int kRowPieces = D * sizeof(T) / 16;
  static constexpr int kColPieces = kCols * sizeof(T) / 16;
  // shared memory: two slots, two buffers of parts, dv partials
  // [kRound][kWarps][kCols] f32, r_t . (u * k_t) [kRound] f32 and du's
  // partials [kThreads] f32
  static constexpr int kSlot = sizeof(Slot<T, D>);
  static constexpr int kPart = sizeof(Parts<D>);
  static constexpr int kDvp = kRound * kWarps * kCols * 4;
  static constexpr int kSmem =
      2 * kSlot + 2 * kPart + kDvp + kRound * 4 + kThreads * 4;
  static_assert(D % kCols == 0 && kWarps >= 1 && kColPieces >= 1,
                "whole warps and 16-byte pieces");
  static_assert(kSlot % 16 == 0 && kPart % 16 == 0, "16-byte copies");
  static_assert(kThreads % kCols == 0, "the combine's threads");
};

template <typename T, int D>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
    rwkv6_bwd_kernel(Args a) {
  using L = Layout<T, D>;
  using S = Slot<T, D>;
  constexpr int kThreads = L::kThreads, kWarps = L::kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* slots = reinterpret_cast<S*>(smem_raw);
  Parts<D>* parts = reinterpret_cast<Parts<D>*>(smem_raw + 2 * L::kSlot);
  float (*dvp)[kWarps][kCols] = reinterpret_cast<float (*)[kWarps][kCols]>(
      smem_raw + 2 * L::kSlot + 2 * L::kPart);
  float* ruk = reinterpret_cast<float*>(smem_raw + 2 * L::kSlot +
                                        2 * L::kPart + L::kDvp);
  float* du_red = ruk + kRound;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row = tid / kTpr, q = tid % kTpr;
  const int grp = blockIdx.x;         // columns [16 grp, 16 grp + 16)
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int c0 = q * kCpt;            // this thread's first column (block)
  const int col0 = grp * kCols + c0;  // ... of the state
  const int n_pieces = (a.s + kSub - 1) / kSub;
  const int n_rounds = (a.s + kRound - 1) / kRound;
  const long long bh = static_cast<long long>(b) * nh + h;
  const long long sbase = bh * D * D;
  const float* ck = a.ckpt + bh * n_pieces * D * D;
  const T* src[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    src[i] = static_cast<const T*>(a.x[i]) + b * a.xs[i][0] + h * a.xs[i][1];
  T* dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = static_cast<T*>(a.dx[i]) + b * a.ds[i][0] + h * a.ds[i][1];

  // round m's rows and checkpoint columns -> slot, 16 bytes a copy
  constexpr int kRowT = 16 / sizeof(T);
  auto stage = [&](int m, int slot) {
    if (m >= 0) {
      const int t0 = m * kRound;
      const int n = min(kRound, a.s - t0);
      S* to = &slots[slot];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int x = f == kFr ? kR : f == kFk ? kK : kW;
        for (int i = tid; i < n * L::kRowPieces; i += kThreads) {
          const int t = i / L::kRowPieces, e = (i % L::kRowPieces) * kRowT;
          cp_async16(&to->full[f][t][e], src[x] + (t0 + t) * a.xs[x][2] + e,
                     16);
        }
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int x = o == kOv ? kV : kDy;
        for (int i = tid; i < n * L::kColPieces; i += kThreads) {
          const int t = i / L::kColPieces, e = (i % L::kColPieces) * kRowT;
          cp_async16(&to->own[o][t][e],
                     src[x] + (t0 + t) * a.xs[x][2] + grp * kCols + e, 16);
        }
      }
      const int np = min(kPieces, n_pieces - kPieces * m);
      constexpr int kCk = D * kCols / 4;          // copies a checkpoint
      for (int i = tid; i < np * kCk; i += kThreads) {
        const int pc = i / kCk, r = i % kCk / (kCols / 4);
        const int e = i % (kCols / 4) * 4;
        cp_async16(&to->ck[pc][r][e],
                   ck + static_cast<long long>(kPieces * m + pc) * D * D +
                       r * D +
                       grp * kCols + e,
                   16);
      }
    }
    cp_async_commit();
  };

  // this block's combine: rows [16 grp, 16 grp + 16) of dr, dk, dw and its
  // 16 columns of dv, (row or column, step) pairs spread over the threads
  constexpr int kStride = kThreads / kCols;       // steps apart
  const int cl = tid % kCols;
  const int crow = grp * kCols + cl;
  const float u_row = a.u[h * D + crow];
  // the scalars' lanes: elements lane and lane + 32 of a row
  float u_lane[D > 32 ? 2 : 1];
#pragma unroll
  for (int i = 0; i < (D > 32 ? 2 : 1); ++i)
    u_lane[i] = lane + 32 * i < D ? a.u[h * D + lane + 32 * i] : 0.f;

  float g[kCpt];
#pragma unroll
  for (int j = 0; j < kCpt; ++j)
    g[j] = a.ds_last ? a.ds_last[sbase + row * D + col0 + j] : 0.f;
  float du = 0.f;

  // the piece of `count` steps from round step `base`: its states S_{t-1}
  // from its checkpoint, in registers, then G back over it; this block's
  // parts of dr, dk, dw by rows, dv's warp sums by columns
  auto walk = [&](const S* sl, int base, int count, const float (*ckp)[kCols],
                  Parts<D>* part) {
    float sp[kSub][kCpt];
    load_n<kCpt>(&ckp[row][c0], sp[0]);
#pragma unroll
    for (int t = 1; t < kSub; ++t) {
      if (t < count) {
        const float kk = to_float(sl->full[kFk][base + t - 1][row]);
        const float ww = to_float(sl->full[kFw][base + t - 1][row]);
        float vv[kCpt];
        load_n<kCpt>(&sl->own[kOv][base + t - 1][c0], vv);
#pragma unroll
        for (int j = 0; j < kCpt; ++j)
          sp[t][j] = fmaf(ww, sp[t - 1][j], kk * vv[j]);
      }
    }
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      if (t < count) {
        const int ts = base + t;
        const float rr = to_float(sl->full[kFr][ts][row]);
        const float kk = to_float(sl->full[kFk][ts][row]);
        const float ww = to_float(sl->full[kFw][ts][row]);
        float vv[kCpt], dy[kCpt], dv[kCpt];
        load_n<kCpt>(&sl->own[kOv][ts][c0], vv);
        load_n<kCpt>(&sl->own[kOdy][ts][c0], dy);
        float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
        for (int j = 0; j < kCpt; ++j) {
          dr = fmaf(sp[t][j], dy[j], dr);
          dk = fmaf(g[j], vv[j], dk);
          dw = fmaf(g[j], sp[t][j], dw);
          dv[j] = g[j] * kk;
          g[j] = fmaf(ww, g[j], rr * dy[j]);     // G_{t-1}
        }
        dr = lane_sum<kTpr / 2, 1>(dr);
        dk = lane_sum<kTpr / 2, 1>(dk);
        dw = lane_sum<kTpr / 2, 1>(dw);
        if (q == 0) {
          part->x[0][ts][row] = dr;
          part->x[1][ts][row] = dk;
          part->x[2][ts][row] = dw;
        }
        // dv: the sum over the warp's rows (the lane bits from kTpr up), a
        // value a lane
        reduce_scatter<kCpt, 16, kTpr>(dv, lane);
        if (!(lane & kSameSums))
          dvp[ts][warp][c0 + scatter_offset<kCpt, 16, kTpr>(lane)] = dv[0];
      }
    }
  };

  stage(n_rounds - 1, 0);
  for (int i = 0; i < n_rounds; ++i) {
    const int m = n_rounds - 1 - i;
    const int slot = i & 1;
    cp_async_wait<0>();
    // round m has landed everywhere and every thread is done with round
    // m + 1's combine, so slot ^ 1 takes round m - 1
    __syncthreads();
    stage(m - 1, slot ^ 1);
    const S* sl = &slots[slot];
    Parts<D>* part = &parts[slot];
    const int t0 = m * kRound;
    const int n = min(kRound, a.s - t0);

    // this block's part of v_t . dy_t (its 16 columns), a warp a step
    for (int t = warp; t < n; t += kWarps) {
      float vdy = lane < kCols ? to_float(sl->own[kOv][t][lane]) *
                                     to_float(sl->own[kOdy][t][lane])
                               : 0.f;
      vdy = lane_sum<kCols / 2, 1>(vdy);
      if (lane == 0) part->vdy[t] = vdy;
    }
    // the round's pieces, the last first
#pragma unroll
    for (int pc = kPieces - 1; pc >= 0; --pc)
      if (n > pc * kSub)
        walk(sl, pc * kSub, min(n - pc * kSub, kSub), sl->ck[pc], part);

    // every block's parts and this block's dv partials; r_t . (u * k_t)
    // while the cluster's other blocks arrive
    cluster_arrive();
    for (int t = warp; t < n; t += kWarps) {
      float x = 0.f;
#pragma unroll
      for (int i2 = 0; i2 < (D > 32 ? 2 : 1); ++i2) {
        const int e = lane + 32 * i2;
        if (e < D)
          x = fmaf(to_float(sl->full[kFr][t][e]) * u_lane[i2],
                   to_float(sl->full[kFk][t][e]), x);
      }
      x = lane_sum<16, 1>(x);
      if (lane == 0) ruk[t] = x;
    }
    __syncthreads();                  // ruk, block-wide
    cluster_wait();

    // rows [16 grp, 16 grp + 16): the parts of the cluster's blocks in
    // rank order, then the u terms
    for (int t = tid / kCols; t < n; t += kStride) {
      float sum[3] = {0.f, 0.f, 0.f};
      float vdy = 0.f;
      for (int r = 0; r < L::kGroups; ++r) {
        const Parts<D>* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int x = 0; x < 3; ++x) sum[x] += other->x[x][t][crow];
        vdy += other->vdy[t];
      }
      const float rr = to_float(sl->full[kFr][t][crow]);
      const float kk = to_float(sl->full[kFk][t][crow]);
      const long long tt = t0 + t;
      dst[kR][tt * a.ds[kR][2] + crow] =
          from_float<T>(fmaf(u_row * kk, vdy, sum[0]));
      dst[kK][tt * a.ds[kK][2] + crow] =
          from_float<T>(fmaf(rr * u_row, vdy, sum[1]));
      dst[kW][tt * a.ds[kW][2] + crow] = from_float<T>(sum[2]);
      du = fmaf(rr * kk, vdy, du);
      // dv of column 16 grp + cl: the warps' sums in order, the u term
      float dv = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dv += dvp[t][w][cl];
      dv = fmaf(ruk[t], to_float(sl->own[kOdy][t][cl]), dv);
      dst[kV][tt * a.ds[kV][2] + grp * kCols + cl] = from_float<T>(dv);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < kCpt; ++j) a.ds0[sbase + row * D + col0 + j] = g[j];
  // du of the block's rows: the sums of the kStride threads of a row, in
  // order
  du_red[tid] = du;
  __syncthreads();
  if (tid < kCols) {
    float sum = 0.f;
    for (int m = 0; m < kStride; ++m) sum += du_red[m * kCols + tid];
    a.du_part[bh * D + crow] = sum;
  }
  // no block leaves while another may still read its parts
  cluster.sync();
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
  using L = Layout<T, D>;
  auto kernel = rwkv6_bwd_kernel<T, D>;
  {  // state of the current device: set on every call, on every card
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
  }
  // the D / 16 column blocks of a (head, batch row) form a cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L::kGroups, h, b);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::kGroups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
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
// ckpt, ds_last, du, ds0 and the scratch are fp32).  strides: 27 element
// strides, the (batch, head, seq) strides of r, k, v, w, dy, dr, dk, dv and
// dw in that order; r/k/v/w/dy's base pointers and strides 16-byte aligned
// (the caller checks).  ckpt: (B, H, ceil(S / 8), D, D), the state at the
// start of every 8-step piece (rwkv6_scan_fwd's checkpoint epilogue).
// ds_last may be null (a zero gradient).  du_part is (B, H, D) fp32
// scratch.  Two launches (the gradient, then du's sum over the batch);
// returns the first failing launch's cudaError_t (0 on success); the
// caller raises on anything else.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const float* u,
                              const float* ckpt, const void* dy,
                              const float* ds_last, void* dr, void* dk,
                              void* dv, void* dw, float* du_part, float* du,
                              float* ds0, int dtype, int b, int h, int s,
                              int d, const long long* strides, void* stream) {
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
  a.ckpt = ckpt;
  a.ds_last = ds_last;
  a.du_part = du_part;
  a.ds0 = ds0;
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

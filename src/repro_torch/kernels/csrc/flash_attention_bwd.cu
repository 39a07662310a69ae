// Flash-attention backward, GQA-aware, for sm_90a: the gradient of
// flash_attention.cu's function with respect to q, k and v.
//
// The TPU kernel src/repro/kernels/flash_attention.py (`flash_attention`,
// line 74, its pl.pallas_call at line 90) has no backward: the reference
// trains through plain jnp attention (repro/models/attention.py:116,
// differentiated by JAX).  The port's layers run the forward kernel, so
// their gradient is this kernel: the function of
// kernels/ref.py flash_attention_bwd_ref, over the forward's whole contract
// (causal or not, queries right-aligned to the keys, `window`, any GQA
// group, head dims 16, 32, 64, 96, 128, 256, fp32 or bf16 with fp32
// arithmetic, (batch, head, seq) element strides with the head dim
// contiguous).  Given the forward's lse (it writes it when asked) and
// dO, with scale = D^-1/2:
//   P  = exp(scale Q K^T - lse), 0 where masked
//   dV = sum over the group's q heads of P^T dO
//   dP = dO V^T,  D = rowsum(P * dP),  dS = P * (dP - D)
//   dQ = scale dS K,  dK = scale * sum over the group's q heads of dS^T Q
// D is FlashAttention-2's rowsum(dO * O) for the exact output, but taken
// over the recomputed fp32 P: the bf16 forward rounds P before P V, and
// an O that carries that rounding puts it into every dS of its row, so into
// dQ and dK along the row's mean key (on an H100, qwen3-1.7b after 6
// steps: 2.5x the plain bf16 step's distance from fp32 on the deep layers'
// q/k gradients; 1.2x with this D).
//
// The FlashAttention-2 backward in three launches, no atomics, so the same
// inputs give the same bits:
//   1. D: the dQ kernel's sweep (below) with only S and dP, each row's
//      rowsum(P * dP) in fp32 -> (B, Hq, S);
//   2. dK/dV: one block per (key tile, kv head, batch).  K and V of the
//      tile stay in shared memory; the block loops over its group's q
//      heads and over the query tiles that see the tile (causal: from the
//      tile's first key's row on; window: up to its last key + window),
//      recomputes P^T and dS^T from the saved lse and D, and accumulates
//      dV and dK in fp32 registers, written once;
//   3. dQ: one block per (query tile, q head, batch) over the key tiles
//      the tile sees (the forward's skips), recomputing P and dS the same
//      way and accumulating dQ in registers.
//
// Bound at qwen3-1.7b's training shape (B 8, Hq 16, Hkv 8, S = T = 1024,
// D 128, causal): the 5 products take 5 * 2 * B Hq S T D / 2 = 86 GFLOP
// (the D and dQ launches recompute S and dP: 155 GFLOP done) -> 0.087 ms
// at the bf16 tensor-core peak of 989 TFLOP/s; q/k/v/dO and lse read and
// dq/dk/dv written once move 0.17 GB -> 0.05 ms at 3.35 TB/s.  So it is
// bound by operations, and P (B Hq S T fp32 = 512 MB) never reaches device
// memory.
//
// bf16 at head dims up to 128: tensor cores, the forward's fragment code
// (mma.sync m16n8k16, fp32 accumulate, ldmatrix / ldmatrix.trans from rows
// padded by 16 bytes, 16-byte cp.async with zero fill, a 2-stage ring).
// Blocks of 4 warps, each warp 16 rows (keys in dK/dV, queries in dQ), so
// every product's A operand is either the warp's own rows in shared
// memory or the previous product's accumulators (P and dS rounded to bf16
// in registers, as the forward rounds P: the one rounding the plain
// version does not make).  dK/dV streams (q head, 32-query tile) items
// (64 at D <= 64, to keep dK, dV, S^T and dP^T within 255 registers).
//
// fp32, and bf16 at D 256 (dK and dV of 16 keys x 256 a warp would not fit
// the registers): CUDA cores, the forward's fp32 tiling (256 threads, 16 x
// 16, tiles of 64 rows, 32 at D 256 to fit shared memory), bf16 inputs
// converted to fp32 as they are staged; rows padded to D + 1 floats, so
// the 16 distinct rows a warp reads in the product loops land in 16
// distinct banks.  wgmma + TMA is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "convert.cuh"
#include "mma_bf16.cuh"

namespace {

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                   // (B, Hq, S) fp32
  float* delta;                       // (B, Hq, S) fp32: D, then read
  void* dq;
  void* dk;
  void* dv;
  int s, t, hq, group, q_offset, causal, window;  // window <= 0: none
  float scale;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
};

constexpr int kTX = 16;               // threads across (columns)
constexpr int kTY = 16;               // threads down (rows)
constexpr int kThreads = kTX * kTY;   // 256

// rows [r0, r0 + ROWS) of a (rows, D) matrix with row stride `ld` ->
// shared fp32 (ROWS, D + 1); rows at or past `n` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int r0, int n) {
  constexpr int kDP = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * kDP + d] = row < n ? to_float(src[row * ld + d]) : 0.f;
  }
}

// query row `row` (of S) sees key `kpos` (of T)
__device__ __forceinline__ bool visible(const Args& a, int row, int kpos) {
  const int qpos = row + a.q_offset;
  return row < a.s && kpos < a.t && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// ------------------------------------------------------------- dK/dV --

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  constexpr int kDP = D + 1;          // padded staged row (floats)
  constexpr int kPP = TILE + 4;       // padded P^T / dS^T row
  constexpr int kR = TILE / kTY;      // keys a thread
  constexpr int kC = TILE / kTX;      // queries a thread (scores)
  constexpr int kCD = D / kTX;        // output columns a thread
  extern __shared__ float smem[];
  float* ks = smem;                   // (TILE, D+1) K tile, resident
  float* vs = ks + TILE * kDP;        // (TILE, D+1) V tile, resident
  float* qs = vs + TILE * kDP;        // (TILE, D+1) Q tile
  float* dos = qs + TILE * kDP;       // (TILE, D+1) dO tile
  float* pt = dos + TILE * kDP;       // (TILE keys, TILE queries) P^T
  float* dst = pt + TILE * kPP;       // the same, dS^T
  float* lse_s = dst + TILE * kPP;    // (TILE) lse of the Q tile's rows
  float* dl_s = lse_s + TILE;         // (TILE) their D

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int k0 = blockIdx.x * TILE;   // causal: heaviest tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  load_tile<T, D, TILE>(ks, kg, a.ks.s, k0, a.t);
  load_tile<T, D, TILE>(vs, vg, a.vs.s, k0, a.t);

  float dk[kR][kCD], dv[kR][kCD];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCD; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the query rows that see a key of the tile: causal, from the row of
  // its first key on; window, before the row past its last key's window
  const int k_last = min(k0 + TILE, a.t) - 1;
  const int q_begin =
      a.causal ? max(0, (k0 - a.q_offset) / TILE * TILE) : 0;
  const int q_end =
      a.window > 0 ? min(a.s, k_last + a.window - a.q_offset) : a.s;

  for (int hh = 0; hh < a.group; ++hh) {
    const int h = hk * a.group + hh;
    const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* dog =
        static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const long long rows = (static_cast<long long>(b) * a.hq + h) * a.s;
    for (int q0 = q_begin; q0 < q_end; q0 += TILE) {
      __syncthreads();                // the previous tile's reads are done
      load_tile<T, D, TILE>(qs, qg, a.qs.s, q0, a.s);
      load_tile<T, D, TILE>(dos, dog, a.dos.s, q0, a.s);
      if (threadIdx.x < TILE) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.s ? a.lse[rows + row] : 0.f;
        dl_s[threadIdx.x] = row < a.s ? a.delta[rows + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ty*kR + i, queries tx + 16 j
      float sc[kR][kC], dp[kR][kC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[kR], vr[kR], qc[kC], dc[kC];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kr[i] = ks[(ty * kR + i) * kDP + d];
          vr[i] = vs[(ty * kR + i) * kDP + d];
        }
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          qc[j] = qs[(tx + j * kTX) * kDP + d];
          dc[j] = dos[(tx + j * kTX) * kDP + d];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            sc[i][j] = fmaf(kr[i], qc[j], sc[i][j]);
            dp[i][j] = fmaf(vr[i], dc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int r = tx + j * kTX;
          const bool ok = visible(a, q0 + r, k0 + ty * kR + i);
          const float p = ok ? expf(sc[i][j] * a.scale - lse_s[r]) : 0.f;
          pt[(ty * kR + i) * kPP + r] = p;
          dst[(ty * kR + i) * kPP + r] = p * (dp[i][j] - dl_s[r]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        float pv[kR], sv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = pt[(ty * kR + i) * kPP + j];
          sv[i] = dst[(ty * kR + i) * kPP + j];
        }
#pragma unroll
        for (int c = 0; c < kCD; ++c) {
          const float dov = dos[j * kDP + tx + c * kTX];
          const float qv = qs[j * kDP + tx + c * kTX];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
            dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  T* dvg = static_cast<T*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty * kR + i;
    if (key >= a.t) continue;
#pragma unroll
    for (int c = 0; c < kCD; ++c) {
      dkg[key * a.dks.s + tx + c * kTX] = from_float<T>(dk[i][c] * a.scale);
      dvg[key * a.dvs.s + tx + c * kTX] = from_float<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------- dQ --

// DELTA: the first launch, which only sums each row's P * dP into
// a.delta; else dQ from that D
template <typename T, int D, int TILE, bool DELTA>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kDP = D + 1;
  constexpr int kPP = TILE + 4;
  constexpr int kR = TILE / kTY;      // query rows a thread
  constexpr int kC = TILE / kTX;      // keys a thread (scores)
  constexpr int kCD = D / kTX;        // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                   // (TILE, D+1) Q tile, resident
  float* dos = qs + TILE * kDP;       // (TILE, D+1) dO tile, resident
  float* ks = dos + TILE * kDP;       // (TILE, D+1) K tile
  float* vs = ks + TILE * kDP;        // (TILE, D+1) V tile
  float* ds = vs + TILE * kDP;        // (TILE queries, TILE keys) dS

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dog = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  load_tile<T, D, TILE>(qs, qg, a.qs.s, q0, a.s);
  load_tile<T, D, TILE>(dos, dog, a.dos.s, q0, a.s);

  const long long rows = (static_cast<long long>(b) * a.hq + h) * a.s;
  float lse[kR], dl[kR], acc[kR][kCD];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    lse[i] = row < a.s ? a.lse[rows + row] : 0.f;
    dl[i] = !DELTA && row < a.s ? a.delta[rows + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCD; ++c) acc[i][c] = 0.f;
  }

  // the forward's skips: stop after the tile's last row's last visible
  // key, start at the tile holding its first row's first one
  const int last_row = min(q0 + TILE, a.s) - 1 + a.q_offset;
  const int kv_end = a.causal ? min(a.t, last_row + 1) : a.t;
  const int kv_begin =
      a.window > 0 ? max(0, (q0 + a.q_offset - a.window + 1) / TILE * TILE)
                   : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += TILE) {
    __syncthreads();                  // the previous tile's reads are done
    load_tile<T, D, TILE>(ks, kg, a.ks.s, k0, a.t);
    load_tile<T, D, TILE>(vs, vg, a.vs.s, k0, a.t);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ty*kR + i, keys tx + 16 j
    float sc[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kR], dr[kR], kc[kC], vc[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qr[i] = qs[(ty * kR + i) * kDP + d];
        dr[i] = dos[(ty * kR + i) * kDP + d];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kc[j] = ks[(tx + j * kTX) * kDP + d];
        vc[j] = vs[(tx + j * kTX) * kDP + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
          dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = ty * kR + i, c = tx + j * kTX;
        const bool ok = visible(a, q0 + r, k0 + c);
        const float p = ok ? expf(sc[i][j] * a.scale - lse[i]) : 0.f;
        if constexpr (DELTA)
          dl[i] = fmaf(p, dp[i][j], dl[i]);   // this thread's part of D
        else
          ds[r * kPP + c] = p * (dp[i][j] - dl[i]);
      }
    if constexpr (DELTA) continue;
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float sv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) sv[i] = ds[(ty * kR + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < kCD; ++c) {
        const float kv = ks[j * kDP + tx + c * kTX];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

  if constexpr (DELTA) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], off);
      const int row = q0 + ty * kR + i;
      if (tx == 0 && row < a.s) a.delta[rows + row] = dl[i];
    }
    return;
  }
  T* dqg = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= a.s) continue;
#pragma unroll
    for (int c = 0; c < kCD; ++c)
      dqg[row * a.dqs.s + tx + c * kTX] = from_float<T>(acc[i][c] * a.scale);
  }
}

// ------------------------------------------------- bf16, tensor cores --

using bf16 = __nv_bfloat16;

constexpr int kWarpsM = 4;            // warps a block, 16 rows each
constexpr int kThreadsM = kWarpsM * 32;
constexpr int kRowsM = kWarpsM * 16;  // key rows (dK/dV) or q rows (dQ)
constexpr float kLog2e = 1.4426950408889634f;

// ldmatrix row addresses of a lane (elements, rows of kLd), as the
// forward's: the A operand of a 16-row block (row-major), the B operand
// of two 8-column blocks stored as (N, K) rows ("col"), and the B operand
// of two 8-column blocks stored as (K, N) rows (transposed on load)
template <int kLd>
__device__ __forceinline__ int a_lane(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
}
template <int kLd>
__device__ __forceinline__ int b_lane(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
}
template <int kLd>
__device__ __forceinline__ int t_lane(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
}

// acc (16 x NB*8 per warp) += A (16 x D, rows at `a`) * B^T, B (NB*8 x D)
// stored as rows at `b`: the scores' product, K = D
template <int D, int NB, int kLd>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], const bf16* a,
                                         const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_lane<kLd>(lane) + kk * 16);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + nb * 8 * kLd + b_lane<kLd>(lane) + kk * 16);
      mma_bf16(acc[nb], af, bf[0], bf[1]);
      mma_bf16(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D per warp) += P (16 x NB*8, accumulator fragments rounded to
// bf16) * B, B (NB*8 x D) stored as rows at `b`: K = the score columns
template <int D, int NB, int kLd>
__device__ __forceinline__ void mma_frag(float (&acc)[D / 8][4],
                                         float (&p)[NB][4],
                                         const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int db = 0; db < D / 8; db += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + kk * 16 * kLd + t_lane<kLd>(lane) + db * 8);
      mma_bf16(acc[db], pa, bf[0], bf[1]);
      mma_bf16(acc[db + 1], pa, bf[2], bf[3]);
    }
  }
}

// dK/dV: one block of 4 warps per (64-key tile, kv head, batch), each
// warp 16 keys.  K and V stay in shared memory; (q head, query tile)
// items of BQ queries stream through a 2-stage cp.async ring (Q, dO, and
// the rows' lse in log2 units and D).  Per item, a warp computes
// S^T = K Q^T and dP^T = V dO^T (keys x queries, its K and V rows the A
// operands), P^T = exp2(S^T scale log2 e - lse log2 e) and
// dS^T = P^T (dP^T - D) in fp32 registers, rounds both to bf16 in place
// (the accumulator layout is the next product's A layout) and adds
// dV += P^T dO and dK += dS^T Q, dO and Q transposed by ldmatrix.trans.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreadsM) dkdv_mma_kernel(Args a) {
  constexpr int kLd = D + 8;          // padded shared row (elements)
  constexpr int kNB = BQ / 8;         // 8-query blocks of a score tile
  constexpr int kDB = D / 8;          // 8-column blocks of dK and dV
  static_assert(kNB % 2 == 0 && kDB % 2 == 0, "ldmatrix.x4 pairs blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // (64, kLd)
  bf16* vs = ks + kRowsM * kLd;                     // (64, kLd)
  bf16* qs = vs + kRowsM * kLd;                     // 2 x (BQ, kLd)
  bf16* dos = qs + 2 * BQ * kLd;                    // 2 x (BQ, kLd)
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * kLd);  // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                                 // 2 x BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kRowsM;   // causal: heaviest tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const float scale_log2 = a.scale * kLog2e;

  // the query rows that see a key of the tile (the CUDA-core kernel's)
  const int k_last = min(k0 + kRowsM, a.t) - 1;
  const int q_begin = a.causal ? max(0, (k0 - a.q_offset) / BQ * BQ) : 0;
  const int q_end =
      a.window > 0 ? min(a.s, k_last + a.window - a.q_offset) : a.s;
  const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int items = a.group * n_q;

  // item i -> stage st: Q and dO rows by cp.async, lse and D by loads
  auto stage = [&](int i, int st) {
    const int h = hk * a.group + i / n_q;
    const int q0 = q_begin + i % n_q * BQ;
    cp_rows<D, BQ, kThreadsM>(
        qs + st * BQ * kLd,
        static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s, q0,
        a.s);
    cp_rows<D, BQ, kThreadsM>(
        dos + st * BQ * kLd,
        static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h,
        a.dos.s, q0, a.s);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      const long long at = (static_cast<long long>(b) * a.hq + h) * a.s + row;
      lse_s[st * BQ + threadIdx.x] = row < a.s ? a.lse[at] * kLog2e : 0.f;
      dl_s[st * BQ + threadIdx.x] = row < a.s ? a.delta[at] : 0.f;
    }
  };

  cp_rows<D, kRowsM, kThreadsM>(ks, kg, a.ks.s, k0, a.t);
  cp_rows<D, kRowsM, kThreadsM>(vs, vg, a.vs.s, k0, a.t);
  if (items > 0) stage(0, 0);
  cp_async_commit();

  float dk[kDB][4], dv[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[db][e] = dv[db][e] = 0.f;
  const bf16* kw = ks + warp * 16 * kLd;   // the warp's 16 keys
  const bf16* vw = vs + warp * 16 * kLd;
  const int key_lo = k0 + warp * 16 + g;    // this lane's keys: +0, +8

  for (int it = 0; it < items; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    // item it has landed everywhere and every warp is done with it - 1,
    // so stage st ^ 1 takes item it + 1 while item it is multiplied
    __syncthreads();
    if (it + 1 < items) {
      stage(it + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* qt = qs + st * BQ * kLd;
    const bf16* dot = dos + st * BQ * kLd;
    const float* lt = lse_s + st * BQ;
    const float* dlt = dl_s + st * BQ;
    const int q0 = q_begin + it % n_q * BQ;

    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<D, kNB, kLd>(s, kw, qt, lane);     // S^T = K Q^T
    mma_rows<D, kNB, kLd>(dp, vw, dot, lane);   // dP^T = V dO^T
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + tig * 2 + (e & 1);
        const bool ok = visible(a, q0 + col, key_lo + (e >> 1) * 8);
        const float p = ok ? exp2f(s[nb][e] * scale_log2 - lt[col]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - dlt[col]);
      }
    mma_frag<D, kNB, kLd>(dv, s, dot, lane);    // dV += P^T dO
    mma_frag<D, kNB, kLd>(dk, dp, qt, lane);    // dK += dS^T Q
  }
  cp_async_wait<0>();                 // no copy outlives the block

  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dks.b + hk * a.dks.h;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + r * 8;
    if (key >= a.t) continue;
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + key * a.dks.s + db * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(dk[db][2 * r] * a.scale,
                                dk[db][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + key * a.dvs.s + db * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(dv[db][2 * r], dv[db][2 * r + 1]);
    }
  }
}

// dQ: one block of 4 warps per (64-row query tile, q head, batch), each
// warp 16 rows; Q and dO resident, K/V tiles of BK keys through a 2-stage
// cp.async ring over the tiles the query tile sees.  Per tile, a warp
// computes S = Q K^T and dP = dO V^T, P and dS = P (dP - D) in fp32, and
// adds dQ += dS K, K transposed by ldmatrix.trans.  DELTA: the first
// launch, which only sums each row's P * dP into a.delta.
template <int D, int BK, bool DELTA>
__global__ void __launch_bounds__(kThreadsM) dq_mma_kernel(Args a) {
  constexpr int kLd = D + 8;
  constexpr int kNB = BK / 8;
  constexpr int kDB = D / 8;
  static_assert(kNB % 2 == 0 && kDB % 2 == 0, "ldmatrix.x4 pairs blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // (64, kLd)
  bf16* dos = qs + kRowsM * kLd;                    // (64, kLd)
  bf16* ks = dos + kRowsM * kLd;                    // 2 x (BK, kLd)
  bf16* vs = ks + 2 * BK * kLd;                     // 2 x (BK, kLd)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsM;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const float scale_log2 = a.scale * kLog2e;

  const int last_row = min(q0 + kRowsM, a.s) - 1 + a.q_offset;
  const int kv_end = a.causal ? min(a.t, last_row + 1) : a.t;
  const int kv_begin =
      a.window > 0 ? max(0, (q0 + a.q_offset - a.window + 1) / BK * BK) : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  cp_rows<D, kRowsM, kThreadsM>(
      qs, static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s,
      q0, a.s);
  cp_rows<D, kRowsM, kThreadsM>(
      dos, static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h,
      a.dos.s, q0, a.s);
  if (n_tiles > 0) {
    cp_rows<D, BK, kThreadsM>(ks, kg, a.ks.s, kv_begin, a.t);
    cp_rows<D, BK, kThreadsM>(vs, vg, a.vs.s, kv_begin, a.t);
  }
  cp_async_commit();

  // this lane's rows: row_lo and row_lo + 8
  const int row_lo = q0 + warp * 16 + g;
  const long long rows = (static_cast<long long>(b) * a.hq + h) * a.s;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    lse2[r] = row < a.s ? a.lse[rows + row] * kLog2e : 0.f;
    dl[r] = !DELTA && row < a.s ? a.delta[rows + row] : 0.f;
  }
  float acc[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* dow = dos + warp * 16 * kLd;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BK;
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      cp_rows<D, BK, kThreadsM>(ks + (st ^ 1) * BK * kLd, kg, a.ks.s,
                                k0 + BK, a.t);
      cp_rows<D, BK, kThreadsM>(vs + (st ^ 1) * BK * kLd, vg, a.vs.s,
                                k0 + BK, a.t);
      cp_async_commit();
    }
    const bf16* kt = ks + st * BK * kLd;
    const bf16* vt = vs + st * BK * kLd;

    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<D, kNB, kLd>(s, qw, kt, lane);     // S = Q K^T
    mma_rows<D, kNB, kLd>(dp, dow, vt, lane);   // dP = dO V^T
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok =
            visible(a, row_lo + r * 8, k0 + nb * 8 + tig * 2 + (e & 1));
        const float p = ok ? exp2f(s[nb][e] * scale_log2 - lse2[r]) : 0.f;
        if constexpr (DELTA)
          dl[r] = fmaf(p, dp[nb][e], dl[r]);  // this lane's part of D
        else
          dp[nb][e] = p * (dp[nb][e] - dl[r]);
      }
    if constexpr (!DELTA)
      mma_frag<D, kNB, kLd>(acc, dp, kt, lane);   // dQ += dS K
  }
  cp_async_wait<0>();

  if constexpr (DELTA) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a row are lanes 4g .. 4g + 3
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      const int row = row_lo + r * 8;
      if (tig == 0 && row < a.s) a.delta[rows + row] = dl[r];
    }
    return;
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    if (row >= a.s) continue;
#pragma unroll
    for (int db = 0; db < kDB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row * a.dqs.s + db * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(acc[db][2 * r] * a.scale,
                                acc[db][2 * r + 1] * a.scale);
  }
}

// `kernel` over `grid` with `smem` bytes of dynamic shared memory
template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, int threads, int smem,
                const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// D, dK/dV and dQ on the tensor cores
template <int D>
cudaError_t launch_mma(const Args& a, int b, int hkv, cudaStream_t stream) {
  constexpr int kBQ = D > 64 ? 32 : 64;     // queries an item of dK/dV
  constexpr int kBK = 64;                   // keys a tile of dQ
  constexpr int kLd = D + 8;
  const dim3 q_grid((a.s + kRowsM - 1) / kRowsM, a.hq, b);
  const int smem_q = (2 * kRowsM + 4 * kBK) * kLd * sizeof(bf16);
  cudaError_t err = run(dq_mma_kernel<D, kBK, true>, q_grid, kThreadsM,
                        smem_q, a, stream);
  if (err != cudaSuccess) return err;
  const int smem_kv = (2 * kRowsM + 4 * kBQ) * kLd * sizeof(bf16) +
                      4 * kBQ * sizeof(float);
  err = run(dkdv_mma_kernel<D, kBQ>,
            dim3((a.t + kRowsM - 1) / kRowsM, hkv, b), kThreadsM, smem_kv,
            a, stream);
  if (err != cudaSuccess) return err;
  return run(dq_mma_kernel<D, kBK, false>, q_grid, kThreadsM, smem_q, a,
             stream);
}

// D, dK/dV and dQ on CUDA cores
template <typename T, int D>
cudaError_t launch_cores(const Args& a, int b, int hkv,
                         cudaStream_t stream) {
  constexpr int kTile = D == 256 ? 32 : 64;
  constexpr int kDP = D + 1, kPP = kTile + 4;
  const dim3 q_grid((a.s + kTile - 1) / kTile, a.hq, b);
  const int smem_q = (4 * kTile * kDP + kTile * kPP) * sizeof(float);
  cudaError_t err = run(dq_kernel<T, D, kTile, true>, q_grid, kThreads,
                        smem_q, a, stream);
  if (err != cudaSuccess) return err;
  const int smem_kv =
      (4 * kTile * kDP + 2 * kTile * kPP + 2 * kTile) * sizeof(float);
  err = run(dkdv_kernel<T, D, kTile>,
            dim3((a.t + kTile - 1) / kTile, hkv, b), kThreads, smem_kv, a,
            stream);
  if (err != cudaSuccess) return err;
  return run(dq_kernel<T, D, kTile, false>, q_grid, kThreads, smem_q, a,
             stream);
}

// bf16 up to D 128 on the tensor cores, fp32 and D 256 on CUDA cores
template <typename T, int D>
cudaError_t launch(const Args& a, int b, int hkv, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && D <= 128)
    return launch_mma<D>(a, b, hkv, stream);
  else
    return launch_cores<T, D>(a, b, hkv, stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, int b, int hkv, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, b, hkv, stream);
    case 32: return launch<T, 32>(a, b, hkv, stream);
    case 64: return launch<T, 64>(a, b, hkv, stream);
    case 96: return launch<T, 96>(a, b, hkv, stream);
    case 128: return launch<T, 128>(a, b, hkv, stream);
    case 256: return launch<T, 256>(a, b, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv all of it;
// bf16 q, k, v and dout and their batch, head and sequence strides 16-byte
// aligned, which the caller checks).  lse: the forward's (B, Hq, S) fp32
// log-sum-exp; delta: a (B, Hq, S) fp32 scratch buffer.  strides: 21
// element strides, the (batch, head, seq) strides of q, k, v, dout, dq, dk
// and dv in that order (the head dim contiguous).  window: keys
// qpos - window < kpos, <= 0 for none.  Launches three kernels on
// `stream`; returns the first cudaError_t (0 on success), and the caller
// raises on anything else.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int dtype, int b, int hq,
                                   int hkv, int s, int t, int d,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.s = s;
  a.t = t;
  a.hq = hq;
  a.group = hq / hkv;
  a.q_offset = t - s;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  Strides* all[7] = {&a.qs, &a.ks, &a.vs, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 7; ++i)
    *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? dispatch<float>(a, b, hkv, d, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(a, b, hkv, d, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

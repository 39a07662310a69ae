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
// Bound at qwen3-1.7b's training shape (B 8, Hq 16, Hkv 8, S = T = 1024,
// D 128, causal): the 5 products take 5 * 2 * B Hq S T D / 2 = 86 GFLOP
// -> 0.087 ms at the bf16 tensor-core peak of 989 TFLOP/s; q/k/v/dO and
// lse read and dq/dk/dv written once move 0.17 GB -> 0.05 ms at 3.35 TB/s.
// So it is bound by operations, and P (B Hq S T fp32 = 512 MB) never
// reaches device memory.
//
// bf16, every head dim: tensor cores (mma.sync m16n8k16, fp32 accumulate,
// ldmatrix / ldmatrix.trans from rows padded by 16 bytes, 16-byte
// cp.async with zero fill, 2-stage rings), no atomics, so the same inputs
// give the same bits:
//   1. D: one block of 4 warps per (64-row q tile, q head, batch) sweeps
//      the key tiles the tile sees (the forward's skips), S = Q K^T and
//      dP = dO V^T, each row's rowsum(P * dP) in fp32 -> (B, Hq, S);
//   2. dK/dV: one block per (key block, kv head, batch), each warp 16
//      keys, K and V resident; (q head, BQ-query tile) items stream
//      through a ring (Q, dO, their rows' lse and D).  A warp computes
//      S^T = K Q^T and dP^T = V dO^T, P^T and dS^T = P^T (dP^T - D) in
//      fp32 registers, rounds both to bf16 in place (the accumulator
//      layout is the next product's A layout), adds dV += P^T dO and
//      dK += dS^T Q, and from head dim 96 stores its bf16 dS^T to a
//      scratch tile;
//   3. dQ: from head dim 96 one block per (BQ-row q tile, q head, batch)
//      adds dQ += dS K over the scratch tiles of the key blocks that saw
//      the tile, in key order: one product, no S or dP.  At 16 to 64 the
//      D launch's sweep runs again and recomputes S and dP to add dQ
//      (the previous design's third launch): there the 4 bytes a
//      (query, key) pair of the dS round trip weigh more than the 4 D
//      flops of recomputing S and dP at the rate these kernels reach (on
//      an H100 the dS route took whisper's encoder backward, D 64, from
//      1.28 to 1.47 ms).
// What held the previous design back: the dQ launch recomputed S
// and dP only to form dS again, so S and dP were swept three times (9
// products where the gradient needs 5; 155 GFLOP done against 86 at
// qwen3's shape), and bf16 at head dim 256 ran on CUDA cores at 27x
// SDPA's backward, because dK and dV of 16 keys x 256 a warp (256 fp32
// registers a lane) do not fit the registers.  Now the dK/dV sweep hands
// its dS to the dQ launch through device memory, bf16 dS^T tiles of
// (key block, q tile) in a band per q tile (B Hq S T / 2 x 2 bytes = 134
// MB at qwen3's causal shape, written once and read once), so 7 products.
// A dQ summed inside the dK/dV sweep would have to wait on a per-q-tile
// turn counter after every item to add in a fixed key order, a round trip
// to L2 about as long as an item's products at head dim 256.  At head dim
// 256 a warp holds dV alone (16 keys x 256, 128 registers): the sweep
// above runs without dK, writes dV, then a second sweep over the same
// items reads the dS^T tiles it stored back with Q and adds dK += dS^T Q
// (no product recomputed).  Blocks there take 32 keys (2 warps) and
// 16-query items, and a kv head's q heads are split over up to 4 blocks
// whose fp32 dK and dV parts a fourth launch sums in share order: a
// window of 2048 over S = T = 4096 under one kv head still gives 512
// blocks.
//
// fp32: CUDA cores (tensor cores would mean TF32, another function), the
// previous design's three launches: D, dK/dV, then dQ recomputing S and
// dP (3.7x SDPA's fp32 backward at qwen3's shape: only the checks train
// in fp32); the forward's fp32 tiling (256 threads, 16 x 16, tiles of 64
// rows, 32 at D 256 to fit shared memory), rows padded to D + 1 floats,
// so the 16 distinct rows a warp reads in the product loops land in 16
// distinct banks.  wgmma + TMA is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
  __nv_bfloat16* ds;                  // bf16: dS^T tiles (see ds_tile)
  int ds_band;                        // key blocks a q tile's band holds
  float* part;                        // split > 1: dK, dV partial sums
  int split;                          // dK/dV blocks a (key block, kv head)
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
__device__ __forceinline__ void dkdv_body(const Args& a) {
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

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  dkdv_body<T, D, TILE>(a);
}

// D 96: one block an SM, so that dK and dV of 4 keys x 6 columns a thread
// stay in registers (ptxas spills them at its default budget)
template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads, 1) dkdv_d96_kernel(Args a) {
  dkdv_body<T, 96, TILE>(a);
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

constexpr int kWarpsM = 4;            // warps of a D block and a dQ block
constexpr int kThreadsM = kWarpsM * 32;
constexpr int kRowsM = kWarpsM * 16;  // q rows of a D block
constexpr float kLog2e = 1.4426950408889634f;

// the bf16 tiling at head dim D: queries an item of the dK/dV sweep (and
// rows of a dQ block), warps of a dK/dV block (16 keys each), keys a tile
// of the D sweep
template <int D>
struct Tiles {
  static constexpr int kBQ = D > 128 ? 16 : D > 64 ? 32 : 64;
  static constexpr int kKW = D > 128 ? 2 : 4;
  static constexpr int kKB = 16 * kKW;          // keys a dK/dV block
  static constexpr int kBK = D > 128 ? 32 : 64;
  // dS handed to dQ through device memory (else dQ recomputes S and dP)
  static constexpr bool kStoreDs = D >= 96;
  // dK/dV blocks an SM should hold (ptxas's register budget for them)
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
  // blocks a (key block, kv head) at most, each a share of the group's q
  // heads, dK and dV their fp32 sums in a fixed order (D 256's blocks of
  // 32 keys are too few to fill the card under one kv head)
  static constexpr int kMaxSplit = D > 128 ? 4 : 1;
};

// ldmatrix row addresses of a lane (elements, rows of kLd), as the
// forward's: the A operand of a 16-row block (row-major), the B operand
// of two 8-column blocks stored as (N, K) rows ("col"), and the B operand
// of two 8-column blocks stored as (K, N) rows (transposed on load).
// b_lane with .trans also gives the A operand of a 16-row block stored as
// (K, M) rows.
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

// the query rows [x, y) of the items of the key block at k0 (of kb keys):
// causal, from the BQ tile of its first key's row on; window, before the
// row past its last key's window
template <int BQ>
__device__ __forceinline__ int2 q_rows(const Args& a, int k0, int kb) {
  const int k_last = min(k0 + kb, a.t) - 1;
  const int first = a.causal ? max(0, (k0 - a.q_offset) / BQ * BQ) : 0;
  const int end =
      a.window > 0 ? min(a.s, k_last + a.window - a.q_offset) : a.s;
  return make_int2(first, end);
}

// the key blocks (of KB keys) whose q_rows hold q tile i (of BQ rows): the
// interval [x, y] (both ends of q_rows rise with the block), never empty
template <int BQ, int KB>
__device__ __forceinline__ int2 key_blocks(const Args& a, int i) {
  const int last = (a.t + KB - 1) / KB - 1;
  const int lo =
      a.window > 0
          ? min(last, max(0, (i * BQ + 1 - a.window + a.q_offset) / KB))
          : 0;
  const int hi =
      a.causal ? min(last, ((i + 1) * BQ + a.q_offset - 1) / KB) : last;
  return make_int2(lo, hi);
}

// the dS^T tile, (KB keys, BQ queries) bf16, of key block j and q tile i
// of q head h, batch row b: slot j - key_blocks(i).x of the tile's band
// of a.ds_band slots
template <int BQ, int KB>
__device__ __forceinline__ bf16* ds_tile(const Args& a, int b, int h, int i,
                                         int j) {
  const int n_qt = (a.s + BQ - 1) / BQ;
  const long long slot =
      ((static_cast<long long>(b) * a.hq + h) * n_qt + i) * a.ds_band + j -
      key_blocks<BQ, KB>(a, i).x;
  return a.ds + slot * KB * BQ;
}

// D, and dQ where dS is not stored: one block of 4 warps per (64-row
// query tile, q head, batch), each warp 16 rows; Q and dO resident, K/V
// tiles of BK keys through a 2-stage cp.async ring over the tiles the
// query tile sees (the forward's skips).  Per tile, a warp computes
// S = Q K^T and dP = dO V^T in fp32; DELTA (the first launch) sums each
// row's P * dP into a.delta, else P and dS = P (dP - D) give
// dQ += dS K, K transposed by ldmatrix.trans.
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



// dK/dV: one block of kKW warps per (key block of 16 kKW keys, kv head,
// batch), each warp 16 keys.  K and V stay in shared memory; (q head,
// BQ-query tile) items stream through a 2-stage cp.async ring (Q, dO, and
// the rows' lse in log2 units and D).  Per item, a warp computes
// S^T = K Q^T and dP^T = V dO^T (keys x queries, its K and V rows the A
// operands), P^T = exp2(S^T scale log2 e - lse log2 e) and
// dS^T = P^T (dP^T - D) in fp32 registers, rounds both to bf16 in place,
// stores dS^T to its scratch tile and adds dV += P^T dO and (D <= 128)
// dK += dS^T Q, dO and Q transposed by ldmatrix.trans.  D 256: dV alone,
// written after the sweep; then a second sweep over the same items stages
// Q with the block's own dS^T tiles and adds dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(Tiles<D>::kKW * 32, Tiles<D>::kMinBlocks)
    dkdv_mma_kernel(Args a) {
  using L = Tiles<D>;
  constexpr int BQ = L::kBQ, kKB = L::kKB;
  constexpr int kThr = L::kKW * 32;
  constexpr int kLd = D + 8;          // padded shared row (elements)
  constexpr int kNB = BQ / 8;         // 8-query blocks of a score tile
  constexpr int kDB = D / 8;          // 8-column blocks of dK and dV
  constexpr bool kTwoSweeps = D > 128;
  constexpr int kDsLd = BQ + 8;       // padded dS^T row, second sweep
  static_assert(!kTwoSweeps || L::kStoreDs, "the second sweep reads dS^T");
  static_assert(kNB % 2 == 0 && kDB % 2 == 0, "ldmatrix.x4 pairs blocks");
  static_assert(kThr >= BQ, "a thread a row of lse and D");
  static_assert(!kTwoSweeps || kKB * kDsLd <= BQ * kLd,
                "dS^T stages fit dO's");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // (kKB, kLd)
  bf16* vs = ks + kKB * kLd;                        // (kKB, kLd)
  bf16* qs = vs + kKB * kLd;                        // 2 x (BQ, kLd)
  bf16* dos = qs + 2 * BQ * kLd;                    // 2 x (BQ, kLd)
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * kLd);  // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                                 // 2 x BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int j = blockIdx.x;           // causal: heaviest blocks first
  const int k0 = j * kKB;
  // its q heads: share sp of the group (a compile-time 1 up to D 128)
  const int split = L::kMaxSplit > 1 ? a.split : 1;
  const int hk = blockIdx.y / split;
  const int sp = blockIdx.y % split;
  const int b = blockIdx.z;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const float scale_log2 = a.scale * kLog2e;

  const int2 qr = q_rows<BQ>(a, k0, kKB);
  const int n_q = qr.y > qr.x ? (qr.y - qr.x + BQ - 1) / BQ : 0;
  const int heads = a.group / split;
  const int h0 = hk * a.group + sp * heads;
  const int items = heads * n_q;

  // item i -> stage st: Q and dO rows by cp.async, lse and D by loads
  auto stage = [&](int i, int st) {
    const int h = h0 + i / n_q;
    const int q0 = qr.x + i % n_q * BQ;
    cp_rows<D, BQ, kThr>(
        qs + st * BQ * kLd,
        static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s, q0,
        a.s);
    cp_rows<D, BQ, kThr>(
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

  cp_rows<D, kKB, kThr>(ks, kg, a.ks.s, k0, a.t);
  cp_rows<D, kKB, kThr>(vs, vg, a.vs.s, k0, a.t);
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
    const int h = h0 + it / n_q;
    const int q0 = qr.x + it % n_q * BQ;

    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<D, kNB, kLd>(s, kw, qt, lane);     // S^T = K Q^T
    mma_rows<D, kNB, kLd>(dp, vw, dot, lane);   // dP^T = V dO^T
    bf16* tile = L::kStoreDs ? ds_tile<BQ, kKB>(a, b, h, q0 / BQ, j) +
                                   (warp * 16 + g) * BQ + tig * 2
                             : nullptr;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + tig * 2 + (e & 1);
        const bool ok = visible(a, q0 + col, key_lo + (e >> 1) * 8);
        const float p = ok ? exp2f(s[nb][e] * scale_log2 - lt[col]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - dlt[col]);
      }
      if constexpr (L::kStoreDs) {
#pragma unroll
        for (int r = 0; r < 2; ++r)   // dS^T rows key_lo + 8 r, bf16 pairs
          *reinterpret_cast<__nv_bfloat162*>(tile + r * 8 * BQ + nb * 8) =
              __floats2bfloat162_rn(dp[nb][2 * r], dp[nb][2 * r + 1]);
      }
    }
    mma_frag<D, kNB, kLd>(dv, s, dot, lane);    // dV += P^T dO
    if constexpr (!kTwoSweeps)
      mma_frag<D, kNB, kLd>(dk, dp, qt, lane);  // dK += dS^T Q
  }
  cp_async_wait<0>();                 // no copy outlives the sweep

  // dK or dV of this lane's keys: bf16, or (split) the block's fp32 part
  // in (dK or dV, share, batch row, kv head, key, D) order, dK unscaled
  auto store = [&](float (&acc)[kDB][4], int which, bf16* out,
                   long long ld, float scale) {
    float* part =
        a.part + ((static_cast<long long>(which * split + sp) * gridDim.z +
                   b) * (gridDim.y / split) + hk) * a.t * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + r * 8;
      if (key >= a.t) continue;
#pragma unroll
      for (int db = 0; db < kDB; ++db) {
        const int col = db * 8 + tig * 2;
        if (split > 1)
          *reinterpret_cast<float2*>(part + key * D + col) =
              make_float2(acc[db][2 * r], acc[db][2 * r + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + key * ld + col) =
              __floats2bfloat162_rn(acc[db][2 * r] * scale,
                                    acc[db][2 * r + 1] * scale);
      }
    }
  };
  store(dv, 1, static_cast<bf16*>(a.dv) + b * a.dvs.b + hk * a.dvs.h,
        a.dvs.s, 1.f);

  if constexpr (kTwoSweeps) {
    // every warp is done with the ring and has stored its dS^T tiles
    __syncthreads();
    bf16* dss = dos;                  // 2 x (kKB, kDsLd): dS^T stages
    auto stage2 = [&](int i, int st) {
      const int h = h0 + i / n_q;
      const int q0 = qr.x + i % n_q * BQ;
      cp_rows<D, BQ, kThr>(
          qs + st * BQ * kLd,
          static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.s,
          q0, a.s);
      const bf16* src = ds_tile<BQ, kKB>(a, b, h, q0 / BQ, j);
      constexpr int kChunks = BQ / 8;           // 16 bytes a copy
      for (int c = threadIdx.x; c < kKB * kChunks; c += kThr)
        cp_async16(dss + st * kKB * kDsLd + c / kChunks * kDsLd +
                       c % kChunks * 8,
                   src + c * 8, 16);
    };
    if (items > 0) stage2(0, 0);
    cp_async_commit();
    for (int it = 0; it < items; ++it) {
      const int st = it & 1;
      cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < items) {
        stage2(it + 1, st ^ 1);
        cp_async_commit();
      }
      const bf16* qt = qs + st * BQ * kLd;
      const bf16* dsw = dss + st * kKB * kDsLd + warp * 16 * kDsLd;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {    // dK += dS^T Q
        uint32_t af[4];
        ldmatrix_x4(af, dsw + a_lane<kDsLd>(lane) + kk * 16);
#pragma unroll
        for (int db = 0; db < kDB; db += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf,
                            qt + kk * 16 * kLd + t_lane<kLd>(lane) + db * 8);
          mma_bf16(dk[db], af, bf[0], bf[1]);
          mma_bf16(dk[db + 1], af, bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();
  }

  store(dk, 0, static_cast<bf16*>(a.dk) + b * a.dks.b + hk * a.dks.h,
        a.dks.s, a.scale);
}

// split > 1: dK (scaled) and dV of every (batch row, kv head, key) as the
// sum of the shares' parts in share order, rounded to bf16; one thread a
// pair of columns
template <int D>
__global__ void __launch_bounds__(256) dkdv_sum_kernel(Args a, int b,
                                                       int hkv) {
  const long long n = static_cast<long long>(b) * hkv * a.t * D / 2;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= 2 * n) return;
  const int which = i >= n;           // 0: dK, 1: dV
  const long long e = (i - which * n) * 2;
  const int col = e % D;
  const long long key = e / D % a.t;
  const long long bh = e / D / a.t;   // batch row * hkv + kv head
  const float* part = a.part + which * a.split * 2 * n + e;
  float x = 0.f, y = 0.f;
  for (int sp = 0; sp < a.split; ++sp) {
    const float2 v = *reinterpret_cast<const float2*>(part + sp * 2 * n);
    x += v.x;
    y += v.y;
  }
  const float scale = which ? 1.f : a.scale;
  const Strides& st = which ? a.dvs : a.dks;
  bf16* out = static_cast<bf16*>(which ? a.dv : a.dk) + bh / hkv * st.b +
              bh % hkv * st.h + key * st.s + col;
  *reinterpret_cast<__nv_bfloat162*>(out) =
      __floats2bfloat162_rn(x * scale, y * scale);
}

// dQ: one block of 4 warps per (BQ-row q tile, q head, batch) walks the
// key blocks that saw the tile in order, a 2-stage cp.async ring of each
// block's K rows and the tile's dS^T, and adds dQ += dS K: dS the A
// operand from its transpose (ldmatrix.trans), K transposed too.  Warp w
// takes 16 rows and D / (4 / (BQ / 16)) columns of the tile.
template <int D>
__global__ void __launch_bounds__(kThreadsM) dsk_mma_kernel(Args a) {
  using L = Tiles<D>;
  constexpr int BQ = L::kBQ, kKB = L::kKB;
  constexpr int kLd = D + 8;
  constexpr int kDsLd = BQ + 8;
  constexpr int kMT = BQ / 16;            // 16-row blocks of the tile
  constexpr int kGroups = kWarpsM / kMT;  // column groups
  constexpr int kNT = D / 8 / kGroups;    // 8-column blocks a warp
  static_assert(kMT * kGroups == kWarpsM && kNT * kGroups * 8 == D &&
                    kNT % 2 == 0,
                "the warps tile the q tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // 2 x (kKB, kLd)
  bf16* dss = ks + 2 * kKB * kLd;                   // 2 x (kKB, kDsLd)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = warp % kMT, col0 = warp / kMT * kNT * 8;
  const int i = gridDim.x - 1 - blockIdx.x;         // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const int2 kb = key_blocks<BQ, kKB>(a, i);
  const int n = kb.y - kb.x + 1;
  const bf16* src = ds_tile<BQ, kKB>(a, b, h, i, kb.x);  // slots in order

  auto stage = [&](int m, int st) {
    cp_rows<D, kKB, kThreadsM>(ks + st * kKB * kLd, kg, a.ks.s,
                               (kb.x + m) * kKB, a.t);
    constexpr int kChunks = BQ / 8;
    const bf16* from = src + static_cast<long long>(m) * kKB * BQ;
    for (int c = threadIdx.x; c < kKB * kChunks; c += kThreadsM)
      cp_async16(dss + st * kKB * kDsLd + c / kChunks * kDsLd +
                     c % kChunks * 8,
                 from + c * 8, 16);
  };
  stage(0, 0);
  cp_async_commit();

  float acc[kNT][4];
#pragma unroll
  for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  for (int m = 0; m < n; ++m) {
    const int st = m & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (m + 1 < n) {
      stage(m + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* kt = ks + st * kKB * kLd;
    const bf16* dt = dss + st * kKB * kDsLd;
#pragma unroll
    for (int kk = 0; kk < kKB / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, dt + kk * 16 * kDsLd + mt * 16 +
                                b_lane<kDsLd>(lane));
#pragma unroll
      for (int nb = 0; nb < kNT; nb += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, kt + kk * 16 * kLd + t_lane<kLd>(lane) +
                                  col0 + nb * 8);
        mma_bf16(acc[nb], af, bf[0], bf[1]);
        mma_bf16(acc[nb + 1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i * BQ + mt * 16 + g + r * 8;
    if (row >= a.s) continue;
#pragma unroll
    for (int nb = 0; nb < kNT; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row * a.dqs.s + col0 +
                                         nb * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nb][2 * r] * a.scale,
                                acc[nb][2 * r + 1] * a.scale);
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

// key blocks a q tile's band of dS^T tiles holds at head dim D: causal
// with a window, the blocks a tile's rows can see (key_blocks' interval is
// never longer); else all of them
template <int D>
int ds_band(int t, int causal, int window) {
  using L = Tiles<D>;
  const int blocks = (t + L::kKB - 1) / L::kKB;
  return causal && window > 0
             ? std::min(blocks, (L::kBQ + window - 2) / L::kKB + 2)
             : blocks;
}

// shares of a kv head's q heads the dK/dV launch splits them into
template <int D>
int dkdv_split(int group) {
  int split = Tiles<D>::kMaxSplit;
  while (group % split) split /= 2;
  return split;
}

// bf16 elements of the dS^T scratch of one batch row at head dim D (0
// where dQ recomputes dS)
template <int D>
long long ds_elems(int hq, int s, int t, int causal, int window) {
  using L = Tiles<D>;
  if (!L::kStoreDs) return 0;
  return static_cast<long long>(hq) * ((s + L::kBQ - 1) / L::kBQ) *
         ds_band<D>(t, causal, window) * L::kKB * L::kBQ;
}

// bytes of scratch one batch row of a bf16 call needs at head dim D: the
// dS^T tiles, then (split) the fp32 parts of dK and dV
template <int D>
long long scratch_bytes(int hq, int hkv, int s, int t, int causal,
                        int window) {
  const int split = dkdv_split<D>(hq / hkv);
  const long long parts =
      split > 1 ? 2LL * split * hkv * t * D * sizeof(float) : 0;
  return (ds_elems<D>(hq, s, t, causal, window) * 2 + 15) / 16 * 16 + parts;
}

// D, dK/dV and dQ on the tensor cores: dQ from the stored dS^T tiles, or
// (D <= 64) recomputing S and dP
template <int D>
cudaError_t launch_mma(Args a, int b, int hkv, cudaStream_t stream) {
  using L = Tiles<D>;
  constexpr int kLd = D + 8;
  a.ds_band = ds_band<D>(a.t, a.causal, a.window);
  const dim3 q_grid((a.s + kRowsM - 1) / kRowsM, a.hq, b);
  const int smem_q = (2 * kRowsM + 4 * L::kBK) * kLd * sizeof(bf16);
  cudaError_t err = run(dq_mma_kernel<D, L::kBK, true>, q_grid, kThreadsM,
                        smem_q, a, stream);
  if (err != cudaSuccess) return err;
  const int smem_kv = (2 * L::kKB + 4 * L::kBQ) * kLd * sizeof(bf16) +
                      4 * L::kBQ * sizeof(float);
  a.split = dkdv_split<D>(a.group);
  err = run(dkdv_mma_kernel<D>,
            dim3((a.t + L::kKB - 1) / L::kKB, hkv * a.split, b),
            L::kKW * 32, smem_kv, a, stream);
  if (err != cudaSuccess) return err;
  if (a.split > 1) {
    const long long pairs = static_cast<long long>(b) * hkv * a.t * D;
    dkdv_sum_kernel<D><<<(pairs + 255) / 256, 256, 0, stream>>>(a, b, hkv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (!L::kStoreDs)
    return run(dq_mma_kernel<D, L::kBK, false>, q_grid, kThreadsM, smem_q, a,
               stream);
  const int smem_ds = 2 * L::kKB * (kLd + L::kBQ + 8) * sizeof(bf16);
  return run(dsk_mma_kernel<D>, dim3((a.s + L::kBQ - 1) / L::kBQ, a.hq, b),
             kThreadsM, smem_ds, a, stream);
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
  const dim3 kv_grid((a.t + kTile - 1) / kTile, hkv, b);
  if constexpr (D == 96)
    err = run(dkdv_d96_kernel<T, kTile>, kv_grid, kThreads, smem_kv, a,
              stream);
  else
    err = run(dkdv_kernel<T, D, kTile>, kv_grid, kThreads, smem_kv, a,
              stream);
  if (err != cudaSuccess) return err;
  return run(dq_kernel<T, D, kTile, false>, q_grid, kThreads, smem_q, a,
             stream);
}

template <int D>
cudaError_t launch(Args a, int dtype, int b, int hkv, cudaStream_t stream) {
  if (dtype != 1) return launch_cores<float, D>(a, b, hkv, stream);
  // the scratch: b rows of dS^T tiles, then the dK/dV parts
  const long long ds =
      ds_elems<D>(a.hq, a.s, a.t, a.causal, a.window) * b * 2;
  a.part = reinterpret_cast<float*>(reinterpret_cast<char*>(a.ds) +
                                    (ds + 15) / 16 * 16);
  return launch_mma<D>(a, b, hkv, stream);
}

cudaError_t dispatch(const Args& a, int dtype, int b, int hkv, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(a, dtype, b, hkv, stream);
    case 32: return launch<32>(a, dtype, b, hkv, stream);
    case 64: return launch<64>(a, dtype, b, hkv, stream);
    case 96: return launch<96>(a, dtype, b, hkv, stream);
    case 128: return launch<128>(a, dtype, b, hkv, stream);
    case 256: return launch<256>(a, dtype, b, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bytes of scratch flash_attention_bwd needs for each batch row of a bf16
// call (hq q heads, hkv kv heads, S queries, T keys, head dim d): the dS^T
// tiles and the dK/dV parts; -1 for a head dim it does not take.
extern "C" long long flash_attention_bwd_scratch(int hq, int hkv, int s,
                                                 int t, int d, int causal,
                                                 int window) {
  switch (d) {
    case 16: return scratch_bytes<16>(hq, hkv, s, t, causal, window);
    case 32: return scratch_bytes<32>(hq, hkv, s, t, causal, window);
    case 64: return scratch_bytes<64>(hq, hkv, s, t, causal, window);
    case 96: return scratch_bytes<96>(hq, hkv, s, t, causal, window);
    case 128: return scratch_bytes<128>(hq, hkv, s, t, causal, window);
    case 256: return scratch_bytes<256>(hq, hkv, s, t, causal, window);
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv all of it;
// bf16 q, k, v and dout and their batch, head and sequence strides 16-byte
// aligned, which the caller checks).  lse: the forward's (B, Hq, S) fp32
// log-sum-exp; delta: a (B, Hq, S) fp32 scratch buffer; ds: bf16 only, a
// 16-byte aligned scratch buffer of b * flash_attention_bwd_scratch(...)
// bytes (ignored for fp32).  strides: 21 element strides, the (batch, head, seq)
// strides of q, k, v, dout, dq, dk and dv in that order (the head dim
// contiguous).  window: keys qpos - window < kpos, <= 0 for none.
// Launches three kernels on `stream` (four where bf16 splits the dK/dV
// blocks' heads); returns the first cudaError_t (0 on success), and the
// caller raises on anything else.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, float* delta,
                                   void* ds, void* dq, void* dk, void* dv,
                                   int dtype, int b, int hq, int hkv, int s,
                                   int t, int d, const long long* strides,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.ds = static_cast<__nv_bfloat16*>(ds);
  a.ds_band = 0;
  a.part = nullptr;
  a.split = 1;
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
  return static_cast<int>(
      dispatch(a, dtype, b, hkv, d, static_cast<cudaStream_t>(stream)));
}

// Blocked online-softmax (flash) attention forward, GQA-aware, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, line 74, its pl.pallas_call at line 90): the same
// function.  The contract, the same for both routes below:
//   q (B, Hq, S, D), k/v (B, Hkv, T, D) -> o (B, Hq, S, D) in q's dtype,
//   element strides for the batch, head and sequence axes (the head dim
//   contiguous), so the model's (B, S, H, D) projections are read and
//   written in place with no transpose; head dims 16, 32, 64, 96, 128, 256;
//   scores, running max, running denominator and accumulator in fp32;
//   q-head h reads kv-head h / (Hq / Hkv); queries are right-aligned
//   (query i sits at key position T - S + i); causal KV tiles past a query
//   tile's last row are never visited.  With a window W (recurrentgemma's
//   local attention, the reference's mask of repro/models/attention.py:
//   128-129), key kpos is visible to query qpos when
//   qpos - W < kpos <= qpos: KV tiles wholly before the tile's first row's
//   first visible key are never visited either, and the edge tile is
//   masked.  A row may then see a whole tile masked before its first
//   visible key: its running max stays at the mask value -1e30, so those
//   entries add exp(0) = 1 to l and v to the accumulator, and the first
//   tile holding one of its keys (every row sees its own position)
//   rescales both by exp(-1e30 - m) = 0 exactly.
// Unlike the Pallas kernel it masks ragged S and T itself (no S % 128 or
// T % 128 requirement).  Asked for it (the training path), it also writes
// each row's log-sum-exp of its scaled, masked scores, the input of the
// backward (flash_attention_bwd.cu), from separate instantiations: the
// serving kernels are compiled as before.
//
// Bound at the prefill shape (B=1, Hq=16, Hkv=8, S=T=1024, D=128, bf16,
// causal): 524,800 unmasked (query, key) pairs per head, 4*D flops each,
// = 4.30 GFLOP -> 4.35 us at 989 TFLOP/s (bf16 tensor-core peak); q/k/v/o
// move 12.6 MB -> 3.76 us at 3.35 TB/s.  So the work is compute-bound, and
// the score matrix (B*Hq*S*T fp32 = 64 MB) must never reach device memory.
//
// bf16: tensor cores (the FlashAttention-2 shape).  One block of 4 warps
// per (64-row q tile, q-head, batch), each warp owning 16 rows (8 warps
// over 128 rows, or 32 rows a warp, ran slower at the model's shapes:
// fewer blocks, longer causal chains).  The blocks take their tiles in an
// order that pairs a heavy causal tile with a light one on each SM, so no
// SM is left with two of the longest.  The q tile is copied to shared
// memory once; K and V tiles of 64 keys go through a 2-stage ring filled
// by 16-byte cp.async.cg (rows past T zero-filled by the src-size
// operand), so tile j+1 loads while tile j is multiplied, with one barrier
// a tile.  Rows are padded by 16 bytes: D/8 + 1 16-byte chunks a row is
// odd, so the 8 row addresses of an ldmatrix hit 8 distinct bank groups.
// S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 out), A fragments of
// Q and B fragments of K by ldmatrix (K as stored is the "col" operand);
// the online softmax (exp2 with scale * log2 e folded in) works on the
// accumulator fragments, reducing a row over the 4 lanes that hold it, and
// builds the mask only on tiles where some (row, key) of the warp is
// masked; P is rounded to bf16 in registers, where the m16n8 accumulator
// layout is already the A-operand layout of the next mma, and O += P V
// takes V's B fragments through ldmatrix.trans.  O stays in registers (16
// x D a warp) and is written once, scaled by 1 / l.  The one rounding the
// reference does not make is P to bf16 before P V.  At D 256 the key tile
// is 32, which keeps the accumulators (128 fp32 a thread) and the score
// fragments within 255 registers without spilling and the ring at 101 KB
// of shared memory (two blocks an SM).  At D 96 (phi3-mini) a row is 12
// 16-byte chunks, which do not divide the block's 128 threads, so the tile
// copies walk the tile's chunks with a stride of the block; the padded row
// of 104 elements is 13 chunks, still odd, and the 6 k-steps and 12 output
// column blocks pair up for ldmatrix.x4 as at the other widths.  wgmma +
// TMA with warp specialisation (FlashAttention-3) is the next step.
//
// fp32: CUDA cores (tensor cores would mean TF32, a different function).
// One block of 256 threads per 64-row q tile loops over 64-key tiles: K
// tile -> shared, 64x64 score tile in registers (each thread owns 4 rows x
// 4 keys), online softmax with the row statistics reduced across the 16
// threads of a row by warp shuffles, P -> shared, V tile -> the same shared
// buffer as K, then the thread's 4 rows x D/16 output columns accumulate
// in registers.  Head dim 256 takes (64 * 257 * 2 + 64 * 68) * 4 = 149 KB
// of dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // the reference's mask value

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                         // (B, Hq, S) fp32, or null
  int s, t, group, q_offset, causal, window;  // window <= 0: none
  int hq, batch, sms;                 // q heads, batch, the card's SMs
  float scale;
  Strides qs, ks, vs, os;
};

// ---------------------------------------------------------------- fp32 --

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kTX = 16;               // threads across a row (keys / dims)
constexpr int kTY = 16;               // threads down the rows
constexpr int kThreads = kTX * kTY;   // 256
constexpr int kRQ = kBQ / kTY;        // rows per thread
constexpr int kCK = kBK / kTX;        // score columns per thread
constexpr int kPP = kBK + 4;          // padded P row (floats): the two rows
                                      // a warp touches land 16 banks apart

// rows [r0, r0 + 64) of a (rows, D) matrix with row stride `ld` -> shared
// (64, D + 1); rows at or past `n` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int r0, int n) {
  constexpr int kDP = D + 1;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * kDP + d] = row < n ? src[row * ld + d] : 0.f;
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(Args a) {
  static_assert(kBQ == kBK, "load_tile serves both tiles");
  constexpr int kDP = D + 1;          // padded q/k/v row (floats)
  constexpr int kCD = D / kTX;        // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // (BQ, D+1)
  float* kv = qs + kBQ * kDP;         // (BK, D+1): K tile, then V tile
  float* ps = kv + kBK * kDP;         // (BQ, BK+4)

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;
  float* og = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;

  load_tile<D>(qs, qg, a.qs.s, q0, a.s);

  float m[kRQ], l[kRQ], acc[kRQ][kCD];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCD; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last query row are masked for every row: stop
  const int last_row = min(q0 + kBQ, a.s) - 1 + a.q_offset;
  const int kv_end = a.causal ? min(a.t, last_row + 1) : a.t;
  // keys before the tile's first query row's window are masked for every
  // row: start at the KV tile holding that row's first visible key
  const int kv_begin =
      a.window > 0 ? max(0, (q0 + a.q_offset - a.window + 1) / kBK * kBK) : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();                  // previous V / P reads are done
    load_tile<D>(kv, kg, a.ks.s, k0, a.t);
    __syncthreads();

    float sc[kRQ][kCK];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kCK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRQ], kk[kCK];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qv[i] = qs[(ty * kRQ + i) * kDP + d];
#pragma unroll
      for (int j = 0; j < kCK; ++j) kk[j] = kv[(tx + j * kTX) * kDP + d];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kCK; ++j) sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int r = ty * kRQ + i;
      const int qpos = q0 + r + a.q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        const int kpos = k0 + tx + j * kTX;
        const bool ok = kpos < a.t && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        sc[i][j] = ok ? sc[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[r * kPP + tx + j * kTX] = p;
        rs += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                  // K reads done, P written
    load_tile<D>(kv, vg, a.vs.s, k0, a.t);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kRQ], vv[kCD];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) p[i] = ps[(ty * kRQ + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < kCD; ++c) vv[c] = kv[j * kDP + tx + c * kTX];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < kCD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int row = q0 + ty * kRQ + i;
    if (row >= a.s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCD; ++c)
      og[row * a.os.s + tx + c * kTX] = acc[i][c] * inv;
    if constexpr (LSE) {
      if (tx == 0)
        a.lse[(static_cast<long long>(b) * a.hq + h) * a.s + row] =
            m[i] + logf(l[i]);
    }
  }
}

template <int D, bool LSE>
cudaError_t launch_f32(const Args& a, int b, int hq, cudaStream_t stream) {
  const int smem = (kBQ * (D + 1) + kBK * (D + 1) + kBQ * kPP) * sizeof(float);
  auto kernel = flash_attention_f32_kernel<D, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

using bf16 = __nv_bfloat16;

constexpr int kWarpsB = 4;            // warps a bf16 block, 16 q rows each
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kRowsB = kWarpsB * 16;  // q rows a bf16 block

template <int D, int BK, bool LSE>
__global__ void __launch_bounds__(kThreadsB)
    flash_attention_bf16_kernel(Args a) {
  constexpr int kLd = D + 8;          // padded shared row (elements)
  constexpr int kNB = BK / 8;         // 8-key blocks of a score tile
  constexpr int kDB = D / 8;          // 8-column blocks of the output
  static_assert(kNB % 2 == 0 && kDB % 2 == 0, "ldmatrix.x4 pairs blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // (kRowsB, kLd)
  bf16* ks = qs + kRowsB * kLd;                        // 2 x (BK, kLd)
  bf16* vs = ks + 2 * BK * kLd;                        // 2 x (BK, kLd)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  // Work items (q tile, head, batch) are ranked heaviest causal tile
  // first.  The blocks of each wave of `sms` take the next `sms` ranks,
  // every other wave in reverse, so the blocks an SM holds at once pair a
  // heavy tile with a light one.
  const int wave = blockIdx.x / a.sms, pos = blockIdx.x % a.sms;
  const int in_wave = min(a.sms, static_cast<int>(gridDim.x) - wave * a.sms);
  const int rank = wave * a.sms + (wave & 1 ? in_wave - 1 - pos : pos);
  const int heads = a.hq * a.batch;
  const int q0 = (gridDim.x / heads - 1 - rank / heads) * kRowsB;
  const int h = rank % heads % a.hq;
  const int b = rank % heads / a.hq;
  const int hk = h / a.group;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  bf16* og = static_cast<bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const float scale_log2 = a.scale * 1.4426950408889634f;

  // the fp32 kernel's tile skips: stop after the tile's last row's last
  // visible key, start at the tile holding its first row's first one
  const int last_row = min(q0 + kRowsB, a.s) - 1 + a.q_offset;
  const int kv_end = a.causal ? min(a.t, last_row + 1) : a.t;
  const int kv_begin =
      a.window > 0 ? max(0, (q0 + a.q_offset - a.window + 1) / BK * BK) : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK
                                        : 0;

  cp_rows<D, kRowsB, kThreadsB>(qs, qg, a.qs.s, q0, a.s);
  if (n_tiles > 0) {
    cp_rows<D, BK, kThreadsB>(ks, kg, a.ks.s, kv_begin, a.t);
    cp_rows<D, BK, kThreadsB>(vs, vg, a.vs.s, kv_begin, a.t);
  }
  cp_async_commit();

  float acc[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};            // this lane's share of the row sums

  // this lane's rows: row_lo and row_lo + 8 of the block's q tile
  const int row_lo = q0 + warp * 16 + g;
  const int qpos_lo = row_lo + a.q_offset;
  // the warp's first and last query positions
  const int wq_first = q0 + warp * 16 + a.q_offset;
  const int wq_last = wq_first + 15;
  // ldmatrix row addresses, fixed per lane
  const bf16* q_lane =
      qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
      (lane >> 4) * 8;
  const int k_lane =
      ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BK;
    const int st = it & 1;
    cp_async_wait<0>();               // this thread's copies of tile it
    // every thread's copies of tile it have landed, and every warp is done
    // with tile it - 1, so its stage st ^ 1 takes tile it + 1 while tile
    // it is multiplied: one barrier a tile
    __syncthreads();
    if (it + 1 < n_tiles) {
      cp_rows<D, BK, kThreadsB>(ks + (st ^ 1) * BK * kLd, kg, a.ks.s, k0 + BK,
                                a.t);
      cp_rows<D, BK, kThreadsB>(vs + (st ^ 1) * BK * kLd, vg, a.vs.s, k0 + BK,
                                a.t);
      cp_async_commit();
    }
    const bf16* kt = ks + st * BK * kLd;
    const bf16* vt = vs + st * BK * kLd;

    // S = Q K^T: 16 rows x BK keys a warp
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_lane + kk * 16);
#pragma unroll
      for (int nb = 0; nb < kNB; nb += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + nb * 8 * kLd + k_lane + kk * 16);
        mma_bf16(s[nb], qa, kb[0], kb[1]);
        mma_bf16(s[nb + 1], qa, kb[2], kb[3]);
      }
    }

#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale_log2;
    // mask only where some (row, key) of the warp's tile is masked
    if (k0 + BK > a.t || (a.causal && k0 + BK - 1 > wq_first) ||
        (a.window > 0 && k0 <= wq_last - a.window)) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + nb * 8 + tig * 2 + (e & 1);
          const int qpos = qpos_lo + (e >> 1) * 8;
          const bool ok = kpos < a.t && (!a.causal || kpos <= qpos) &&
                          (a.window <= 0 || kpos > qpos - a.window);
          if (!ok) s[nb][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a row are lanes 4g .. 4g + 3
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      acc[db][0] *= alpha[0];
      acc[db][1] *= alpha[0];
      acc[db][2] *= alpha[1];
      acc[db][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A fragments, in bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < kDB; db += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + kk * 16 * kLd + v_lane + db * 8);
        mma_bf16(acc[db], pa, vb[0], vb[1]);
        mma_bf16(acc[db + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();                 // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + r * 8;
    if (row >= a.s) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = og + row * a.os.s + tig * 2;
#pragma unroll
    for (int db = 0; db < kDB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(orow + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * r] * inv,
                                acc[db][2 * r + 1] * inv);
    if constexpr (LSE) {              // m is in log2 units: lse = ln 2 *
      if (tig == 0)                   // (m + log2 l)
        a.lse[(static_cast<long long>(b) * a.hq + h) * a.s + row] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

template <int D, bool LSE>
cudaError_t launch_bf16(const Args& a, int b, int hq, cudaStream_t stream) {
  constexpr int kKeys = D == 256 ? 32 : 64;   // keys a K/V tile
  const int smem = (kRowsB + 4 * kKeys) * (D + 8) * sizeof(bf16);
  auto kernel = flash_attention_bf16_kernel<D, kKeys, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = (a.s + kRowsB - 1) / kRowsB * hq * b;
  kernel<<<items, kThreadsB, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool LSE>
struct LaunchBf16 {
  static cudaError_t run(const Args& a, int b, int hq, cudaStream_t st) {
    return launch_bf16<D, LSE>(a, b, hq, st);
  }
};

template <int D, bool LSE>
struct LaunchF32 {
  static cudaError_t run(const Args& a, int b, int hq, cudaStream_t st) {
    return launch_f32<D, LSE>(a, b, hq, st);
  }
};

template <template <int, bool> class Launch, int D>
cudaError_t launch_lse(const Args& a, int b, int hq, cudaStream_t st) {
  return a.lse != nullptr ? Launch<D, true>::run(a, b, hq, st)
                          : Launch<D, false>::run(a, b, hq, st);
}

// the launch of head dim d, with the lse epilogue when a.lse is set
template <template <int, bool> class Launch>
cudaError_t dispatch(const Args& a, int b, int hq, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch_lse<Launch, 16>(a, b, hq, stream);
    case 32: return launch_lse<Launch, 32>(a, b, hq, stream);
    case 64: return launch_lse<Launch, 64>(a, b, hq, stream);
    case 96: return launch_lse<Launch, 96>(a, b, hq, stream);
    case 128: return launch_lse<Launch, 128>(a, b, hq, stream);
    case 256: return launch_lse<Launch, 256>(a, b, hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k and v
// and their batch, head and sequence strides 16-byte aligned, which the
// caller checks).  strides: 12 element strides, the (batch, head, seq)
// strides of q, k, v and o in that order.  window: the local-attention
// window (keys qpos - window < kpos), <= 0 for none.  lse: null, or the
// (B, Hq, S) contiguous fp32 buffer that takes each row's log-sum-exp of
// its scaled, masked scores (the backward's input; a separate
// instantiation, so without it the serving kernels are unchanged).
// Returns the launch's cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype, int b,
                                   int hq, int hkv, int s, int t, int d,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.s = s;
  a.t = t;
  a.group = hq / hkv;
  a.q_offset = t - s;
  a.causal = causal;
  a.window = window;
  a.hq = hq;
  a.batch = b;
  a.scale = scale;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0   ? dispatch<LaunchF32>(a, b, hq, d, st)
        : dtype == 1 ? dispatch<LaunchBf16>(a, b, hq, d, st)
                     : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

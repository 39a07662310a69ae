// Flash-decode: one query token per (batch row, q head) against a KV cache,
// GQA-aware and split over the sequence (flash-decoding), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py (`flash_decode`,
// its pl.pallas_call at line 77): the same function.
//   q (B, Hq, D), k/v caches (B, Hkv, T, D) -> o (B, Hq, D) in q's dtype;
//   cache positions [0, len) are valid; scores, running max, denominator
//   and accumulator in fp32; q-head h reads kv-head h / (Hq / Hkv); a
//   length of 0 gives zeros (the TPU kernel's skipped blocks leave the
//   denominator at 0).
// Unlike the Pallas kernel it takes a per-slot length vector (B,) in device
// memory as well as one scalar length, masks a ragged tail itself (no
// T % block requirement), and takes element strides for the batch, head and
// sequence axes (the head dim must be contiguous and every cache row 16-byte
// aligned), so the decode engine's (slots, T, Hkv, D) layer cache is read in
// place as a (B, Hkv, T, D) view.
//
// Bound at the decode path's shape (B=8, Hq=16, Hkv=8, D=128, bf16, every
// slot ~1056 positions): the valid K/V rows are 8*8*1056*128*2*2 = 34.6 MB,
// 10.3 us at 3.35 TB/s, against 4*D flops per (q head, position) = 69 MFLOP,
// 0.07 us at 989 TFLOP/s.  So the work is bound by bytes: each valid K/V
// row must be read from device memory once per kv head, in wide loads, by
// enough blocks in flight to fill the card.  (One call reads them in a few
// microseconds, so ramp-up counts: chip_smoke.py times a plain torch.sum
// over as many bytes beside the kernel, the reach of a single read pass.)
//
// The split plan (the wrapper's split_plan): the grid is (nsplit, kv head
// x group chunk, batch row), nsplit chosen by the wrapper from the card's
// SM count so that B * Hkv * nsplit fills the blocks the card holds at
// once (two an SM below D 256, one at D 256) in one wave: a fifth split
// at qwen3's shape put 56 blocks in a tail wave.  Each row cuts its own
// valid length, not T, into nsplit splits of ceil(len / nsplit) rounded
// up to the 16-key tile (split_length), so every split of a row carries
// about the same work whatever its length; blocks whose split starts at
// or past the row's length exit at once.  With nsplit > 1 each block
// writes its partial (max, denominator, accumulator) to per-call scratch
// and a second kernel merges the splits; a fused last-arriving-block
// merge would need a counter per call, zeroed by a launch of its own, so
// it saves no launch.
//
// bf16: tensor cores.  One block of 4 warps serves all G = Hq / Hkv q
// heads of its kv head (up to 16: the M of mma.sync m16n8k16; a smaller
// group is padded with zero rows that are never stored; a larger one is
// cut into chunks of 16 along the grid), so each K/V row is read once per
// kv head.  The q rows are staged in shared memory once.  Warp w takes the
// split's 16-key tiles w, w + 4, ... through its own 3-stage ring of
// 16-byte cp.async copies (108 KB a block at D 128, 211 KB at D 256),
// rows past the split's end zero-filled, so only __syncwarp orders a
// stage.  S = Q K^T runs on
// mma.sync (fp32 accumulate) with Q's A fragments and K's B fragments by
// ldmatrix (K as stored is the "col" operand); the online softmax (exp2,
// scale * log2 e folded in) reduces a row over the 4 lanes that hold it;
// P, rounded to bf16, stays in registers as the A operand of O += P V,
// whose B fragments come by ldmatrix.trans: flash_attention's fragment
// scheme.  No per-row shuffle chain remains.  At the end the 4 warps'
// states merge through shared memory (the ring's space).  The one
// rounding the reference does not make is P to bf16 before P V.  At D 96
// (phi3-mini) a row is 12 16-byte chunks and the padded row 104 elements
// (13 chunks, odd, as at the other widths); a block takes 83 KB, so two
// fit an SM.  phi3-mini is MHA (group 1): 15 of the 16 rows of the mma's
// M are padding, which costs tensor-core work the byte-bound kernel has
// to spare, not bytes.
//
// fp32: CUDA cores (tensor cores would mean TF32, a different function).
// One block of 4 warps per (split, kv head, chunk of <= 8 q heads (4 at
// D 96, for registers), row):
// each lane owns 16-byte slices of a cache row (LPR lanes per row, the
// largest power of two up to 32 that divides the row's D / 4 slices: 8 at
// D 96, with 3 slices a lane), loads kUnroll rows ahead (2 at D 96 and
// 256), reduces a row's scores across its LPR lanes by
// shuffles and keeps the online-softmax state of the rows it reads; the
// row groups of a warp merge by shuffles, the warps through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "convert.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;            // rows a lane loads before computing
constexpr int kTile = 16;             // keys a bf16 warp tile; splits are
                                      // multiples of it
constexpr int kHeadsB = 16;           // q heads a bf16 block (the mma's M)
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;                    // (B, Hq, nsplit, D), nsplit > 1 only
  float* part_ml;                     // (B, Hq, nsplit, 2): max, denominator
  const int* lens;                    // (B,) int32 on the device, or null
  int len;                            // the length of every row if !lens
  int t, hq, group, nsplit;
  int gchunks;                        // blocks (chunks of q heads) per kv head
  float scale;
  long long qsb, qsh, ksb, ksh, kst, vsb, vsh, vst, osb, osh;
};

// 16 loaded bytes -> 16 / sizeof(T) floats (the CUDA-core route: fp32)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& x, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ int row_length(const Args& a, int b) {
  const int len = a.lens != nullptr ? a.lens[b] : a.len;
  return min(max(len, 0), a.t);
}

// positions a split of a row of `len` valid positions covers: len cut into
// nsplit, rounded up to the key tile (the wrapper's split_length)
__device__ __forceinline__ int split_length(const Args& a, int len) {
  const int c = (len + a.nsplit - 1) / a.nsplit;
  return (c + kTile - 1) / kTile * kTile;
}

template <typename T, int D, int KG>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int kSlices = D / kVec;       // 16-byte slices of a row
  // lanes per row: the largest power of two up to 32 dividing kSlices
  constexpr int kLpr = (kSlices & -kSlices) < 32 ? (kSlices & -kSlices) : 32;
  constexpr int kSl = D / (kVec * kLpr);  // 16-byte slices a lane loads a row
  constexpr int kEl = kSl * kVec;         // elements of a row a lane owns
  // rows a lane loads ahead: fewer where a lane owns more than 8
  // elements of a row (D 96) or the rows are long (D 256)
  constexpr int kUn = D >= 256 || kEl > 8 ? 2 : kUnroll;
  constexpr int kRpw = 32 / kLpr;         // rows per warp load
  constexpr int kKpw = kRpw * kUn;        // rows per warp per iteration
  static_assert(D % (kVec * kLpr) == 0 && kLpr >= 2 && 32 % kLpr == 0,
                "a cache row must split into 2..32 lanes of 16-byte slices");
  __shared__ float s_m[kWarps][KG];
  __shared__ float s_l[kWarps][KG];
  __shared__ float s_acc[kWarps][KG][D];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = lane / kLpr;
  const int part = lane % kLpr;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / a.gchunks;
  const int g0 = (blockIdx.y % a.gchunks) * KG;   // first q head of the group
  const int b = blockIdx.z;
  const int g_n = min(KG, a.group - g0);          // q heads of this block
  const int len = row_length(a, b);
  const int chunk = split_length(a, len);
  const int k_begin = split * chunk;
  const int k_end = min(len, k_begin + chunk);
  const bool final_out = a.nsplit == 1;
  if (!final_out && k_begin >= k_end) return;   // the combine skips it

  // lane `part` owns elements (part + sl * kLpr) * kVec + [0, kVec) of a
  // row, sl < kSl, as q[g][sl * kVec + e] and acc[g][sl * kVec + e]
  float q[KG][kEl], m[KG], l[KG], acc[KG][kEl];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const T* qp = static_cast<const T*>(a.q) + b * a.qsb +
                  (hk * a.group + g0 + g) * a.qsh + part * kVec;
#pragma unroll
    for (int sl = 0; sl < kSl; ++sl)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        q[g][sl * kVec + e] = g < g_n ? to_float(qp[sl * kLpr * kVec + e])
                                      : 0.f;
        acc[g][sl * kVec + e] = 0.f;
      }
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh +
                part * kVec;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh +
                part * kVec;

  for (int k0 = k_begin + warp * kKpw; k0 < k_end; k0 += kWarps * kKpw) {
    uint4 kr[kUn][kSl], vr[kUn][kSl];
#pragma unroll
    for (int u = 0; u < kUn; ++u) {
      const int key = k0 + u * kRpw + row;
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl) {
        if (key < k_end) {
          kr[u][sl] = *reinterpret_cast<const uint4*>(
              kb + key * a.kst + sl * kLpr * kVec);
          vr[u][sl] = *reinterpret_cast<const uint4*>(
              vb + key * a.vst + sl * kLpr * kVec);
        } else {
          kr[u][sl] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][sl] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float p[KG][kUn];
#pragma unroll
    for (int u = 0; u < kUn; ++u) {
      float kf[kEl];
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl) unpack<T>(kr[u][sl], kf + sl * kVec);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEl; ++e) dot = fmaf(q[g][e], kf[e], dot);
        // the kLpr lanes of a row are consecutive lanes of one warp
#pragma unroll
        for (int off = kLpr / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        p[g][u] = dot * a.scale;
      }
    }
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g >= g_n) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUn; ++u)
        if (k0 + u * kRpw + row < k_end) mx = fmaxf(mx, p[g][u]);
      const float alpha = expf(m[g] - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kUn; ++u) {
        p[g][u] = k0 + u * kRpw + row < k_end ? expf(p[g][u] - mx) : 0.f;
        ps += p[g][u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUn; ++u) {
      float vf[kEl];
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl) unpack<T>(vr[u][sl], vf + sl * kVec);
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int e = 0; e < kEl; ++e)
          acc[g][e] = fmaf(p[g][u], vf[e], acc[g][e]);
    }
  }

  // merge the warp's row groups (lanes `part`, `part + kLpr`, ...)
#pragma unroll
  for (int off = kLpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m2);
      const float c1 = expf(m[g] - mx), c2 = expf(m2 - mx);
      l[g] = l[g] * c1 + l2 * c2;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kEl; ++e) {
        const float o2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c1 + o2 * c2;
      }
    }
  }
  if (row == 0) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s_acc[warp][g][(part + sl * kLpr) * kVec + e] = acc[g][sl * kVec + e];
      if (part == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the output or this split's partial state
  for (int i = threadIdx.x; i < g_n * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);
      den += s_l[w][g] * c;
      num += s_acc[w][g][d] * c;
    }
    const int h = hk * a.group + g0 + g;
    if (final_out) {
      static_cast<T*>(a.o)[b * a.osb + h * a.osh + d] =
          from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      const long long idx = (static_cast<long long>(b) * a.hq + h) *
                                a.nsplit + split;
      a.part_acc[idx * D + d] = num;
      if (d == 0) {
        a.part_ml[2 * idx] = mx;
        a.part_ml[2 * idx + 1] = den;
      }
    }
  }
}

// one block per (q head, batch row), one thread per output element: merges
// the partial states of the splits that saw valid positions (maxima in
// natural-log units)
template <typename T>
__global__ void flash_decode_combine_kernel(Args a, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = row_length(a, b);
  const int chunk = split_length(a, len);
  const int n = chunk > 0 ? (len + chunk - 1) / chunk : 0;
  const long long base = (static_cast<long long>(b) * a.hq + h) * a.nsplit;
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, a.part_ml[2 * (base + i)]);
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float den = 0.f, num = 0.f;
    for (int i = 0; i < n; ++i) {
      const float c = expf(a.part_ml[2 * (base + i)] - mx);
      den += a.part_ml[2 * (base + i) + 1] * c;
      num += a.part_acc[(base + i) * d + e] * c;
    }
    static_cast<T*>(a.o)[b * a.osb + h * a.osh + e] =
        from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

// ---------------------------------------------------------------- bf16 --

using bf16 = __nv_bfloat16;

template <int D>
struct Bf16Plan {
  static constexpr int kLd = D + 8;           // padded shared row (elements)
  static constexpr int kStages = 3;           // a warp's ring
  static constexpr int kQ = kHeadsB * kLd;    // the staged q rows
  static constexpr int kStage = 2 * kTile * kLd;   // a K and a V tile
  static constexpr int kRing = kStages * kStage;   // one warp's ring
  // 108 KB at D 128 (two blocks an SM), 211 KB at D 256 (one)
  static constexpr int kBytes = (kQ + kWarps * kRing) * sizeof(bf16);
  static constexpr int kAld = D + 8;          // padded merge row (floats)
  static_assert(kWarps * kHeadsB * kAld * sizeof(float) <= kBytes,
                "the warps' merge fits in the ring's space");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_bf16_kernel(Args a) {
  using P = Bf16Plan<D>;
  constexpr int kLd = P::kLd;
  constexpr int kStages = P::kStages;
  constexpr int kDB = D / 8;                  // 8-column output blocks
  constexpr int kChunks = D / 8;              // 16-byte chunks a row
  static_assert(kDB % 2 == 0, "ldmatrix.x4 pairs column blocks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // (16, kLd)
  __shared__ float s_m[kWarps][kHeadsB];
  __shared__ float s_l[kWarps][kHeadsB];
  __shared__ float s_c[kWarps][kHeadsB];     // a warp's weight in a row
  __shared__ float s_mx[kHeadsB], s_den[kHeadsB];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / a.gchunks;
  const int g0 = (blockIdx.y % a.gchunks) * kHeadsB;
  const int b = blockIdx.z;
  const int g_n = min(kHeadsB, a.group - g0);   // q heads of this block
  const int len = row_length(a, b);
  const int chunk = split_length(a, len);
  const int k_begin = split * chunk;
  const int k_end = min(len, k_begin + chunk);
  const bool final_out = a.nsplit == 1;
  if (!final_out && k_begin >= k_end) return;   // the combine skips it
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile
                                      : 0;
  // this warp's tiles: warp, warp + kWarps, ...
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                      : 0;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;
  bf16* ring = qs + P::kQ + warp * P::kRing;

  // the warp's i-th tile -> stage i % kStages; rows at or past k_end are
  // zero-filled (a V row of an unwritten cache slot may hold anything)
  auto load_tile = [&](int i) {
    if (i < my_tiles) {
      const int k0 = k_begin + (warp + i * kWarps) * kTile;
      bf16* kd = ring + (i % kStages) * P::kStage;
      bf16* vd = kd + kTile * kLd;
#pragma unroll
      for (int c = lane; c < kTile * kChunks; c += 32) {
        const int r = c / kChunks, col = (c % kChunks) * 8;
        const int key = k0 + r;
        const bool ok = key < k_end;
        cp_async16(kd + r * kLd + col, ok ? kg + key * a.kst + col : kg,
                   ok ? 16 : 0);
        cp_async16(vd + r * kLd + col, ok ? vg + key * a.vst + col : vg,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);

  // q rows of the block's heads, rows past the group zero: all loads in
  // flight before the first store, so the block waits one round trip
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qsb +
                   (hk * a.group + g0) * a.qsh;
  constexpr int kQPer = kHeadsB * D / kThreads;
  bf16 qv[kQPer];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / D;
    qv[j] = r < g_n ? qg[r * a.qsh + i % D] : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    qs[i / D * kLd + i % D] = qv[j];
  }
  __syncthreads();

  float acc[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};            // this lane's share of the row sums
  const float scale_log2 = a.scale * 1.4426950408889634f;
  // ldmatrix row addresses, fixed per lane
  const bf16* q_lane =
      qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
  const int k_lane =
      ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;

  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<kStages - 2>();     // this lane's copies of tile i
    // every lane's copies of tile i have landed and every lane is done
    // with tile i - 1, whose stage now takes tile i + kStages - 1
    __syncwarp();
    load_tile(i + kStages - 1);
    const bf16* kt = ring + (i % kStages) * P::kStage;
    const bf16* vt = kt + kTile * kLd;
    const int k0 = k_begin + (warp + i * kWarps) * kTile;

    // S = Q K^T: 16 heads x 16 keys
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, q_lane + kk * 16);
      ldmatrix_x4(kb, kt + k_lane + kk * 16);
      mma_bf16(s[0], qa, kb[0], kb[1]);
      mma_bf16(s[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] *= scale_log2;
        if (k0 + nb * 8 + tig * 2 + (e & 1) >= k_end) s[nb][e] = kNegInf;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // row g + 8 r: elements e = 2 r, 2 r + 1 of both key blocks, over
      // the 4 lanes 4 g .. 4 g + 3
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
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
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int db = 0; db < kDB; db += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + v_lane + db * 8);
      mma_bf16(acc[db], pa, vb[0], vb[1]);
      mma_bf16(acc[db + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();                 // no copy outlives the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // merge the warps through shared memory (the ring's space; rows padded
  // so a half-warp's 8-byte stores hit distinct banks); a warp that saw
  // no tile holds m = -1e30, l = 0 and weighs 0
  __syncthreads();
  constexpr int kAld = P::kAld;
  float* s_acc = reinterpret_cast<float*>(smem_raw);   // (kWarps, 16, kAld)
  float* mine = s_acc + warp * kHeadsB * kAld + g * kAld + tig * 2;
#pragma unroll
  for (int db = 0; db < kDB; ++db) {
    *reinterpret_cast<float2*>(mine + db * 8) =
        make_float2(acc[db][0], acc[db][1]);
    *reinterpret_cast<float2*>(mine + 8 * kAld + db * 8) =
        make_float2(acc[db][2], acc[db][3]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s_m[warp][g + 8 * r] = m[r];
      s_l[warp][g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kHeadsB) {        // each row's weights, once
    const int gi = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][gi]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(s_m[w][gi] - mx);
      s_c[w][gi] = c;
      den += s_l[w][gi] * c;
    }
    s_mx[gi] = mx;
    s_den[gi] = den;
  }
  __syncthreads();
#pragma unroll 8
  for (int j = 0; j < kHeadsB * D / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int gi = i / D, d = i % D;
    if (gi >= g_n) break;             // rows are in order: the rest too
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num += s_acc[(w * kHeadsB + gi) * kAld + d] * s_c[w][gi];
    const int h = hk * a.group + g0 + gi;
    if (final_out) {
      static_cast<bf16*>(a.o)[b * a.osb + h * a.osh + d] =
          __float2bfloat16(num / fmaxf(s_den[gi], 1e-30f));
    } else {
      const long long idx = (static_cast<long long>(b) * a.hq + h) *
                                a.nsplit + split;
      a.part_acc[idx * D + d] = num;
      if (d == 0) {
        a.part_ml[2 * idx] = s_mx[gi] * kLn2;   // log2 -> natural units
        a.part_ml[2 * idx + 1] = s_den[gi];
      }
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a, int b, int hkv, cudaStream_t stream) {
  constexpr int smem = Bf16Plan<D>::kBytes;
  auto kernel = flash_decode_bf16_kernel<D>;
  {  // state of the current device: set on every call, on every card
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.nsplit, hkv * a.gchunks, b), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  flash_decode_combine_kernel<bf16><<<dim3(a.hq, b), D, 0, stream>>>(a, D);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Args& a, int b, int hkv, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return launch_bf16<16>(a, b, hkv, stream);
    case 32: return launch_bf16<32>(a, b, hkv, stream);
    case 64: return launch_bf16<64>(a, b, hkv, stream);
    case 96: return launch_bf16<96>(a, b, hkv, stream);
    case 128: return launch_bf16<128>(a, b, hkv, stream);
    case 256: return launch_bf16<256>(a, b, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------- fp32 launch --

// q heads an fp32 block serves: 8, or 4 at D 96, where a lane owns 12
// elements of a row and 8 heads' q and accumulators (192 floats) would
// spill out of the register file
constexpr int f32_heads(int d) { return d == 96 ? 4 : 8; }

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int hkv, cudaStream_t stream) {
  constexpr int kMaxKG = f32_heads(D);
  const dim3 grid(a.nsplit, hkv * a.gchunks, b);
  if (a.group <= 1)
    flash_decode_split_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(a);
  else if (a.group <= 2)
    flash_decode_split_kernel<T, D, 2><<<grid, kThreads, 0, stream>>>(a);
  else if (a.group <= 4 || kMaxKG == 4)
    flash_decode_split_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(a);
  else
    flash_decode_split_kernel<T, D, kMaxKG><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  flash_decode_combine_kernel<T><<<dim3(a.hq, b), D, 0, stream>>>(a, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, int hkv, int d,
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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lens:
// (B,) int32 device lengths, or null to use `len` for every row.  nsplit:
// the splits of every row (the wrapper's split_plan).  part_acc / part_ml: fp32 scratch of
// B * Hq * nsplit * D and B * Hq * nsplit * 2 floats (unused, may be null,
// when nsplit == 1).  strides: 10 element strides, the (batch, head) strides
// of q, the (batch, head, seq) strides of k and of v, and the (batch, head)
// strides of o.  Returns the launches' cudaError_t (0 on success); the
// caller raises on anything else.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* o, float* part_acc, float* part_ml,
                                const int* lens, int len, int dtype, int b,
                                int hq, int hkv, int t, int d,
                                int nsplit, const long long* strides,
                                float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.part_acc = part_acc;
  a.part_ml = part_ml;
  a.lens = lens;
  a.len = len;
  a.t = t;
  a.hq = hq;
  a.group = hq / hkv;
  // q heads a block serves: 16 on the bf16 route, 8 (4 at D 96) on the
  // fp32 one
  const int heads = dtype == 1 ? kHeadsB : f32_heads(d);
  a.gchunks = (a.group + heads - 1) / heads;
  a.nsplit = nsplit;
  a.scale = scale;
  a.qsb = strides[0];
  a.qsh = strides[1];
  a.ksb = strides[2];
  a.ksh = strides[3];
  a.kst = strides[4];
  a.vsb = strides[5];
  a.vsh = strides[6];
  a.vst = strides[7];
  a.osb = strides[8];
  a.osh = strides[9];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch_d<float>(a, b, hkv, d, st)
                    : dtype == 1 ? dispatch_bf16(a, b, hkv, d, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

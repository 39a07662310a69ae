// int8 x int8 -> int32 matrix product for sm_90a, on the s8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/matmul_qi8.py (`matmul_qi8`,
// line 44, its pl.pallas_call at line 56; the Edge TPU systolic-array
// analogue):
//   x (M, K) int8 row-major, w (K, N) int8 row-major -> (M, N) int32,
//   every product and sum exact in int32.
// Unlike the Pallas kernel it takes any (M, K, N), K = 0 included: the
// ragged edge tiles are zero-filled on load (a zero adds nothing to an
// exact sum), so K need not be a multiple of 4 and N = 1000 (the ResNet
// head) needs no padding.
//
// Bound: 2*M*N*K int8 operations at the 1,979 TOPS int8 tensor-core peak
// against M*K + K*N bytes in and 4*M*N bytes out at 3.35 TB/s.  At 512^3 the
// operations take 0.14 us and the bytes 0.39 us; at ResNet50's head (8 x
// 2048 x 1000) w alone is 2 MB (0.61 us); at the 1x1-conv shape (25088 x
// 64 x 256) the int32 output is 25.7 MB (7.7 us).  Every shape of the
// int8 path is bound by bytes, so the design is about keeping enough
// loads in flight on all 132 SMs.
//
// Design.  Products on mma.sync m16n8k32 (s8 x s8 -> s32).  A block of 4
// warps owns a BM x 64 output tile: BM = 64 (2 x 2 warps of 32 x 32), or
// BM = 16 for M <= 16 (1 x 4 warps of 16 x 16), so the ResNet head's 8
// rows do not waste 7/8 of a 64-row tile.  It walks its K range in steps
// of 32:
// - x tiles (K-contiguous, already the "row" A operand) go to shared memory
//   by 16-byte cp.async.cg in a 2-stage ring, zero-filled past M and the
//   slice's end by the src-size operand; their A fragments come by
//   ldmatrix (an 8 x 16-byte matrix is an 8 x 8 b16 one).  Where K or x's
//   base is not 16-byte aligned, the same ring is filled byte by byte.
// - w tiles (N-contiguous) must become the K-contiguous "col" B operand,
//   and ldmatrix.trans moves 16-bit elements, not bytes.  So each of the
//   128 threads reads a 4 x 4 byte square of the 32 x 64 tile, a 4-byte
//   word from each of 4 K-rows (single bytes where N % 4 != 0),
//   transposes it in registers with eight __byte_perm (prmt), and stores
//   4-byte K-words into a (64, K) tile, from which ldmatrix gives the B
//   fragments.  (Squares 16 columns wide read by 16-byte loads, a quarter
//   of the threads loading, ran no faster at the int8 path's shapes and
//   slower at the head's.)  The next step's w loads are issued before
//   this step's products, so they fly meanwhile.
// Shared rows are 48 bytes (32 + 16 of padding): 3 16-byte chunks a row is
// odd, so the 8 rows of an ldmatrix hit 8 distinct bank groups.
// Split-K: when the output tiles would fill fewer blocks than the 132 SMs,
// the wrapper cuts K into slices (each a multiple of 32 but the last, which
// ends at K; kernels/matmul_qi8.py `split_k`), one block each along
// gridDim.z, and the slices add into an output the wrapper zeroed, with
// int32 atomicAdd: integer addition is associative, so the result is exact
// and the same on every run.  With one slice the tile is stored plainly.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kBN = 64;               // output columns per block
constexpr int kBK = 32;               // K per step (one m16n8k32)
constexpr int kLd = kBK + 16;         // shared row stride (bytes)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// c += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows r0..r3 (4 bytes each: one row of a 4 x 4 byte square) -> columns
// c0..c3 (4 bytes each: column j = byte j of every row, row 0 lowest)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// One thread's share of a w tile: a 4 x 4 byte square, 4 K-rows x 4
// columns of w, read as one 4-byte word a row (WORDS; the rows must be
// 4-byte aligned) or byte by byte, and zero past kend and n.
template <bool WORDS>
struct WSquare {
  static constexpr int kCount = (kBK / 4) * (kBN / 4);     // squares a tile
  static_assert(kCount == kThreads, "one square a thread");
  uint32_t r[4];                      // row i: columns 0..3, column 0 lowest

  __device__ __forceinline__ void load(const int8_t* w, int n, int kend,
                                       int k0, int col0) {
    const int kr = threadIdx.x / (kBN / 4), cb = threadIdx.x % (kBN / 4);
    const int gc = col0 + cb * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + kr * 4 + i;
      const int8_t* row = w + static_cast<long long>(gk) * n + gc;
      if constexpr (WORDS) {
        r[i] = gk < kend && gc < n ? *reinterpret_cast<const uint32_t*>(row)
                                   : 0u;
      } else {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk < kend && gc + j < n)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(row[j]))
                    << (8 * j);
        r[i] = word;
      }
    }
  }

  // transposed into wt (kBN columns x kLd bytes, K-contiguous)
  __device__ __forceinline__ void store(int8_t* wt) const {
    const int kr = threadIdx.x / (kBN / 4), cb = threadIdx.x % (kBN / 4);
    uint32_t c[4];
    transpose4x4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(wt + (cb * 4 + j) * kLd + kr * 4) = c[j];
  }
};

// x rows [row0, row0 + BM) x K [k0, k0 + 32) -> shared (BM, kLd), zero past
// m and kend: 16-byte cp.async (XV 16) or single bytes (XV 1).
template <int BM, int XV>
__device__ __forceinline__ void load_x(int8_t* xs, const int8_t* x, int m,
                                       int k, int kend, int row0, int k0) {
  if constexpr (XV == 16) {
    constexpr int kChunks = BM * (kBK / 16);
#pragma unroll
    for (int j = 0; j < (kChunks + kThreads - 1) / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (kChunks % kThreads != 0 && i >= kChunks) break;
      const int r = i / 2, c = (i % 2) * 16;
      const bool ok = row0 + r < m && k0 + c < kend;
      cp_async16(xs + r * kLd + c,
                 ok ? x + static_cast<long long>(row0 + r) * k + k0 + c : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const bool ok = row0 + r < m && k0 + c < kend;
      xs[r * kLd + c] =
          ok ? x[static_cast<long long>(row0 + r) * k + k0 + c] : int8_t(0);
    }
  }
}

template <int BM, int XV, bool WORDS>
__global__ void __launch_bounds__(kThreads)
    matmul_qi8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int32_t* __restrict__ o,
                      int m, int n, int k, int k_chunk, int atomic) {
  constexpr int kWM = BM == 16 ? 1 : 2;       // warps down the rows
  constexpr int kWN = kWarps / kWM;           // warps across the columns
  constexpr int kMI = BM / kWM / 16;          // m16 tiles a warp
  constexpr int kNI = kBN / kWN / 8;          // n8 tiles a warp
  static_assert(kNI % 2 == 0, "ldmatrix.x4 pairs n8 tiles");
  __shared__ __align__(16) int8_t xs[2][BM * kLd];   // (row, k) ring
  __shared__ __align__(16) int8_t wt[kBN * kLd];     // (column, k)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(k, kbeg + k_chunk);
  const int n_steps = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // ldmatrix row addresses, fixed per lane: A 16 rows x 32 bytes as four
  // 8 x 16-byte matrices (a0..a3); B two n8 tiles x 32 bytes (b0, b1 each)
  const int a_lane =
      (wm * kMI * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
      (lane >> 4) * 16;
  const int b_lane =
      (wn * kNI * 8 + (lane & 7) + (lane >> 4) * 8) * kLd +
      ((lane >> 3) & 1) * 16;

  WSquare<WORDS> wb;
  if (n_steps > 0) {
    load_x<BM, XV>(xs[0], x, m, k, kend, row0, kbeg);
    cp_async_commit();
    wb.load(w, n, kend, kbeg, col0);
  }
  for (int it = 0; it < n_steps; ++it) {
    const int k0 = kbeg + it * kBK;
    const int st = it & 1;
    wb.store(wt);                     // last step's products are done
    if (it + 1 < n_steps) {
      load_x<BM, XV>(xs[st ^ 1], x, m, k, kend, row0, k0 + kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it + 1 < n_steps) wb.load(w, n, kend, k0 + kBK, col0);

    uint32_t a[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      ldmatrix_x4(a[mi], xs[st] + a_lane + mi * 16 * kLd);
#pragma unroll
    for (int ni = 0; ni < kNI; ni += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, wt + b_lane + ni * 8 * kLd);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        mma_s8(acc[mi][ni], a[mi], b[0], b[1]);
        mma_s8(acc[mi][ni + 1], a[mi], b[2], b[3]);
      }
    }
    __syncthreads();                  // xs[st] and wt read
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g + 8
        const int gr = row0 + wm * kMI * 16 + mi * 16 + g + half * 8;
        const int gc = col0 + wn * kNI * 8 + ni * 8 + tig * 2;
        if (gr >= m || gc >= n) continue;
        const int c0 = acc[mi][ni][2 * half], c1 = acc[mi][ni][2 * half + 1];
        int32_t* dst = o + static_cast<long long>(gr) * n + gc;
        if (atomic) {
          atomicAdd(dst, c0);
          if (gc + 1 < n) atomicAdd(dst + 1, c1);
        } else if (gc + 1 < n && n % 2 == 0) {
          // 8-byte aligned (gc and n even): a warp fills 32-byte sectors
          *reinterpret_cast<int2*>(dst) = make_int2(c0, c1);
        } else {
          dst[0] = c0;
          if (gc + 1 < n) dst[1] = c1;
        }
      }
}

template <int BM, int XV, bool WORDS>
cudaError_t launch(const int8_t* x, const int8_t* w, int32_t* o, int m,
                   int n, int k, int k_chunk, int splits,
                   cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, splits);
  matmul_qi8_kernel<BM, XV, WORDS><<<grid, kThreads, 0, stream>>>(
      x, w, o, m, n, k, k_chunk, splits > 1);
  return cudaGetLastError();
}

template <int BM, int XV>
cudaError_t dispatch_w(const int8_t* x, const int8_t* w, int32_t* o, int m,
                       int n, int k, int k_chunk, int splits,
                       cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(w) % 4 == 0 && n % 4 == 0)
    return launch<BM, XV, true>(x, w, o, m, n, k, k_chunk, splits, stream);
  return launch<BM, XV, false>(x, w, o, m, n, k, k_chunk, splits, stream);
}

template <int BM>
cudaError_t dispatch_x(const int8_t* x, const int8_t* w, int32_t* o, int m,
                       int n, int k, int k_chunk, int splits,
                       cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && k % 16 == 0)
    return dispatch_w<BM, 16>(x, w, o, m, n, k, k_chunk, splits, stream);
  return dispatch_w<BM, 1>(x, w, o, m, n, k, k_chunk, splits, stream);
}

}  // namespace

// x (m, k), w (k, n) int8 and o (m, n) int32, all row-major and contiguous;
// m, n >= 1, k >= 0.  K is cut into `splits` slices of `k_chunk` (a
// multiple of 32; the last slice ends at k): with splits > 1 they add into
// o with atomics, and o must hold zeros.  Returns the launch's cudaError_t
// (0 on success); the caller raises on anything else.
extern "C" int matmul_qi8_fwd(const void* x, const void* w, void* o, int m,
                              int n, int k, int k_chunk, int splits,
                              void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the slices must cover [0, k) exactly, none of them empty
  if (splits < 1 || k_chunk <= 0 || k_chunk % kBK != 0 ||
      static_cast<long long>(splits) * k_chunk < k ||
      static_cast<long long>(splits - 1) * k_chunk >= (k > 0 ? k : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      m <= 16 ? dispatch_x<16>(xp, wp, op, m, n, k, k_chunk, splits, st)
              : dispatch_x<64>(xp, wp, op, m, n, k, k_chunk, splits, st);
  return static_cast<int>(err);
}

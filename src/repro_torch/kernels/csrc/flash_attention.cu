// Blocked online-softmax (flash) attention forward, GQA-aware, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, its pl.pallas_call at line 90): the same function.
//   q (B, Hq, S, D), k/v (B, Hkv, T, D) -> o (B, Hq, S, D) in q's dtype;
//   scores, running max, running denominator and accumulator in fp32;
//   q-head h reads kv-head h / (Hq / Hkv); queries are right-aligned
//   (query i sits at key position T - S + i); causal KV tiles past a query
//   tile's last row are never visited.
// Unlike the Pallas kernel it masks ragged S and T itself (no S % 128 or
// T % 128 requirement), and it takes element strides for the batch, head
// and sequence axes (the head dim must be contiguous), so the model's
// (B, S, H, D) projections are read and written in place with no transpose.
//
// Bound at the slice's shape (B=1, Hq=16, Hkv=8, S=T=1024, D=128, bf16,
// causal): 524,800 unmasked (query, key) pairs per head, 4*D flops each,
// = 4.30 GFLOP -> 4.35 us at 989 TFLOP/s (bf16 tensor-core peak); q/k/v/o
// move 12.6 MB -> 3.76 us at 3.35 TB/s.  So the work is compute-bound, and
// the score matrix (B*Hq*S*T fp32 = 64 MB) must never reach device memory.
//
// Design: one thread block per (q tile of 64 rows, q-head, batch); heavy
// (late) causal q tiles launch first.  The block keeps its q tile in shared
// memory and loops over 64-key tiles: K tile -> shared, 64x64 score tile in
// registers (each of 256 threads owns 4 rows x 4 keys), online softmax with
// the row statistics reduced across the 16 threads of a row by warp
// shuffles, P -> shared, V tile -> the same shared buffer as K, then the
// thread's 4 rows x D/16 output columns accumulate in registers.  Only
// q/k/v are read and o written in device memory.  The math is fp32 on CUDA
// cores (peak 67 TFLOP/s, about 15x below the bf16 tensor-core bound):
// correct and simple first.  wgmma + TMA, which the bound asks for, is
// later work.
// Head dim 256 (recurrentgemma's MQA layers: 16 q heads over 1 kv head)
// takes (64 * 257 * 2 + 64 * 68) * 4 = 149 KB of dynamic shared memory
// (of the 227 KB a block may opt into) and 4 x 16 accumulators a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kTX = 16;               // threads across a row (keys / dims)
constexpr int kTY = 16;               // threads down the rows
constexpr int kThreads = kTX * kTY;   // 256
constexpr int kRQ = kBQ / kTY;        // rows per thread
constexpr int kCK = kBK / kTX;        // score columns per thread
constexpr int kPP = kBK + 4;          // padded P row (floats): the two rows
                                      // a warp touches land 16 banks apart
constexpr float kNegInf = -1e30f;     // the reference's mask value

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, t, group, q_offset, causal;
  float scale;
  Strides qs, ks, vs, os;
};

// rows [r0, r0 + 64) of a (rows, D) matrix with row stride `ld` -> shared
// (64, D + 1) fp32; rows at or past `n` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int r0, int n) {
  constexpr int kDP = D + 1;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * kDP + d] = row < n ? to_float(src[row * ld + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(Args a) {
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
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;
  T* og = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;

  load_tile<T, D>(qs, qg, a.qs.s, q0, a.s);

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
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                  // previous V / P reads are done
    load_tile<T, D>(kv, kg, a.ks.s, k0, a.t);
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
        const bool ok = kpos < a.t && (!a.causal || kpos <= qpos);
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
    load_tile<T, D>(kv, vg, a.vs.s, k0, a.t);
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
      og[row * a.os.s + tx + c * kTX] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int hq, cudaStream_t stream) {
  const int smem = (kBQ * (D + 1) + kBK * (D + 1) + kBQ * kPP) * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int b, int hq, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, b, hq, stream);
    case 32: return launch<T, 32>(a, b, hq, stream);
    case 64: return launch<T, 64>(a, b, hq, stream);
    case 128: return launch<T, 128>(a, b, hq, stream);
    case 256: return launch<T, 256>(a, b, hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, seq) strides of q, k, v and o in that order.  Returns the
// launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int hq, int hkv, int s, int t, int d,
                                   const long long* strides, int causal,
                                   float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.s = s;
  a.t = t;
  a.group = hq / hkv;
  a.q_offset = t - s;
  a.causal = causal;
  a.scale = scale;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(a, b, hq, d, st)
                    : dtype == 1
                        ? dispatch_d<__nv_bfloat16>(a, b, hq, d, st)
                        : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

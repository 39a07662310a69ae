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
// 0.07 us at 989 TFLOP/s.  So the work is bound by bytes: each K/V row must
// be read from device memory once and only once, in wide loads, by enough
// blocks in flight to fill the card.
//
// Design: one block of 4 warps per (split of `chunk` positions, kv head,
// batch row) serves all G = Hq / Hkv q heads of its kv head, so each K/V row
// is read once per group (the TPU grid (B, Hq, T/bk) reads it once per q
// head).  Splitting T (flash-decoding) gives B * Hkv * T / chunk blocks
// (512 at the path's shape, not 64); blocks whose split starts past the
// slot's length exit at once.  Inside a block each lane owns a 16-byte slice
// of a cache row (LPR lanes per row, 32 / LPR rows per warp load); a warp
// loads kUnroll rows per lane before it computes, which keeps 16 KB of
// K/V in flight per block.  The q slices live in registers; a row's G
// scores are reduced across its LPR lanes by warp shuffles; each lane keeps
// the online-softmax state (max, denominator, its D-slice of the G
// accumulators) of the rows it reads.  At the end the row groups of a warp
// merge by shuffles, the warps through shared memory, and the block writes
// the output (one split) or its partial state; a second kernel merges the
// splits of each (batch row, q head).  The arithmetic is fp32 on CUDA cores
// (about 0.25 flop per byte read: far below any compute limit).
// A block serves at most 8 q heads: a larger group (recurrentgemma's MQA
// layers, 16 q heads over 1 kv head) is cut into chunks of 8 along the
// grid's kv-head axis, each chunk reading the K/V rows once (the static
// shared merge buffer stays at 4 * 8 * D floats, 32 KB at D = 256).  A row
// wider than 32 16-byte slices (fp32 at D = 256) gives a lane two slices
// per row, and at D = 256 a lane loads 2 rows ahead instead of 4, which
// keeps the q, accumulator and load registers of 8 heads under the limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;            // rows a lane loads before computing
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;                    // (B, Hq, nsplit, D), nsplit > 1 only
  float* part_ml;                     // (B, Hq, nsplit, 2): max, denominator
  const int* lens;                    // (B,) int32 on the device, or null
  int len;                            // the length of every row if !lens
  int t, hq, group, chunk, nsplit;
  int gchunks;                        // blocks (chunks of <= 8 q heads) per kv head
  float scale;
  long long qsb, qsh, ksb, ksh, kst, vsb, vsh, vst, osb, osh;
};

// 16 loaded bytes -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& x, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& x,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ int row_length(const Args& a, int b) {
  const int len = a.lens != nullptr ? a.lens[b] : a.len;
  return min(max(len, 0), a.t);
}

template <typename T, int D, int KG>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int kLpr = D / kVec < 32 ? D / kVec : 32;   // lanes per row
  constexpr int kSl = D / (kVec * kLpr);  // 16-byte slices a lane loads a row
  constexpr int kEl = kSl * kVec;         // elements of a row a lane owns
  constexpr int kUn = D >= 256 ? 2 : kUnroll;   // rows a lane loads ahead
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
  const int k_begin = split * a.chunk;
  const int k_end = min(len, k_begin + a.chunk);
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
// the partial states of the splits that saw valid positions
template <typename T>
__global__ void flash_decode_combine_kernel(Args a, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n = (row_length(a, b) + a.chunk - 1) / a.chunk;
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

template <typename T, int D>
cudaError_t launch(const Args& a, int b, int hkv, cudaStream_t stream) {
  const dim3 grid(a.nsplit, hkv * a.gchunks, b);
  if (a.group <= 1)
    flash_decode_split_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(a);
  else if (a.group <= 2)
    flash_decode_split_kernel<T, D, 2><<<grid, kThreads, 0, stream>>>(a);
  else if (a.group <= 4)
    flash_decode_split_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(a);
  else
    flash_decode_split_kernel<T, D, 8><<<grid, kThreads, 0, stream>>>(a);
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
    case 128: return launch<T, 128>(a, b, hkv, stream);
    case 256: return launch<T, 256>(a, b, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lens: (B,) int32 device lengths, or
// null to use `len` for every row.  part_acc / part_ml: fp32 scratch of
// B * Hq * nsplit * D and B * Hq * nsplit * 2 floats (unused, may be null,
// when nsplit == 1).  strides: 10 element strides, the (batch, head) strides
// of q, the (batch, head, seq) strides of k and of v, and the (batch, head)
// strides of o.  Returns the launches' cudaError_t (0 on success); the
// caller raises on anything else.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* o, float* part_acc, float* part_ml,
                                const int* lens, int len, int dtype, int b,
                                int hq, int hkv, int t, int d, int chunk,
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
  a.gchunks = (a.group + 7) / 8;
  a.chunk = chunk;
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
  cudaError_t err = dtype == 0 ? dispatch_d<float>(a, b, hkv, d, st)
                    : dtype == 1
                        ? dispatch_d<__nv_bfloat16>(a, b, hkv, d, st)
                        : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Depthwise 2D convolution (channel multiplier 1) over a channels-last fp32
// activation, its padding taken inside the kernel, for sm_90a.
//
// Replaces no TPU kernel.  The reference's depthwise convolution
// (src/repro/models/layers.py, Builder.conv with feature_group_count = C)
// is an XLA convolution with SAME padding, which XLA lowers without ever
// writing a padded copy.  The port ran it as F.pad (a fill and an interior
// copy of the whole activation) and cuDNN's grouped route.  This kernel
// computes
//   y[n, oh, ow, c] = b[c] + sum_{i, j < k} x[n, oh * s - pt + i,
//                                            ow * s - pl + j, c] w[c, i, j]
// over x (N, H, W, C) and y (N, OH, OW, C) contiguous, w the (C, 1, k, k)
// parameter as stored (channels_last and contiguous coincide there: C
// rows of k * k taps), b null or C floats; taps that fall outside x add
// nothing, so no padded tensor is made.
//
// Bound: bytes.  k * k multiply-adds an output against x read and y written
// once: at k 3, 18 flops an output against 8 bytes (stride 1) or 20
// (stride 2), 0.9 to 2.25 FLOP a byte, far below the card's fp32 ridge of
// 20.  MobileNetV2's largest call, (256, 112, 112, 96) at stride 2, moves
// 1.54 GB: 0.46 ms at 3.35 TB/s.
//
// Design.  Channels are innermost, so a thread owns 4 consecutive channels
// and moves 16 bytes a load and a store, and the lanes of a warp hold
// consecutive channel quads, so a warp's loads of one input column are
// whole 128-byte lines.  A block serves one chunk of at most kQuads channel
// quads: it first copies the chunk's weights into shared memory with
// coalesced loads, tap-major ([tap][quad] float4s), so each thread then
// reads its 4 channels' taps with one conflict-free 16-byte load a tap (in
// the (C, k, k) weight a lane's taps lie 4 k^2 floats from its
// neighbour's, so loads from it would touch about 32 cache lines a warp a
// tap).  A thread computes a strip of kStrip output columns of one output
// row: for each of the k input rows it loads the strip's whole input
// window (10 float4s at stride 1 and k 3, for 8 outputs) before it
// multiplies any, so that all the row's loads are in flight at once, then
// adds each column into every output of the strip it reaches with the
// row's k taps.  The overlap of neighbouring strips and the halo rows
// that neighbouring output rows share are re-read from L1 and L2: the
// strips of a block are neighbours in (image, row, strip) order.  Only
// loads can fall outside x (the halo), so only they are predicated.
//
// Rounding: fp32 fused multiply-adds in the order (i, j), then + b.  The
// plain version's order may differ, by a few ulp of the output's scale.
//
// Indices are 32-bit: a call whose x or y holds 2^31 elements or more is
// refused.  The launch goes to the caller's stream on the caller's card
// (the current device is switched for the launch and back).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Output columns a thread computes.  Stride 1 at k 3 reads 10 input
// columns for 8 outputs; the others keep the window and the accumulators
// within the register file without spilling.
template <int K, int S>
constexpr int kStrip = (S == 1 && K == 3) ? 8 : 4;
// Channel quads a block serves: their taps in shared memory stay within
// 48 KB (64 x 25 x 16 bytes at k 5, 32 x 49 x 16 at k 7).
template <int K>
constexpr int kQuads = K <= 5 ? 64 : 32;

struct Shape {
  int h, w, c4;        // input rows, columns, channel quads
  int oh, ow;          // output rows, columns
  int pt, pl;          // padding before the rows and the columns
  int strips;          // strips of an output row
  int q;               // channel quads a block serves (its chunk)
  int per_block;       // strips a block computes: kThreads / q
  uint32_t items;      // n * oh * strips
};

__device__ __forceinline__ void fma4(float4& acc, const float4& v,
                                     const float4& w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads)
    dwconv_kernel(const float4* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float4* __restrict__ y,
                  Shape s) {
  constexpr int kW = kStrip<K, S>;
  constexpr int kIn = (kW - 1) * S + K;     // input columns under a strip
  constexpr int kTaps = K * K;
  __shared__ float4 taps[kTaps][kQuads<K>];

  // the chunk's weights, [tap][quad] from (channel, tap)
  const int q0 = blockIdx.y * s.q;
  const int nq = min(s.q, s.c4 - q0);
  const float* wq = w + q0 * 4 * kTaps;
  float* tf = reinterpret_cast<float*>(&taps[0][0]);
  for (int e = threadIdx.x; e < nq * 4 * kTaps; e += kThreads) {
    const int cc = e / kTaps, tap = e - cc * kTaps;
    tf[(tap * kQuads<K> + cc / 4) * 4 + cc % 4] = __ldg(wq + e);
  }
  __syncthreads();

  const int lq = threadIdx.x % s.q;         // the thread's quad in the chunk
  const int li = threadIdx.x / s.q;         // its strip in the block
  const uint32_t item = blockIdx.x * static_cast<uint32_t>(s.per_block) + li;
  if (li >= s.per_block || lq >= nq || item >= s.items) return;
  const int c4 = q0 + lq;
  const int strip = static_cast<int>(item % s.strips);
  const uint32_t r = item / s.strips;
  const int oh = static_cast<int>(r % s.oh);
  const int n = static_cast<int>(r / s.oh);
  const int ow0 = strip * kW;
  const int ih0 = oh * S - s.pt;
  const int iw0 = ow0 * S - s.pl;

  float4 acc[kW];
#pragma unroll
  for (int o = 0; o < kW; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int ih = ih0 + i;
    if (ih < 0 || ih >= s.h) continue;
    const float4* row = x + (n * s.h + ih) * s.w * s.c4 + c4;
    float4 win[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int iw = iw0 + j;
      win[j] = iw >= 0 && iw < s.w ? __ldg(row + iw * s.c4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 tap[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tap[j] = taps[i * K + j][lq];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
#pragma unroll
      for (int o = 0; o < kW; ++o) {
        const int jj = j - o * S;           // the tap this column is to o
        if (jj >= 0 && jj < K) fma4(acc[o], win[j], tap[jj]);
      }
    }
  }

  if (b != nullptr) {
    const float4 bias =
        make_float4(__ldg(b + 4 * c4), __ldg(b + 4 * c4 + 1),
                    __ldg(b + 4 * c4 + 2), __ldg(b + 4 * c4 + 3));
#pragma unroll
    for (int o = 0; o < kW; ++o) {
      acc[o].x += bias.x;
      acc[o].y += bias.y;
      acc[o].z += bias.z;
      acc[o].w += bias.w;
    }
  }
  float4* out = y + ((n * s.oh + oh) * s.ow + ow0) * s.c4 + c4;
#pragma unroll
  for (int o = 0; o < kW; ++o) {
    if (ow0 + o < s.ow) out[o * s.c4] = acc[o];
  }
}

template <int K, int S>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int n, Shape s, cudaStream_t st) {
  s.strips = (s.ow + kStrip<K, S> - 1) / kStrip<K, S>;
  const int chunks = (s.c4 + kQuads<K> - 1) / kQuads<K>;
  s.q = (s.c4 + chunks - 1) / chunks;
  s.per_block = kThreads / s.q;
  s.items = static_cast<uint32_t>(n) * s.oh * s.strips;   // < 2^31 / 4
  const dim3 grid((s.items + s.per_block - 1) / s.per_block, chunks);
  dwconv_kernel<K, S><<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(x), w, b, reinterpret_cast<float4*>(y),
      s);
  return cudaGetLastError();
}

template <int K>
cudaError_t with_k(const float* x, const float* w, const float* b, float* y,
                   int n, const Shape& s, int stride, cudaStream_t st) {
  return stride == 1 ? launch<K, 1>(x, w, b, y, n, s, st)
                     : launch<K, 2>(x, w, b, y, n, s, st);
}

bool on16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x: (n, h, w, c) floats, contiguous, on 16 bytes; wt: (c, k, k) floats;
// b: c floats or null; y: (n, oh, ow, c) floats, contiguous, on 16 bytes;
// k 3, 5 or 7; stride 1 or 2; pt, pl: the padding before the rows and the
// columns (0 <= pad < k); device: the card all of them lie on; stream: a
// stream of that card.  c % 4 == 0, and x and y each below 2^31 elements.
// Returns a cudaError_t (0: launched; cudaErrorInvalidValue for arguments
// out of range, before any launch).
extern "C" int dwconv_fwd(const void* x, const void* wt, const void* b,
                          void* y, int n, int h, int w, int c, int oh,
                          int ow, int k, int stride, int pt, int pl,
                          int device, void* stream) {
  const long long in = 1LL * n * h * w * c, out = 1LL * n * oh * ow * c;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0 || oh <= 0 ||
      ow <= 0 || (k != 3 && k != 5 && k != 7) ||
      (stride != 1 && stride != 2) || pt < 0 || pt >= k || pl < 0 ||
      pl >= k || in >= (1LL << 31) || out >= (1LL << 31) || !on16(x) ||
      !on16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, w, c / 4, oh, ow, pt, pl, 0, 0, 0, 0};
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      err = with_k<3>(xf, wf, bf, yf, n, s, stride, st);
      break;
    case 5:
      err = with_k<5>(xf, wf, bf, yf, n, s, stride, st);
      break;
    default:
      err = with_k<7>(xf, wf, bf, yf, n, s, stride, st);
      break;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

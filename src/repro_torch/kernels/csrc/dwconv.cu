// Depthwise 2D convolution (channel multiplier 1) over a channels-last fp32
// activation, its padding taken inside the kernel, and optionally the
// inference BatchNorm and the ReLU or ReLU6 after it, for sm_90a.
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
// nothing, so no padded tensor is made.  Given per-channel mean, var,
// gamma and beta (C floats each) and an activation (none, relu, relu6),
// the kernel then applies, in an epilogue on the accumulators,
//   y = act(((y - mean) * rsqrt(var + 1e-3)) * gamma + beta)
// which a separate csrc/bn_epilogue.cu launch would otherwise compute by
// reading y back and writing it again: the output is written once,
// already normalised and activated.
//
// Bound: bytes.  k * k multiply-adds an output against x read and y written
// once: at k 3, 18 flops an output against 8 bytes (stride 1) or 20
// (stride 2), 0.9 to 2.25 FLOP a byte, far below the card's fp32 ridge of
// 20.  MobileNetV2's largest call, (256, 112, 112, 96) at stride 2, moves
// 1.54 GB: 0.46 ms at 3.35 TB/s.  The epilogue adds 16 bytes a channel
// and 4 or 5 flops an output.
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
// The epilogue's per-channel values are staged once a block, beside the
// taps: the block copies its chunk's mean, inverse (rsqrt(var + 1e-3)),
// gamma and beta into shared memory ([value][quad] float4s) while it
// copies the taps, and a thread reads its 4 channels' values from there
// after the tap loop, when the window and the taps are dead.  So the
// strip's register budget is the one without the epilogue, the inverse is
// computed once a channel a block, and a thread's stores wait on no global
// load after its FMAs.
// The epilogue is a template flag (an instantiation with and one without
// it at each k and stride); the activation is a uniform kernel argument.
//
// Rounding: fp32 fused multiply-adds in the order (i, j), then + b.  The
// plain version's order may differ, by a few ulp of the output's scale.
// The epilogue is csrc/bn_epilogue.cuh's arithmetic, so the fused output
// equals this kernel's unfused output followed by bn_epilogue.cu's launch
// bit for bit.
//
// Indices are 32-bit: a call whose x or y holds 2^31 elements or more is
// refused.  The launch goes to the caller's stream on the caller's card
// (the current device is switched for the launch and back).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
// Blocks an SM the launch bounds ask for: a budget of 128 registers a
// thread, which ptxas fills with a row's window in flight.  Left to its
// own target it gave the k 3 stride 2 instantiation with the epilogue 56
// registers and issued a row's loads one after another: 25 to 28% slower
// than without the epilogue at MobileNetV2's stride-2 shapes, 0 to 4%
// with this budget.  128 registers spill in no instantiation; 85 (three
// blocks) spilled in some.
constexpr int kMinBlocks = 2;

// Output columns a thread computes.  Stride 1 at k 3 reads 10 input
// columns for 8 outputs; the others keep the window and the accumulators
// within the register file without spilling.
template <int K, int S>
constexpr int kStrip = (S == 1 && K == 3) ? 8 : 4;
// Channel quads a block serves: their taps and BN values in shared memory
// stay within 48 KB (64 x (25 + 4) x 16 bytes at k 5, 32 x (49 + 4) x 16
// at k 7).
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

// 4 consecutive floats of a per-channel vector, which may lie off 16 bytes
__device__ __forceinline__ float4 ldg4(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// the BN and the activation after it on one accumulator
__device__ __forceinline__ void bn4(float4& a, const float4* v, int act) {
  const float4 &mean = v[0], &inv = v[1], &gamma = v[2], &beta = v[3];
  a.x = bn::activate(bn::normalize(a.x, mean.x, inv.x, gamma.x, beta.x), act);
  a.y = bn::activate(bn::normalize(a.y, mean.y, inv.y, gamma.y, beta.y), act);
  a.z = bn::activate(bn::normalize(a.z, mean.z, inv.z, gamma.z, beta.z), act);
  a.w = bn::activate(bn::normalize(a.w, mean.w, inv.w, gamma.w, beta.w), act);
}

template <int K, int S, bool BN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dwconv_kernel(const float4* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float4* __restrict__ y,
                  bn::Channels ch, int act, Shape s) {
  constexpr int kW = kStrip<K, S>;
  constexpr int kIn = (kW - 1) * S + K;     // input columns under a strip
  constexpr int kTaps = K * K;
  __shared__ float4 taps[kTaps][kQuads<K>];
  // the chunk's BN values: [mean, inverse, gamma, beta][quad]
  __shared__ float4 bnv[BN ? 4 : 1][kQuads<K>];

  // the chunk's weights, [tap][quad] from (channel, tap)
  const int q0 = blockIdx.y * s.q;
  const int nq = min(s.q, s.c4 - q0);
  const float* wq = w + q0 * 4 * kTaps;
  float* tf = reinterpret_cast<float*>(&taps[0][0]);
  for (int e = threadIdx.x; e < nq * 4 * kTaps; e += kThreads) {
    const int cc = e / kTaps, tap = e - cc * kTaps;
    tf[(tap * kQuads<K> + cc / 4) * 4 + cc % 4] = __ldg(wq + e);
  }
  if (BN) {
    constexpr int kRow = 4 * kQuads<K>;     // floats of one value's row
    float* bf = reinterpret_cast<float*>(&bnv[0][0]);
    for (int e = threadIdx.x; e < nq * 4; e += kThreads) {
      const int c = q0 * 4 + e;
      bf[e] = __ldg(ch.mean + c);
      bf[kRow + e] = bn::inverse(__ldg(ch.var + c));
      bf[2 * kRow + e] = __ldg(ch.gamma + c);
      bf[3 * kRow + e] = __ldg(ch.beta + c);
    }
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
    const float4 bias = ldg4(b + 4 * c4);
#pragma unroll
    for (int o = 0; o < kW; ++o) {
      acc[o].x += bias.x;
      acc[o].y += bias.y;
      acc[o].z += bias.z;
      acc[o].w += bias.w;
    }
  }
  if (BN) {
    const float4 v[4] = {bnv[0][lq], bnv[1][lq], bnv[2][lq], bnv[3][lq]};
#pragma unroll
    for (int o = 0; o < kW; ++o) bn4(acc[o], v, act);
  }
  float4* out = y + ((n * s.oh + oh) * s.ow + ow0) * s.c4 + c4;
#pragma unroll
  for (int o = 0; o < kW; ++o) {
    if (ow0 + o < s.ow) out[o * s.c4] = acc[o];
  }
}

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  bn::Channels ch;     // all null: no epilogue
  int act;
  int n;
};

template <int K, int S>
cudaError_t launch(const Args& a, Shape s, cudaStream_t st) {
  s.strips = (s.ow + kStrip<K, S> - 1) / kStrip<K, S>;
  const int chunks = (s.c4 + kQuads<K> - 1) / kQuads<K>;
  s.q = (s.c4 + chunks - 1) / chunks;
  s.per_block = kThreads / s.q;
  s.items = static_cast<uint32_t>(a.n) * s.oh * s.strips;   // < 2^31 / 4
  const dim3 grid((s.items + s.per_block - 1) / s.per_block, chunks);
  const float4* x = reinterpret_cast<const float4*>(a.x);
  float4* y = reinterpret_cast<float4*>(a.y);
  if (a.ch.mean != nullptr)
    dwconv_kernel<K, S, true>
        <<<grid, kThreads, 0, st>>>(x, a.w, a.b, y, a.ch, a.act, s);
  else
    dwconv_kernel<K, S, false>
        <<<grid, kThreads, 0, st>>>(x, a.w, a.b, y, a.ch, a.act, s);
  return cudaGetLastError();
}

template <int K>
cudaError_t with_k(const Args& a, const Shape& s, int stride,
                   cudaStream_t st) {
  return stride == 1 ? launch<K, 1>(a, s, st) : launch<K, 2>(a, s, st);
}

bool on16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x: (n, h, w, c) floats, contiguous, on 16 bytes; wt: (c, k, k) floats;
// b: c floats or null; y: (n, oh, ow, c) floats, contiguous, on 16 bytes;
// mean, var, gamma, beta: c floats each, all four or none (null: no
// epilogue); act 0 (none), 1 (relu) or 2 (relu6), and 0 without the
// epilogue; k 3, 5 or 7; stride 1 or 2; pt, pl: the padding before the
// rows and the columns (0 <= pad < k); device: the card all of them lie
// on; stream: a stream of that card.  c % 4 == 0, and x and y each below
// 2^31 elements.  Returns a cudaError_t (0: launched;
// cudaErrorInvalidValue for arguments out of range, before any launch).
extern "C" int dwconv_fwd(const void* x, const void* wt, const void* b,
                          void* y, const void* mean, const void* var,
                          const void* gamma, const void* beta, int act,
                          int n, int h, int w, int c, int oh, int ow, int k,
                          int stride, int pt, int pl, int device,
                          void* stream) {
  const long long in = 1LL * n * h * w * c, out = 1LL * n * oh * ow * c;
  const int given = (mean != nullptr) + (var != nullptr) +
                    (gamma != nullptr) + (beta != nullptr);
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 4 != 0 || oh <= 0 ||
      ow <= 0 || (k != 3 && k != 5 && k != 7) ||
      (stride != 1 && stride != 2) || pt < 0 || pt >= k || pl < 0 ||
      pl >= k || in >= (1LL << 31) || out >= (1LL << 31) || !on16(x) ||
      !on16(y) || (given != 0 && given != 4) || act < bn::kNone ||
      act > bn::kRelu6 || (given == 0 && act != bn::kNone))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, w, c / 4, oh, ow, pt, pl, 0, 0, 0, 0};
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(wt),
               static_cast<const float*>(b),
               static_cast<float*>(y),
               {static_cast<const float*>(mean),
                static_cast<const float*>(var),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta)},
               act,
               n};
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      err = with_k<3>(a, s, stride, st);
      break;
    case 5:
      err = with_k<5>(a, s, stride, st);
      break;
    default:
      err = with_k<7>(a, s, stride, st);
      break;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Inference BatchNorm, the residual add and the activation after it, in one
// pass over a channels-last fp32 activation, for sm_90a.
//
// Replaces no TPU kernel.  The reference's BN (src/repro/models/layers.py,
// Builder.bn) is plain jnp, which XLA fuses with the add and the activation
// after it.  The port's eager PyTorch ran the same arithmetic as six
// launches (rsqrt(var + eps), then sub, mul, mul and add over the whole
// activation, four of them through the broadcast route) and two more full
// passes for the residual add and the ReLU.  This kernel is the fusion XLA
// made:
//   y = act(((x - mean) * rsqrt(var + 1e-3)) * gamma + beta [+ r])
// over x, r and y contiguous (..., C), per-channel mean, var, gamma and
// beta of C floats each, and act none, relu or relu6.
//
// Bound: bytes.  x read and y written once, r read once where there is
// one: 8 (12) bytes an element against 4 to 6 operations, at 3.35 TB/s.
// ResNet50's largest BN (32 x 112 x 112 x 64) moves 205.5 MB: 0.0614 ms.
//
// Rounding: the eager chain's, bit for bit on finite inputs up to the sign
// of a zero: the arithmetic of csrc/bn_epilogue.cuh (which dwconv.cu's
// epilogue shares), then __fadd_rn with r, which nvcc never contracts into
// an FMA.  ReLU and ReLU6 pass a NaN through, as torch.relu and
// torch.clamp do.
//
// Design.  The vector route (C % 4 == 0; x, r and y on 16 bytes) gives each
// thread kUnroll 16-byte chunks a block's width apart, issues all their
// loads before computing any, and stores 16 bytes a chunk.  A chunk's four
// channels start at its index modulo C / 4; their values come through the
// read-only cache (__ldg), where the few KB of per-channel values stay hot
// while the activation streams past.  The scalar route takes one element a
// thread, for any C and any alignment.  Indices are 32-bit: a call of 2^31
// elements or more is refused (ResNet50's largest BN at the benchmark's
// microbatch is 25.7 M).  The launch goes to the caller's stream on the
// caller's card (the current device is switched for the launch and back).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_epilogue.cuh"

namespace {

using bn::Channels;
using bn::kNone;
using bn::kRelu;
using bn::kRelu6;

constexpr int kThreads = 256;
constexpr int kUnroll = 2;            // 16-byte chunks a thread (vector route)

__device__ __forceinline__ float normalize(float x, const Channels& ch,
                                           int c) {
  return bn::normalize(x, __ldg(ch.mean + c), bn::inverse(__ldg(ch.var + c)),
                       __ldg(ch.gamma + c), __ldg(ch.beta + c));
}

template <int A, bool R>
__device__ __forceinline__ float finish(float v, float r) {
  if (R) v = __fadd_rn(v, r);
  return bn::activate(v, A);
}

template <int A, bool R>
__global__ void __launch_bounds__(kThreads)
    bn_epilogue_vec_kernel(const float4* __restrict__ x,
                           const float4* __restrict__ r,
                           float4* __restrict__ y, Channels ch, uint32_t n4,
                           uint32_t c4) {
  const uint32_t base = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  float4 v[kUnroll], s[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const uint32_t i = base + k * kThreads;
    if (i < n4) {
      v[k] = __ldg(x + i);
      if (R) s[k] = __ldg(r + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const uint32_t i = base + k * kThreads;
    if (i < n4) {
      const int c = static_cast<int>(i % c4) * 4;
      float4 o;
      o.x = finish<A, R>(normalize(v[k].x, ch, c), R ? s[k].x : 0.f);
      o.y = finish<A, R>(normalize(v[k].y, ch, c + 1), R ? s[k].y : 0.f);
      o.z = finish<A, R>(normalize(v[k].z, ch, c + 2), R ? s[k].z : 0.f);
      o.w = finish<A, R>(normalize(v[k].w, ch, c + 3), R ? s[k].w : 0.f);
      y[i] = o;
    }
  }
}

template <int A, bool R>
__global__ void __launch_bounds__(kThreads)
    bn_epilogue_scalar_kernel(const float* __restrict__ x,
                              const float* __restrict__ r,
                              float* __restrict__ y, Channels ch, uint32_t n,
                              uint32_t c) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    y[i] = finish<A, R>(normalize(__ldg(x + i), ch, static_cast<int>(i % c)),
                        R ? __ldg(r + i) : 0.f);
  }
}

struct Args {
  const float* x;
  const float* r;
  float* y;
  Channels ch;
  uint32_t n;
  int c;
  bool vec;
};

template <int A, bool R>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (a.vec) {
    const uint32_t n4 = a.n / 4;
    const uint32_t per = kThreads * kUnroll;
    bn_epilogue_vec_kernel<A, R><<<(n4 + per - 1) / per, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a.x),
        reinterpret_cast<const float4*>(a.r), reinterpret_cast<float4*>(a.y),
        a.ch, n4, static_cast<uint32_t>(a.c / 4));
  } else {
    bn_epilogue_scalar_kernel<A, R>
        <<<(a.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
            a.x, a.r, a.y, a.ch, a.n, static_cast<uint32_t>(a.c));
  }
  return cudaGetLastError();
}

template <int A>
cudaError_t with_act(const Args& a, cudaStream_t st) {
  return a.r ? launch<A, true>(a, st) : launch<A, false>(a, st);
}

cudaError_t with_args(const Args& a, int act, cudaStream_t st) {
  switch (act) {
    case kRelu:
      return with_act<kRelu>(a, st);
    case kRelu6:
      return with_act<kRelu6>(a, st);
    default:
      return with_act<kNone>(a, st);
  }
}

bool on16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x, r (or null) and y: n floats, contiguous (n / c, c); mean, var, gamma,
// beta: c floats each; act 0 (none), 1 (relu) or 2 (relu6); device: the
// card all of them lie on; stream: a stream of that card.  n must be below
// 2^31.  Returns a cudaError_t (0: launched; cudaErrorInvalidValue for
// arguments out of range, before any launch).
extern "C" int bn_epilogue_fwd(const void* x, const void* r, void* y,
                               const void* mean, const void* var,
                               const void* gamma, const void* beta,
                               long long n, int c, int act, int device,
                               void* stream) {
  if (n < 0 || n >= (1LL << 31) || c <= 0 || n % c != 0 || act < kNone ||
      act > kRelu6)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{static_cast<const float*>(x),
         static_cast<const float*>(r),
         static_cast<float*>(y),
         {static_cast<const float*>(mean), static_cast<const float*>(var),
          static_cast<const float*>(gamma), static_cast<const float*>(beta)},
         static_cast<uint32_t>(n),
         c,
         c % 4 == 0 && on16(x) && on16(y) && (r == nullptr || on16(r))};
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = with_args(a, act, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

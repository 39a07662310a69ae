// Inference BatchNorm's arithmetic and the activations after it, on one
// fp32 value: the code that csrc/bn_epilogue.cu and csrc/dwconv.cu's
// epilogue share, so that the two round alike bit for bit.
//
//   y = act(((x - mean) * rsqrt(var + 1e-3)) * gamma + beta)
//
// Each step is its own correctly rounded intrinsic (__fsub_rn, __fmul_rn,
// __fmul_rn, __fadd_rn), which nvcc never contracts into an FMA: the eager
// chain's rounding, bit for bit on finite inputs up to the sign of a zero.
// The inverse is rsqrtf of var + 1e-3f, the call PyTorch's CUDA rsqrt
// makes.  ReLU and ReLU6 pass a NaN through, as torch.relu and
// torch.clamp do.
#pragma once

#include <cuda_runtime.h>

namespace bn {

constexpr float kEps = 1e-3f;
// activation codes, as the C entries take them
constexpr int kNone = 0, kRelu = 1, kRelu6 = 2;

// the per-channel vectors, C floats each
struct Channels {
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
};

__device__ __forceinline__ float inverse(float var) {
  return rsqrtf(__fadd_rn(var, kEps));
}

__device__ __forceinline__ float normalize(float x, float mean, float inv,
                                           float gamma, float beta) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), gamma),
                   beta);
}

// act is a template argument at one call site and a uniform kernel
// argument at the other
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return v < 0.f ? 0.f : v;
  if (act == kRelu6) return v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
  return v;
}

}  // namespace bn

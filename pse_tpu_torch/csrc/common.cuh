// Shared helpers of the port's CUDA kernels (plain C interface, loaded with
// ctypes by pse_tpu_torch/kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element stores for the two storage types of coefficient arrays.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The real-space pair functions (UF1, UF2) of chebyshev.eval_pair_functions
// at a valid d^2, from the operand of chebyshev.device_coeffs (the affine
// maps of the two pieces, then the coefficient rows uf1_lo, uf2_lo, uf1_hi,
// uf2_hi): the branch select at r = 2a, a true division for t, and the two
// Clenshaw recurrences rounded step by step as they are there (no fused
// multiply-add), so that a float32 build is its plain version bit for bit.
// On the H100 those roundings cost about 0.01 ms of the banded build
// (pse_tpu_torch/ab.py --contract times them against contracted FMAs; 0.044
// ms when every pair evaluated them).  Returns sqrt(d^2), the distance they
// were evaluated at.  NC: the number of coefficients, or 0 to take n.
template <int NC>
__device__ __forceinline__ float pair_functions(const float* cf, int n,
                                                float mid, float d2,
                                                float& uf1, float& uf2) {
  if (NC > 0) n = NC;
  const float dist = sqrtf(d2);
  const bool in_lo = dist < mid;
  const float* ab = cf + (in_lo ? 0 : 2);
  const float t = (2.f * dist - ab[0]) / ab[1];
  const float* c1 = cf + 4 + (in_lo ? 0 : 2 * n);
  const float* c2 = c1 + n;
  const float t2 = 2.f * t;
  float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll 8
  for (int k = n - 1; k > 0; --k) {
    const float na = __fsub_rn(__fadd_rn(c1[k], __fmul_rn(t2, a1)), a2);
    const float nb = __fsub_rn(__fadd_rn(c2[k], __fmul_rn(t2, b1)), b2);
    a2 = a1;
    a1 = na;
    b2 = b1;
    b1 = nb;
  }
  uf1 = __fsub_rn(__fadd_rn(c1[0], __fmul_rn(t, a1)), a2);
  uf2 = __fsub_rn(__fadd_rn(c2[0], __fmul_rn(t, b1)), b2);
  return dist;
}

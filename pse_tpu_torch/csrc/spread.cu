// Z-column far-field spread: slot forces -> per-column window moments.
//
// Replaces the Pallas kernel pse_tpu/ops/column_farfield.py:417
// `_spread_kernel` (launched by `spread_col_pallas`, :454).  Per column c of
// the far-field grid (cap particle slots p, NN = 9 sx sy window xy nodes n,
// M = 3 Nz (component, z) pairs m = k Nz + z):
//     X[c, m, p]   = round_WT((prefac * f[k, c, p]) * wz[c, z, p])
//     out[c, n, m] = sum_p wxy[c, n, p] * X[c, m, p]
// X is an f32 product rounded once to the factor dtype WT, the rounding
// point of the plain version (column_farfield.spread_moments) and of the JAX
// package; products and sums are f32.  The xy overlap-add onto the grid
// stays in torch (column_farfield._windows_to_grid), as in the JAX package.
//
// What bounds it on the H100: at bench scale (C = 576, NN = 144, Nz = 96,
// cap 248, bf16 factors) it reads wxy 41.1 MB + wz 27.4 MB + f 1.7 MB and
// writes 95.6 MB of moments, ~50 us at 3.35 TB/s; the 2 x 576 x 144 x 288 x
// 248 ~ 11.9 GFLOP take ~12 us on bf16 tensor cores but ~0.18 ms at the
// 67 TFLOP/s float32 CUDA-core rate, so on CUDA cores it is bound by
// operations (tensor cores are later work).
//
// Design: one small GEMM per column.  A block computes a BM x BN tile of
// out[c] (grid (ceil(M/BN), ceil(NN/BM), C)); it walks p in chunks of BK,
// staging the wxy chunk and the X chunk (built from f and wz on the fly, so
// X never reaches device memory) in shared memory as f32.  Each of the 256
// threads owns a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j:
// conflict-free shared reads, coalesced stores).  Every output element is
// summed by one thread over p in ascending order, so reruns are bitwise
// equal; ragged edges (no shape here is a tile multiple) are masked.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;

template <typename WT>
__global__ void __launch_bounds__(THREADS)
    spread_kernel(const float* __restrict__ f, const WT* __restrict__ wxy,
                  const WT* __restrict__ wz, int C, int NN, int Nz, int cap,
                  float prefac, float* __restrict__ out) {
  // p-major chunks, rows padded by one word against bank conflicts
  __shared__ float As[BK][BM + 1];  // wxy chunk
  __shared__ float Bs[BK][BN + 1];  // X chunk
  const int c = blockIdx.z;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int M = 3 * Nz;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long CP = (long long)C * cap;
  const WT* wxy_c = wxy + (long long)c * NN * cap;
  const WT* wz_c = wz + (long long)c * Nz * cap;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < cap; p0 += BK) {
    // each thread stages 4 elements of each tile; consecutive threads take
    // consecutive p of one row (contiguous in device memory)
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx % BK, r = idx / BK;
      const int p = p0 + kk;
      const int n = n0 + r, m = m0 + r;
      As[kk][r] = (n < NN && p < cap) ? to_f32(wxy_c[(long long)n * cap + p])
                                      : 0.f;
      float x = 0.f;
      if (m < M && p < cap) {
        const int k = m / Nz, z = m - k * Nz;
        const float fp = __fmul_rn(f[k * CP + (long long)c * cap + p], prefac);
        x = round_to<WT>(
            __fmul_rn(fp, to_f32(wz_c[(long long)z * cap + p])));
      }
      Bs[kk][r] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out_c = out + (long long)c * NN * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= NN) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < M) out_c[(long long)n * M + m] = acc[i][j];
    }
  }
}

template <typename WT>
cudaError_t launch(const float* f, const void* wxy, const void* wz, int C,
                   int NN, int Nz, int cap, float prefac, float* out,
                   cudaStream_t stream) {
  dim3 grid((3 * Nz + BN - 1) / BN, (NN + BM - 1) / BM, C);
  spread_kernel<WT><<<grid, THREADS, 0, stream>>>(
      f, static_cast<const WT*>(wxy), static_cast<const WT*>(wz), C, NN, Nz,
      cap, prefac, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pse_spread_col(const float* f, const void* wxy, const void* wz,
                              int w_bf16, int C, int NN, int Nz, int cap,
                              float prefac, float* out, cudaStream_t stream) {
  if (C > 65535) return (int)cudaErrorInvalidValue;  // grid.z limit
  cudaError_t e =
      w_bf16 ? launch<__nv_bfloat16>(f, wxy, wz, C, NN, Nz, cap, prefac, out,
                                     stream)
             : launch<float>(f, wxy, wz, C, NN, Nz, cap, prefac, out, stream);
  return (int)e;
}

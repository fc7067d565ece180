// Z-column far-field contract: grid velocities -> particle velocities.
//
// Replaces the Pallas kernel pse_tpu/ops/column_farfield.py:307
// `_contract_kernel` (launched by `contract_col_pallas`, :392).  Per column c
// of the far-field grid, with G its 3x3 xy window of (sx, sy) node blocks
// (offset-major node order n = ((dx*3 + dy)*sx + ix)*sy + iy, as
// build_col_factors orders wxy):
//     u[k, c, p] = scale * sum_z wz[c, z, p] * sum_n G[n, k, z] * wxy[c, n, p]
// G is rounded to the factor dtype as the TPU kernel does; products and sums
// are float32, and H = G^T wxy never leaves registers (the plain version,
// contract_col, materializes and rounds it).
//
// What bounds it on the H100: at bench scale (C = 576, 144 nodes, Nz = 96,
// cap 248, bf16 factors) it must read wxy 41.1 MB, wz 27.4 MB and the grid
// 10.6 MB, ~24 us at 3.35 TB/s, but it does 2 x 576 x 144 x 288 x 248
// ~ 11.9 GFLOP, ~0.18 ms at the 67 TFLOP/s float32 CUDA-core rate: on the
// CUDA cores it is bound by operations (tensor cores are later work).
//
// Design: one block per column, one thread per particle slot p.  The column's
// window of the grid is staged in shared memory ZC z-planes at a time, read
// by every thread as broadcasts; each thread keeps its 3 x ZC partial H in
// registers, streams its wxy column (coalesced across p, re-read from L2 once
// per z-chunk), and contracts each chunk against wz before the next.
#include "common.cuh"

namespace {

constexpr int ZC = 16;

template <typename WT>
__global__ void contract_kernel(const float* __restrict__ grid,
                                const WT* __restrict__ wxy,
                                const WT* __restrict__ wz, int ncx, int ncy,
                                int sx, int sy, int Nx, int Ny, int Nz,
                                int cap, float scale, float* __restrict__ u) {
  extern __shared__ float g[];  // NN x 3 x ZC window slab
  const int c = blockIdx.x;
  const int C = ncx * ncy;
  const int NN = 9 * sx * sy;
  const int bx = c / ncy, by = c % ncy;

  for (int p0 = 0; p0 < cap; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < cap;
    float u0 = 0.f, u1 = 0.f, u2 = 0.f;
    for (int z0 = 0; z0 < Nz; z0 += ZC) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < NN * 3 * ZC; idx += blockDim.x) {
        const int z = idx % ZC;
        const int k = (idx / ZC) % 3;
        const int n = idx / (3 * ZC);
        float v = 0.f;
        if (z0 + z < Nz) {
          const int iy = n % sy, ix = (n / sy) % sx, o = n / (sx * sy);
          const int gx = ((bx + o / 3 - 1 + ncx) % ncx) * sx + ix;
          const int gy = ((by + o % 3 - 1 + ncy) % ncy) * sy + iy;
          v = round_to<WT>(
              grid[(((long long)k * Nx + gx) * Ny + gy) * Nz + z0 + z]);
        }
        g[idx] = v;
      }
      __syncthreads();
      if (active) {
        float hk[3][ZC];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int z = 0; z < ZC; ++z) hk[k][z] = 0.f;
        const WT* wcol = wxy + (long long)c * NN * cap + p;
        for (int n = 0; n < NN; ++n) {
          const float w = to_f32(wcol[(long long)n * cap]);
          const float* gn = g + n * 3 * ZC;
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int z = 0; z < ZC; ++z) hk[k][z] += gn[k * ZC + z] * w;
        }
        const WT* wzc = wz + ((long long)c * Nz + z0) * cap + p;
#pragma unroll
        for (int z = 0; z < ZC; ++z) {
          if (z0 + z < Nz) {
            const float wv = to_f32(wzc[(long long)z * cap]);
            u0 += hk[0][z] * wv;
            u1 += hk[1][z] * wv;
            u2 += hk[2][z] * wv;
          }
        }
      }
    }
    if (active) {
      const long long o = (long long)c * cap + p;
      const long long plane = (long long)C * cap;
      u[o] = scale * u0;
      u[plane + o] = scale * u1;
      u[2 * plane + o] = scale * u2;
    }
  }
}

template <typename WT>
cudaError_t launch(const float* grid, const void* wxy, const void* wz, int ncx,
                   int ncy, int sx, int sy, int Nx, int Ny, int Nz, int cap,
                   float scale, float* u, cudaStream_t stream) {
  auto kernel = contract_kernel<WT>;
  const size_t smem = sizeof(float) * 9 * sx * sy * 3 * ZC;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int threads = ((cap + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  kernel<<<ncx * ncy, threads, smem, stream>>>(
      grid, static_cast<const WT*>(wxy), static_cast<const WT*>(wz), ncx, ncy,
      sx, sy, Nx, Ny, Nz, cap, scale, u);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pse_contract_col(const float* grid, const void* wxy,
                                const void* wz, int w_bf16, int ncx, int ncy,
                                int sx, int sy, int Nx, int Ny, int Nz,
                                int cap, float scale, float* u,
                                cudaStream_t stream) {
  cudaError_t e =
      w_bf16 ? launch<__nv_bfloat16>(grid, wxy, wz, ncx, ncy, sx, sy, Nx, Ny,
                                     Nz, cap, scale, u, stream)
             : launch<float>(grid, wxy, wz, ncx, ncy, sx, sy, Nx, Ny, Nz, cap,
                             scale, u, stream);
  return (int)e;
}

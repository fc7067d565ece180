// Z-column far-field spread: slot forces -> per-column window moments.
//
// Replaces the Pallas kernel pse_tpu/ops/column_farfield.py:417
// `_spread_kernel` (launched by `spread_col_pallas`, :454).  Per column c of
// the far-field grid (cap particle slots p, NN = 9 sx sy window xy nodes n,
// 3 Nz (component, z) pairs):
//     out[c, n, (k, z)] = sum_p wxy[c, n, p] (prefac f[k, c, p]) wz[c, z, p]
// with float32 factors that the kernel computes itself from the slots'
// node-space coordinates (column_farfield.spread_nodes, and _factors_f32's
// float32 operations with centred node offsets, expf for torch.exp),
// whatever dtype the contract's stored factors have: one product in bf16
// loses the cancellation between the particles' Gaussians that M F of a
// dense, nearly uniform suspension rests on (PERF.md).  The xy overlap-add
// onto the grid stays in torch (column_farfield._windows_to_grid), as in
// the JAX package.
//
// It sums only what the Gaussians reach in z: a block takes one column c
// and a chunk of ZC z nodes, selects (in slot order, by ballots and a scan)
// the occupied slots whose z lies within R + 1/2 nodes of the chunk, where
// R (_z_reach) puts every term left out below 2^-30 of its slot's largest,
// and has each thread sum, over those slots in order, the moments of one z
// node and up to MAXJ window nodes n, 3 components each, in f32 FMAs.  Per
// batch of LB selected slots, the block stages in shared memory the slots'
// x and y offsets from the window's nodes (3 sx + 3 sy a slot), then wxy[n]
// (9 sx sy a slot, from those offsets) and X = (prefac f) wz (3 ZC a slot).
// At the 1M cell's shapes (C = 2916, NN = 144, Nz = 216, ZC = 16, R = 5) a
// slot joins ~1.7 chunks, so a block sums ~43 slots where a dense product
// over the column sums cap = 440; it takes 2.87 ms a launch there, against
// 3.08 for the bf16 tensor-core product it replaced (PERF.md).  No float
// atomics: every output has one writer summing in slot order, so reruns
// are bitwise equal.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LB = 32;     // selected slots staged per batch
constexpr int MAXJ = 12;   // window nodes summed by one thread at most

struct Args {
  const float* f;       // (3, C, cap) slot forces, zero in pad slots
  const float* nodes;   // (4, C, cap) node-space x, y, z and the slot mask
  float* out;           // (C, NN, 3 Nz) moments
  int ncx, ncy, sx, sy, Nx, Ny, Nz, cap, R, zc, nzc;
  float Lx, Ly, Lz, tilt, nexp, prefac;   // nexp = -expfac
};

// L (node - pf) / N at the nearest image, as column_farfield._node_delta
// rounds it: the slot's offset from its nearest node k and the integer
// node - k are exact, so only the small difference is rounded
__device__ __forceinline__ float delta(int node, float pf, int N, float L) {
  const float k = rintf(pf), n = (float)N;
  float o = __fsub_rn((float)node, k);
  o = __fsub_rn(o, __fmul_rn(n, rintf(__fdiv_rn(o, n))));
  return __fmul_rn(L, __fdiv_rn(__fsub_rn(o, __fsub_rn(pf, k)), n));
}

__global__ void __launch_bounds__(THREADS, 3) spread_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int NN = 9 * a.sx * a.sy, ZC = a.zc, NG = THREADS / ZC;
  const int WX = 3 * a.sx, WY = 3 * a.sy;            // window nodes per axis
  float* s_w = sm;                                   // [LB][NN]
  float* s_x = s_w + LB * NN;                        // [LB][3][ZC]
  float* s_d = s_x + LB * 3 * ZC;                    // [LB][WX + WY]
  int* s_sel = reinterpret_cast<int*>(s_d + LB * (WX + WY));   // [cap]
  int* s_cnt = s_sel + a.cap;                        // [THREADS / 32 + 1]
  const int c = blockIdx.x / a.nzc, z0 = blockIdx.x % a.nzc * ZC;
  const int zn = min(ZC, a.Nz - z0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long CP = (long long)a.ncx * a.ncy * a.cap;
  const float* px = a.nodes + (long long)c * a.cap;
  const float* py = px + CP;
  const float* pz = py + CP;
  const float* pm = pz + CP;
  const int bx = c / a.ncy, by = c % a.ncy;

  // the occupied slots, in slot order, within R + 1/2 nodes of the chunk
  const float half = 0.5f * (float)(zn - 1), mid = (float)z0 + half;
  int n_sel = 0;
  for (int base = 0; base < a.cap; base += THREADS) {
    const int p = base + tid;
    bool take = false;
    if (p < a.cap && pm[p] != 0.f) {
      float d = fabsf(mid - pz[p]);
      d = fminf(d, (float)a.Nz - d);
      take = d - half <= (float)a.R + 0.5f;
    }
    const unsigned b = __ballot_sync(0xffffffffu, take);
    if (lane == 0) s_cnt[warp] = __popc(b);
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        const int v = s_cnt[w];
        s_cnt[w] = sum;
        sum += v;
      }
      s_cnt[THREADS / 32] = sum;
    }
    __syncthreads();
    if (take) s_sel[n_sel + s_cnt[warp] + __popc(b & ((1u << lane) - 1u))] = p;
    n_sel += s_cnt[THREADS / 32];
    __syncthreads();
  }

  const int zl = tid % ZC, ng = tid / ZC;
  float acc[MAXJ][3];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;

  for (int b0 = 0; b0 < n_sel; b0 += LB) {
    const int nb = min(LB, n_sel - b0);
    // each slot's x and y offsets from the window's nodes (dxo, dyo)
    for (int q = tid; q < nb * (WX + WY); q += THREADS) {
      const int i = q / (WX + WY), e = q - i * (WX + WY), p = s_sel[b0 + i];
      s_d[q] = e < WX ? delta((bx - 1) * a.sx + e, px[p], a.Nx, a.Lx)
                      : delta((by - 1) * a.sy + e - WX, py[p], a.Ny, a.Ly);
    }
    __syncthreads();
    for (int q = tid; q < nb * NN; q += THREADS) {
      const int i = q / NN, n = q - i * NN;
      const int o = n / (a.sx * a.sy), r = n - o * (a.sx * a.sy);
      const int ox = o / 3, oy = o - ox * 3, ix = r / a.sy, iy = r - ix * a.sy;
      const float* d = s_d + i * (WX + WY);
      const float dxo = d[ox * a.sx + ix], dyo = d[WX + oy * a.sy + iy];
      const float dx = __fadd_rn(dxo, __fmul_rn(a.tilt, dyo));
      s_w[q] = expf(__fmul_rn(a.nexp, __fadd_rn(__fmul_rn(dx, dx),
                                                 __fmul_rn(dyo, dyo))));
    }
    for (int q = tid; q < nb * ZC; q += THREADS) {
      const int i = q / ZC, z = q - i * ZC, p = s_sel[b0 + i];
      float wz = 0.f;
      if (z < zn) {
        const float dz = delta(z0 + z, pz[p], a.Nz, a.Lz);
        wz = __fmul_rn(expf(__fmul_rn(__fmul_rn(a.nexp, dz), dz)), pm[p]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s_x[(i * 3 + k) * ZC + z] = __fmul_rn(
            __fmul_rn(a.f[((long long)k * a.ncx * a.ncy + c) * a.cap + p],
                      a.prefac),
            wz);
    }
    __syncthreads();
    for (int i = 0; i < nb; ++i) {
      const float x0 = s_x[(i * 3) * ZC + zl];
      const float x1 = s_x[(i * 3 + 1) * ZC + zl];
      const float x2 = s_x[(i * 3 + 2) * ZC + zl];
      const float* w = s_w + i * NN;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int n = ng + j * NG;
        if (n < NN) {
          const float wn = w[n];
          acc[j][0] = __fmaf_rn(wn, x0, acc[j][0]);
          acc[j][1] = __fmaf_rn(wn, x1, acc[j][1]);
          acc[j][2] = __fmaf_rn(wn, x2, acc[j][2]);
        }
      }
    }
    __syncthreads();
  }

  if (zl < zn) {
    const int M = 3 * a.Nz;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int n = ng + j * NG;
      if (n < NN) {
        float* row = a.out + ((long long)c * NN + n) * M + z0 + zl;
        row[0] = acc[j][0];
        row[a.Nz] = acc[j][1];
        row[2 * a.Nz] = acc[j][2];
      }
    }
  }
}

cudaError_t launch(Args a, cudaStream_t stream) {
  const int NN = 9 * a.sx * a.sy;
  // the widest z chunk (a power of two up to 32) whose window nodes fit
  // MAXJ a thread
  int zc = 32;
  while (zc > 1 && (NN + THREADS / zc - 1) / (THREADS / zc) > MAXJ) zc /= 2;
  if ((NN + THREADS / zc - 1) / (THREADS / zc) > MAXJ)
    return cudaErrorInvalidValue;
  a.zc = zc;
  a.nzc = (a.Nz + zc - 1) / zc;
  const long long blocks = (long long)a.ncx * a.ncy * a.nzc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)LB * NN + (size_t)LB * 3 * zc +
                       (size_t)LB * 3 * (a.sx + a.sy)) +
      sizeof(int) * ((size_t)a.cap + THREADS / 32 + 1);
  cudaError_t e = allow_smem(spread_kernel, smem);
  if (e != cudaSuccess) return e;
  spread_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pse_spread_col(const float* f, const float* nodes, int ncx,
                              int ncy, int sx, int sy, int Nx, int Ny, int Nz,
                              int cap, float Lx, float Ly, float Lz,
                              float tilt, float nexp, float prefac, int R,
                              float* out, cudaStream_t stream) {
  Args a{f, nodes, out, ncx, ncy, sx, sy, Nx, Ny, Nz, cap, R, 0, 0,
         Lx, Ly, Lz, tilt, nexp, prefac};
  return (int)launch(a, stream);
}

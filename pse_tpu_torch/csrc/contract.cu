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
// 10.6 MB, ~24 us at 3.35 TB/s; its 2 x 576 x 144 x 288 x 248 ~ 11.9 GFLOP
// take ~12 us on bf16 tensor cores, so it is bound by bytes.
//
// bf16 factors (the main path): per column the tensor-core product
// H[(k, z), p] = sum_n G^T[(k, z), n] wxy[n, p] (mma.sync m16n8k16), the
// spread's transpose.  A block of 12 warps owns one column and 256 slots p
// (at bench scale the whole column, so its window of the grid is gathered
// once).  It walks H in chunks of 96 z rows of one component k (z chunks
// outer, k inner, so a chunk's wz rows serve all three components) and,
// inside each, the window nodes n in stages of 48, three in flight: the G
// stage is gathered from the float32 grid by 16-byte cp.async (the window's
// wraps from a per-node offset table in shared memory) and its A fragments
// are rounded to bf16 as they are read (row stride 100 words: conflict-
// free); the wxy stage streams in by cp.async and gives its B fragments
// through ldmatrix.trans.  When the window has at most 144 nodes (bench
// scale) wxy is loaded with the first chunk and kept, so it is read from
// device memory once.  At the end of a chunk each thread contracts its
// accumulators against the chunk's wz rows (staged in shared memory with
// the chunk's first stage), so H stays in float32 and never reaches memory,
// sums them over the warp's row groups by a fixed-order shuffle and adds
// them to its row warp's partials; after the last chunk the three row
// warps' partials are summed in order.  Ragged edges (NN, Nz and cap need
// not be tile multiples: 729 x 27 x 312 at the oracle's shapes, a window
// that wraps onto itself) are zero-filled in the staging, never masked in
// the products; a cap that is not a multiple of 8, an Nz that is not a
// multiple of 4 or an unaligned operand stages through scalar loads.  Every
// output has one writer and a fixed order of sums, so reruns are bitwise
// equal.
//
// float32 factors (error < 1e-3, or asked for) stay on the CUDA cores, where
// the product is bound by operations (~0.18 ms at 67 TFLOP/s): TF32 would
// keep ~10 mantissa bits and break the 1e-5 float32 bound.  One block
// per column, one thread per slot p; the window is staged ZC z-planes at a
// time and each thread keeps its 3 x ZC partial H in registers.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- float32
namespace f32 {

constexpr int ZC = 16;

__global__ void contract_kernel(const float* __restrict__ grid,
                                const float* __restrict__ wxy,
                                const float* __restrict__ wz, int ncx, int ncy,
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
          v = grid[(((long long)k * Nx + gx) * Ny + gy) * Nz + z0 + z];
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
        const float* wcol = wxy + (long long)c * NN * cap + p;
        for (int n = 0; n < NN; ++n) {
          const float w = wcol[(long long)n * cap];
          const float* gn = g + n * 3 * ZC;
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int z = 0; z < ZC; ++z) hk[k][z] += gn[k * ZC + z] * w;
        }
        const float* wzc = wz + ((long long)c * Nz + z0) * cap + p;
#pragma unroll
        for (int z = 0; z < ZC; ++z) {
          if (z0 + z < Nz) {
            const float wv = wzc[(long long)z * cap];
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

cudaError_t launch(const float* grid, const void* wxy, const void* wz, int ncx,
                   int ncy, int sx, int sy, int Nx, int Ny, int Nz, int cap,
                   float scale, float* u, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 9 * sx * sy * 3 * ZC;
  cudaError_t e = allow_smem(contract_kernel, smem);
  if (e != cudaSuccess) return e;
  int threads = ((cap + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  contract_kernel<<<ncx * ncy, threads, smem, stream>>>(
      grid, static_cast<const float*>(wxy), static_cast<const float*>(wz),
      ncx, ncy, sx, sy, Nx, Ny, Nz, cap, scale, u);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------ bf16, tensor cores
namespace tc {

constexpr int MC = 96;              // z rows of one component per chunk
constexpr int BP = 256;             // slots p per block
constexpr int BK = 48;              // window nodes n per stage (3 k16)
constexpr int STAGES = 3;           // copy stages in flight
constexpr int SG = MC + 4;          // float32 G^T rows: 400 bytes
constexpr int SP = BP + 8;          // bf16 rows: 528 bytes
constexpr int WARPS_M = 3, WARPS_P = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_P;
constexpr int MT = MC / WARPS_M / 16;   // m16 tiles per warp (2)
constexpr int NT = BP / WARPS_P / 8;    // n8 tiles per warp (8)
constexpr int G_PIECES = BK * MC / 4;   // 16-byte pieces of a G stage
constexpr int W_PIECES = BK * BP / 8;   // 16-byte pieces of a wxy stage
constexpr int RES_ROWS = 144;           // most window nodes kept resident

using bf16 = __nv_bfloat16;

struct Smem {
  float g[STAGES][BK][SG];  // G^T stage [n][z], one component, float32
  bf16 wz[MC][SP];          // wz of the chunk's z rows [z][p]
  float red[WARPS_M][3][BP];
  // then the wxy rows [n][p] (RES: all window nodes, loaded once and kept
  // for every chunk; else STAGES stages of BK) and the node offsets (NN ints)
};

template <bool VEC, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    contract_kernel(const float* __restrict__ grid,
                    const bf16* __restrict__ wxy, const bf16* __restrict__ wz,
                    int ncx, int ncy, int sx, int sy, int Nx, int Ny, int Nz,
                    int cap, float scale, float* __restrict__ u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int c = blockIdx.x, p0 = blockIdx.y * BP;
  const int C = ncx * ncy, NN = 9 * sx * sy;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_P, wp = warp % WARPS_P;
  const int g = lane / 4, t = lane % 4;
  const int kstride = Nx * Ny * Nz;  // the launcher checks 3 kstride < 2^31
  const int nstages = (NN + BK - 1) / BK;
  bf16(*ws)[SP] = reinterpret_cast<bf16(*)[SP]>(smem_raw + sizeof(Smem));
  int* node_off = reinterpret_cast<int*>(
      &ws[RES ? nstages * BK : STAGES * BK][0]);

  // Where the window's node n lies in the grid (its z = 0, component 0).
  {
    const int bx = c / ncy, by = c % ncy;
    for (int n = tid; n < NN; n += THREADS) {
      const int o = n / (sx * sy), r = n - o * sx * sy;
      const int ix = r / sy, iy = r - ix * sy;
      int cx = bx + o / 3 - 1, cy = by + o % 3 - 1;
      cx += cx < 0 ? ncx : (cx >= ncx ? -ncx : 0);
      cy += cy < 0 ? ncy : (cy >= ncy ? -ncy : 0);
      node_off[n] = ((cx * sx + ix) * Ny + cy * sy + iy) * Nz;
    }
    for (int q = tid; q < WARPS_M * 3 * BP; q += THREADS)
      (&sm.red[0][0][0])[q] = 0.f;
  }
  __syncthreads();

  // Chunks walk z in MC rows (outer) and the components k (inner), so a
  // chunk's wz rows serve all three; each chunk walks n in stages of BK.
  const bf16* wxy_c = wxy + (long long)c * NN * cap;
  const int stages = (Nz + MC - 1) / MC * 3 * nstages;

  // Stage st into buffer st % STAGES: 16-byte cp.async (zero-filled past
  // the edges), or scalar loads where z runs or wxy rows are ragged.  A
  // resident wxy is loaded with the first chunk only.
  auto w_rows = [&](int st) {
    return ws + (RES ? st % nstages : st % STAGES) * BK;
  };
  auto fetch = [&](int st) {
    if (st < stages) {
      const int buf = st % STAGES, ch = st / nstages;
      const int z0 = ch / 3 * MC, k = ch % 3, n0 = st % nstages * BK;
      const float* gk = grid + (long long)k * kstride + z0;
      const bool load_w = !RES || st < nstages;
      bf16(*w)[SP] = w_rows(st);
      if constexpr (VEC) {
        for (int q = tid; q < G_PIECES; q += THREADS) {
          const int r = q / (MC / 4), zc = q % (MC / 4) * 4, n = n0 + r;
          // Nz % 4 == 0: the 4 rows from z0 + zc are in or out together
          const bool ok = n < NN && z0 + zc < Nz;
          cp_async16(&sm.g[buf][r][zc], ok ? gk + node_off[n] + zc : grid,
                     ok);
        }
        for (int q = tid; load_w && q < W_PIECES; q += THREADS) {
          const int r = q / (BP / 8), pc = q % (BP / 8) * 8;
          const int n = n0 + r, p = p0 + pc;
          const bool ok = n < NN && p < cap;
          cp_async16(&w[r][pc],
                     ok ? wxy_c + (long long)n * cap + p : wxy_c, ok);
        }
      } else {
        for (int q = tid; q < BK * MC; q += THREADS) {
          const int r = q / MC, zc = q % MC, n = n0 + r;
          sm.g[buf][r][zc] =
              n < NN && z0 + zc < Nz ? gk[node_off[n] + zc] : 0.f;
        }
        for (int q = tid; load_w && q < BK * BP; q += THREADS) {
          const int r = q / BP, pc = q % BP, n = n0 + r, p = p0 + pc;
          w[r][pc] = n < NN && p < cap ? wxy_c[(long long)n * cap + p]
                                       : __float2bfloat16_rn(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // wz rows z0.. of the chunk that starts at stage st
  auto fetch_wz = [&](int st) {
    const int z0 = st / nstages / 3 * MC;
    for (int q = tid; q < MC * BP / 8; q += THREADS) {
      const int r = q / (BP / 8), pc = q % (BP / 8) * 8;
      const int z = z0 + r, p = p0 + pc;
      const bf16* row = wz + ((long long)c * Nz + (z < Nz ? z : 0)) * cap;
      if constexpr (VEC) {
        const bool ok = z < Nz && p < cap;
        cp_async16(&sm.wz[r][pc], ok ? row + p : wz, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sm.wz[r][pc + j] = z < Nz && p + j < cap ? row[p + j]
                                                   : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[MT][NT][4];
  float us[NT * 2];  // the chunk's sums over this thread's rows
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int st = 0; st < STAGES - 1; ++st) fetch(st);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<STAGES - 2>();  // stage st has landed
    __syncthreads();  // ... for every thread; stage st - 1 is done
    if (st % (3 * nstages) == 0) fetch_wz(st);  // rides with the next group
    fetch(st + STAGES - 1);
    const float(*G)[SG] = sm.g[st % STAGES];
    const bf16(*W)[SP] = w_rows(st);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A = G^T fragments from the float32 stage, rounded to bf16 here
      // (row stride 100 words: the 32 lanes read 32 distinct banks)
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mr = wm * MT * 16 + i * 16 + g;
        const float* r0 = G[ks + 2 * t];
        const float* r1 = G[ks + 2 * t + 1];
        const float* r8 = G[ks + 2 * t + 8];
        const float* r9 = G[ks + 2 * t + 9];
        a[i][0] = pack_bf16x2(r0[mr], r1[mr]);
        a[i][1] = pack_bf16x2(r0[mr + 8], r1[mr + 8]);
        a[i][2] = pack_bf16x2(r8[mr], r9[mr]);
        a[i][3] = pack_bf16x2(r8[mr + 8], r9[mr + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &W[ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                               [wp * NT * 8 + j * 8 + (lane >> 4) * 8]);
        b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (st % nstages == nstages - 1) {
      // the chunk is complete: contract H against wz (zero-filled past Nz
      // and cap), sum over the warp's 8 row groups g (lanes t, t+4, ...,
      // t+28) and add to the row warp's partials, each in a fixed order.
      // The wz rows came with the group of stage st0 + STAGES - 1 (st0 the
      // z chunk's first stage), which has landed unless a chunk has fewer
      // stages than are in flight.
      if (nstages < STAGES) {
        cp_async_wait<0>();
        __syncthreads();
      }
      const int k = st / nstages % 3;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) us[j] = 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* wr = sm.wz[wm * MT * 16 + i * 16 + g + 8 * h];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
                wr + wp * NT * 8 + j * 8 + 2 * t);
            us[2 * j] += acc[i][j][2 * h] * bf16_lo(w2);
            us[2 * j + 1] += acc[i][j][2 * h + 1] * bf16_hi(w2);
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        float v = us[j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0)
          sm.red[wm][k][wp * NT * 8 + (j / 2) * 8 + 2 * t + j % 2] += v;
      }
    }
  }
  __syncthreads();
  const long long plane = (long long)C * cap;
  for (int idx = tid; idx < 3 * BP; idx += THREADS) {
    const int k = idx / BP, pp = idx % BP, p = p0 + pp;
    if (p < cap) {
      float v = sm.red[0][k][pp];
#pragma unroll
      for (int w = 1; w < WARPS_M; ++w) v += sm.red[w][k][pp];
      u[k * plane + (long long)c * cap + p] = scale * v;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool VEC, bool RES>
cudaError_t run(dim3 blocks, size_t smem, const float* grid, const bf16* a,
                const bf16* z, int ncx, int ncy, int sx, int sy, int Nx,
                int Ny, int Nz, int cap, float scale, float* u,
                cudaStream_t stream) {
  cudaError_t e = allow_smem(contract_kernel<VEC, RES>, smem);
  if (e != cudaSuccess) return e;
  contract_kernel<VEC, RES><<<blocks, THREADS, smem, stream>>>(
      grid, a, z, ncx, ncy, sx, sy, Nx, Ny, Nz, cap, scale, u);
  return cudaGetLastError();
}

cudaError_t launch(const float* grid, const void* wxy, const void* wz, int ncx,
                   int ncy, int sx, int sy, int Nx, int Ny, int Nz, int cap,
                   float scale, float* u, cudaStream_t stream) {
  if (3LL * Nx * Ny * Nz >= (1LL << 31) || (cap + BP - 1) / BP > 65535)
    return cudaErrorInvalidValue;
  const bf16* a = static_cast<const bf16*>(wxy);
  const bf16* z = static_cast<const bf16*>(wz);
  // 16-byte staging: wxy rows of cap slots and grid z runs 16-byte aligned
  const bool vec = cap % 8 == 0 && Nz % 4 == 0 && aligned16(grid) &&
                   aligned16(a) && aligned16(z);
  const int NN = 9 * sx * sy, nstages = (NN + BK - 1) / BK;
  const bool res = nstages * BK <= RES_ROWS;
  const size_t smem = sizeof(Smem) +
                      sizeof(bf16) * SP * (res ? nstages : STAGES) * BK +
                      sizeof(int) * NN;
  dim3 blocks(ncx * ncy, (cap + BP - 1) / BP);
  auto go = vec ? (res ? run<true, true> : run<true, false>)
                : (res ? run<false, true> : run<false, false>);
  return go(blocks, smem, grid, a, z, ncx, ncy, sx, sy, Nx, Ny, Nz, cap,
            scale, u, stream);
}

}  // namespace tc

}  // namespace

extern "C" int pse_contract_col(const float* grid, const void* wxy,
                                const void* wz, int w_bf16, int ncx, int ncy,
                                int sx, int sy, int Nx, int Ny, int Nz,
                                int cap, float scale, float* u,
                                cudaStream_t stream) {
  cudaError_t e =
      w_bf16 ? tc::launch(grid, wxy, wz, ncx, ncy, sx, sy, Nx, Ny, Nz, cap,
                          scale, u, stream)
             : f32::launch(grid, wxy, wz, ncx, ncy, sx, sy, Nx, Ny, Nz, cap,
                           scale, u, stream);
  return (int)e;
}

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
// 248 ~ 11.9 GFLOP take ~12 us on bf16 tensor cores, so it is bound by
// bytes, most of them the moments it writes.
//
// bf16 factors (the main path): one tensor-core GEMM per column, a TN
// product (p is the fastest axis of wxy and of X), with mma.sync m16n8k16.
// A block of 6 warps computes a 48 x 288 tile of out[c] (rows n, columns
// m; at bench scale all 288 columns, so X is built once overall and each
// column's wz rows are read by its 3 row tiles only).  It walks p in stages
// of 128, double buffered: wxy and the column's wz rows stream in by 16-byte
// cp.async, f through registers (scaled by prefac on the way to shared
// memory).  A fragments come from ldmatrix; B = X fragments are built in
// registers from wz and f, with the plain version's second multiply and its
// one rounding, so X never touches memory.  Long stages keep the per-stage
// wait and barrier few (2 at bench scale), which the H100 rewarded more
// than deeper pipelines of short stages.  Rows are padded to 272 bytes so
// ldmatrix and the B reads hit distinct banks.
// Ragged edges (NN, M and cap need not be tile multiples: 729 x 81 x 312 at
// the oracle's shapes) are zero-filled in the staging (p) or computed and
// never stored (n, m), never masked in the products; a cap that is not a
// multiple of 8 (or an unaligned operand) stages through scalar loads.  The
// epilogue writes each thread's accumulator pairs as 8-byte stores.  The
// products sum p in the tensor cores' order, not in ascending p, so the
// bf16 moments differ from the plain version's by the order of f32 sums
// (<= 1e-4 of the largest); every output has one writer, so reruns are
// bitwise equal.
//
// float32 factors (error < 1e-3, or asked for) stay on the CUDA cores, where
// the product is bound by operations (~0.18 ms at 67 TFLOP/s): TF32 would
// keep ~10 mantissa bits and break the 1e-5 float32 bound.  A block
// computes a 64 x 64 tile with 4 x 4 register tiles per thread, staging wxy
// and X in shared memory as f32; each output is summed by one thread over p
// in ascending order.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- float32
namespace f32 {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    spread_kernel(const float* __restrict__ f, const float* __restrict__ wxy,
                  const float* __restrict__ wz, int C, int NN, int Nz,
                  int cap, float prefac, float* __restrict__ out) {
  // p-major chunks, rows padded by one word against bank conflicts
  __shared__ float As[BK][BM + 1];  // wxy chunk
  __shared__ float Bs[BK][BN + 1];  // X chunk
  const int c = blockIdx.z;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int M = 3 * Nz;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long CP = (long long)C * cap;
  const float* wxy_c = wxy + (long long)c * NN * cap;
  const float* wz_c = wz + (long long)c * Nz * cap;

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
      As[kk][r] = (n < NN && p < cap) ? wxy_c[(long long)n * cap + p] : 0.f;
      float x = 0.f;
      if (m < M && p < cap) {
        const int k = m / Nz, z = m - k * Nz;
        const float fp = __fmul_rn(f[k * CP + (long long)c * cap + p], prefac);
        x = __fmul_rn(fp, wz_c[(long long)z * cap + p]);
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

cudaError_t launch(const float* f, const void* wxy, const void* wz, int C,
                   int NN, int Nz, int cap, float prefac, float* out,
                   cudaStream_t stream) {
  dim3 grid((3 * Nz + BN - 1) / BN, (NN + BM - 1) / BM, C);
  spread_kernel<<<grid, THREADS, 0, stream>>>(
      f, static_cast<const float*>(wxy), static_cast<const float*>(wz), C, NN,
      Nz, cap, prefac, out);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------ bf16, tensor cores
namespace tc {

constexpr int BM = 48;             // wxy rows n per block (3 m16 tiles)
constexpr int BN = 288;            // moment columns m per block (36 n8)
constexpr int BK = 128;            // slots p per stage (8 k16 steps)
constexpr int SK = BK + 8;         // padded shared row: 272 bytes
constexpr int STAGES = 2;          // copy stages in flight
constexpr int WARPS = 6;           // side by side along m
constexpr int THREADS = 32 * WARPS;
constexpr int MT = BM / 16;             // m16 tiles per warp (3)
constexpr int NT = BN / WARPS / 8;      // n8 tiles per warp (6)
constexpr int GPR = BK / 8;             // 8-slot groups per staged row
constexpr int F_PIECES = 3 * BK / 4;    // 4-slot pieces of f per stage (96)

using bf16 = __nv_bfloat16;

// Shared memory of one stage; STAGES of them, then the wz rows of every
// stage (ZR rows each, ZR = min(Nz, BN): a tile's columns need at most that
// many distinct z).
struct Stage {
  bf16 a[BM][SK];   // wxy [n][p]
  float f[3][BK];   // prefac * f [k][p]
};

// 8 consecutive bf16 elements from p on, zero past `cap` (scalar loads).
__device__ __forceinline__ uint4 load8_bf16(const bf16* row, int p, int cap,
                                            bool valid) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = (valid && p + 2 * j < cap)
                            ? __bfloat16_as_ushort(row[p + 2 * j]) : 0u;
    const uint32_t hi = (valid && p + 2 * j + 1 < cap)
                            ? __bfloat16_as_ushort(row[p + 2 * j + 1]) : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    spread_kernel(const float* __restrict__ f, const bf16* __restrict__ wxy,
                  const bf16* __restrict__ wz, int C, int NN, int Nz, int cap,
                  float prefac, bool store2, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stage = reinterpret_cast<Stage*>(smem_raw);
  bf16(*zs)[SK] = reinterpret_cast<bf16(*)[SK]>(smem_raw +
                                                 STAGES * sizeof(Stage));
  const int c = blockIdx.z;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int M = 3 * Nz;
  const int ZR = Nz < BN ? Nz : BN;             // wz rows per stage
  const int zlo = Nz <= BN ? 0 : m0 % Nz;       // z of the first row
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* wxy_c = wxy + (long long)c * NN * cap;
  const int fk = tid / (BK / 4), fpc = tid % (BK / 4) * 4;
  const float* f_row = f + ((long long)(tid < F_PIECES ? fk : 0) * C + c) *
                               cap;
  // Where this thread's B columns (one per n8 tile) read X's factors:
  // the wz row (z) and the f row (k) of column m; columns past M compute
  // outputs that are never stored, so they are clamped, not masked.
  int zo[NT], fo[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    int m = m0 + warp * NT * 8 + j * 8 + g;
    m = m < M ? m : M - 1;
    const int k = m / Nz, z = m - k * Nz;
    zo[j] = (z - zlo + (z < zlo ? Nz : 0)) * SK;
    fo[j] = k * BK;
  }
  const int stages = (cap + BK - 1) / BK;

  // Stage st of wxy and wz into buffer st % STAGES (16-byte cp.async,
  // zero-filled past the edges, or scalar loads where rows are ragged);
  // f comes into the register fv, stored scaled by put_f.
  auto fetch = [&](int st, float4& fv) {
    if (st < stages) {
      const int buf = st % STAGES, p0 = st * BK;
      for (int q = tid; q < BM * GPR; q += THREADS) {
        const int r = q / GPR, pc = q % GPR * 8, p = p0 + pc;
        const bool ok = n0 + r < NN;
        const bf16* row = wxy_c + (long long)(ok ? n0 + r : 0) * cap;
        if constexpr (VEC) {
          cp_async16(&stage[buf].a[r][pc], ok && p < cap ? row + p : wxy,
                     ok && p < cap);
        } else {
          *reinterpret_cast<uint4*>(&stage[buf].a[r][pc]) =
              load8_bf16(row, p, cap, ok);
        }
      }
      for (int q = tid; q < ZR * GPR; q += THREADS) {
        const int r = q / GPR, pc = q % GPR * 8, p = p0 + pc;
        const int z = zlo + r - (zlo + r >= Nz ? Nz : 0);
        const bf16* row = wz + ((long long)c * Nz + z) * cap;
        bf16* dst = &zs[buf * ZR + r][pc];
        if constexpr (VEC) {
          cp_async16(dst, p < cap ? row + p : wz, p < cap);
        } else {
          *reinterpret_cast<uint4*>(dst) = load8_bf16(row, p, cap, true);
        }
      }
      if (tid < F_PIECES) {
        const int p = p0 + fpc;
        if constexpr (VEC) {
          fv = p < cap ? *reinterpret_cast<const float4*>(f_row + p)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          fv.x = p < cap ? f_row[p] : 0.f;
          fv.y = p + 1 < cap ? f_row[p + 1] : 0.f;
          fv.z = p + 2 < cap ? f_row[p + 2] : 0.f;
          fv.w = p + 3 < cap ? f_row[p + 3] : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  // the plain version's first f32 multiply, prefac * f
  auto put_f = [&](int st, const float4& fv) {
    if (st < stages && tid < F_PIECES)
      *reinterpret_cast<float4*>(&stage[st % STAGES].f[fk][fpc]) =
          make_float4(__fmul_rn(fv.x, prefac), __fmul_rn(fv.y, prefac),
                      __fmul_rn(fv.z, prefac), __fmul_rn(fv.w, prefac));
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  float4 fv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int st = 0; st < STAGES - 1; ++st) {
    fetch(st, fv);
    put_f(st, fv);
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<STAGES - 2>();  // stage st has landed
    __syncthreads();  // ... for every thread; stage st - 1 is done
    fetch(st + STAGES - 1, fv);
    const Stage& S = stage[st % STAGES];
    const bf16* Z = &zs[(st % STAGES) * ZR][0];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], &S.a[i * 16 + (lane & 15)][ks + (lane >> 4) * 8]);
      // B = X fragments built in registers: X = round((prefac f) * wz),
      // the plain version's second multiply and its one rounding
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = ks + 2 * t;
        const uint32_t z0 = *reinterpret_cast<const uint32_t*>(Z + zo[j] + p);
        const uint32_t z8 =
            *reinterpret_cast<const uint32_t*>(Z + zo[j] + p + 8);
        const float2 f0 = *reinterpret_cast<const float2*>(&S.f[0][0] +
                                                           fo[j] + p);
        const float2 f8 = *reinterpret_cast<const float2*>(&S.f[0][0] +
                                                           fo[j] + p + 8);
        b[j][0] = pack_bf16x2(__fmul_rn(f0.x, bf16_lo(z0)),
                              __fmul_rn(f0.y, bf16_hi(z0)));
        b[j][1] = pack_bf16x2(__fmul_rn(f8.x, bf16_lo(z8)),
                              __fmul_rn(f8.y, bf16_hi(z8)));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    put_f(st + STAGES - 1, fv);
  }

  float* out_c = out + (long long)c * NN * M;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + i * 16 + g + 8 * h;
      if (n >= NN) continue;
      float* row = out_c + (long long)n * M;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int m = m0 + warp * NT * 8 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (store2 && m < M) {
          *reinterpret_cast<float2*>(row + m) = make_float2(v0, v1);
        } else {
          if (m < M) row[m] = v0;
          if (m + 1 < M) row[m + 1] = v1;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool VEC>
cudaError_t run(dim3 grid, const float* f, const bf16* a, const bf16* z,
                int C, int NN, int Nz, int cap, float prefac, bool store2,
                float* out, cudaStream_t stream) {
  const size_t smem = STAGES * (sizeof(Stage) + sizeof(bf16) * SK *
                                                    (Nz < BN ? Nz : BN));
  cudaError_t e = allow_smem(spread_kernel<VEC>, smem);
  if (e != cudaSuccess) return e;
  spread_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      f, a, z, C, NN, Nz, cap, prefac, store2, out);
  return cudaGetLastError();
}

cudaError_t launch(const float* f, const void* wxy, const void* wz, int C,
                   int NN, int Nz, int cap, float prefac, float* out,
                   cudaStream_t stream) {
  dim3 grid((3 * Nz + BN - 1) / BN, (NN + BM - 1) / BM, C);
  const bf16* a = static_cast<const bf16*>(wxy);
  const bf16* z = static_cast<const bf16*>(wz);
  // 16-byte staging needs every row (cap slots) and operand 16-byte aligned
  const bool vec = cap % 8 == 0 && aligned16(f) && aligned16(a) &&
                   aligned16(z);
  // 8-byte stores need an even row length and an 8-byte aligned output
  const bool store2 = Nz % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  return vec ? run<true>(grid, f, a, z, C, NN, Nz, cap, prefac, store2, out,
                         stream)
             : run<false>(grid, f, a, z, C, NN, Nz, cap, prefac, store2, out,
                          stream);
}

}  // namespace tc

}  // namespace

extern "C" int pse_spread_col(const float* f, const void* wxy, const void* wz,
                              int w_bf16, int C, int NN, int Nz, int cap,
                              float prefac, float* out, cudaStream_t stream) {
  if (C > 65535) return (int)cudaErrorInvalidValue;  // grid.z limit
  cudaError_t e =
      w_bf16 ? tc::launch(f, wxy, wz, C, NN, Nz, cap, prefac, out, stream)
             : f32::launch(f, wxy, wz, C, NN, Nz, cap, prefac, out, stream);
  return (int)e;
}

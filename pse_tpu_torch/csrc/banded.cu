// Banded near-field mobility: the pair-coefficient build, alone or fused
// with the first matvec for one or two right-hand sides (the matvec that
// streams the stored coefficients back is banded_matvec.cu).
//
// Replaces two Pallas kernels of pse_tpu/ops/banded_nearfield.py:
//   * `_build_mv_kernel` (:1472, launched by `build_mv_banded`, :1693): build
//     A = (imrr, bco/d^2) over the half stencil and apply it at once;
//   * `_build_kernel` (:733, launched by `build_banded_blocks`, :894): the
//     build alone (MODE_BUILD here, no right-hand side; the TPU kernel's
//     second output, the prefolded coordinates pos_cyc, feeds only its MXU
//     matvec and has no counterpart).
// The fused matvec computes what `matvec_banded_reference` computes (that
// module's plain version), with A rounded to the block dtype before it is
// applied, as every later matvec applies it, so Lanczos sees one operator.
// The build writes the same A in every mode (its plain version is
// `build_banded_blocks_reference`).  With NRHS = 2 (f (6, C, S), the forces
// and the first Lanczos vector of a with-forces step) each A element is
// built or read once and applied to both; each right-hand side is summed in
// the order of a one-RHS launch.
//
// Semantics (one block per (column c, stored offset h), h in 0..4):
//   * the neighbour column is c + (OX[h], OY[h]) on the periodic column grid;
//     its xy image shift at the grid edge includes the tilt:
//     sx = wx*Lx + tilt*sy, sy = wy*Ly;
//   * the window of tile t is in cyclic rank coordinates: lane w is rank
//     j0 + w, slot j = rank (rank < nv) or rank - nv with z + Lz (rank >= nv),
//     nv the neighbour's valid count; lanes w >= nv are masked;
//   * the per-(offset, column, tile) z shift zsh is subtracted from the
//     window z, so dz needs no per-pair minimum-image round;
//   * valid pairs have dr^2 <= d^2 < rcut^2, both slots occupied, and are not
//     the self pair (excluded at offset 0 only); the Chebyshev branch select
//     is at r = 2a;
//   * the forward product u_i += F1 f_j + Bq d (d . f_j) goes to plane h of
//     uo (C, 9, 3 NRHS, S); for h >= 1 the transposed product u_j += F1 f_i +
//     Bq d (d . f_i) is summed by cyclic rank in shared memory over all tiles,
//     folded to slots, and written to plane 4 + h at the OWN column; torch
//     sums the forward planes and rolls the transposed ones onto their target
//     columns (banded_nearfield._finish_u).
//
// What bounds it on the H100: at bench scale (C = 216, S = 576, W = 128,
// bf16) the build writes A, 318.5 MB, >= ~95 us at 3.35 TB/s (the build
// alone moves nothing else of size).  The pair arithmetic (~80 M pairs,
// ~40 flops each forward + transposed, plus a degree-8 Clenshaw pair in the
// build) is of the same order on the CUDA cores.
//
// Design: 256 threads (8 warps) per block; lane w of a warp walks window
// lanes w, w+32, ... (coalesced A and window reads) and the warp's rows are
// warp, warp+8, ... (R/8 per warp, held in registers with their NRHS right-
// hand sides and sums: MAX_RPW x 3 x NRHS of each).  Forward sums are
// reduced across lanes with warp shuffles in a fixed order; transposed sums
// go through a per-warp shared-memory partial and a fixed-order sum into the
// rank accumulator.  No float atomics: every output element is written by
// exactly one thread, so results are bitwise reproducible.  Geometry is f32
// from the slot coordinates (the TPU kernel's bf16 hi/lo coordinate split and
// prefolded coordinate array were MXU devices).  Simple and right first:
// tensor cores, TMA and vector loads are later work.
#include "common.cuh"

namespace {

constexpr int N_HALF = 5;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_RPW = 4;  // rows per warp: R <= 32

// MODE_BUILD_MV builds A and applies it, MODE_BUILD only builds it (NRHS =
// 0, no f, no uo)
constexpr int MODE_BUILD_MV = 0, MODE_BUILD = 1;

// (0,0) then the positive half stencil (banded_nearfield.full_xy_offsets)
__constant__ int OX[N_HALF] = {0, 0, 1, 1, 1};
__constant__ int OY[N_HALF] = {0, 1, -1, 0, 1};

struct Band {
  const float *px, *py, *pz, *mask;  // (C, S) slot coordinates / occupancy
  const float* f;                    // (3 NRHS, C, S) right-hand sides, pads 0
  const int* j0;                     // (5, C, T) window start ranks
  const float* zsh;                  // (5, C, T) window z image shifts
  const int* n_valid;                // (C,) occupied slots per column
  const float* cheb;                 // chebyshev.device_coeffs layout
  int n_coef;
  float mid, cut2, dr2;
  int ncx, ncy, S, R, W, T;
  float Lx, Ly, Lz, tilt;
  void* A;    // (C, 2, S, 5W) block dtype: (imrr, bco/d^2)
  float* uo;  // (C, 9, 3 NRHS, S)
};

// The Clenshaw recurrence of chebyshev.eval_pair_functions, rounded step by
// step as it is there (no fused multiply-add), so that the build's float32
// coefficients are the plain build's.  On the H100 that costs ~4 % of a
// build_mv (pse_tpu_torch/ab.py --contract times it against contracted
// FMAs).
__device__ __forceinline__ float clenshaw(const float* c_lo, const float* c_hi,
                                          bool in_lo, float t, int n) {
  const float t2 = 2.f * t;
  float b1 = 0.f, b2 = 0.f;
  for (int k = n - 1; k > 0; --k) {
    const float ck = in_lo ? c_lo[k] : c_hi[k];
    const float nb = __fsub_rn(__fadd_rn(ck, __fmul_rn(t2, b1)), b2);
    b2 = b1;
    b1 = nb;
  }
  return __fsub_rn(__fadd_rn(in_lo ? c_lo[0] : c_hi[0], __fmul_rn(t, b1)),
                   b2);
}

template <int MODE, int NRHS, typename AT>
__global__ void __launch_bounds__(THREADS) banded_kernel(Band b) {
  constexpr int NR = NRHS > 0 ? NRHS : 1;  // register array extent
  constexpr int NF = 3 * NRHS;             // right-hand-side rows
  extern __shared__ float smem[];
  const int S = b.S, W = b.W, R = b.R, T = b.T;
  const int C = b.ncx * b.ncy;
  const long long CS = (long long)C * S;
  const int c = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rpw = R / WARPS;

  const int cx = c / b.ncy, cy = c % b.ncy;
  const int ox = OX[h], oy = OY[h];
  const int nbr =
      ((cx + ox + b.ncx) % b.ncx) * b.ncy + (cy + oy + b.ncy) % b.ncy;
  const int nv = b.n_valid[nbr];
  const float wx = (cx + ox >= b.ncx) ? 1.f : ((cx + ox < 0) ? -1.f : 0.f);
  const float wy = (cy + oy >= b.ncy) ? 1.f : ((cy + oy < 0) ? -1.f : 0.f);
  // explicit roundings (no fused multiply-add) in the geometry the build
  // tests against the cutoff, so that the plain build reproduces it
  const float sy = wy * b.Ly;
  const float sx = __fadd_rn(wx * b.Lx, __fmul_rn(b.tilt, sy));
  const bool transposed = NRHS > 0 && h > 0;

  float* own = smem;                      // (4 + NF) x S: x, y, z, m, f rows
  float* acc = own + (4 + NF) * S;        // NF x (S + W): transposed, by rank
  float* part = acc + NF * (S + W);       // WARPS x NF x W: per-warp partials
  float* cf = part + WARPS * NF * W;      // Chebyshev operand (build)
  const int SW = S + W;

  for (int s = tid; s < S; s += THREADS) {
    const long long o = (long long)c * S + s;
    own[s] = b.px[o];
    own[S + s] = b.py[o];
    own[2 * S + s] = b.pz[o];
    own[3 * S + s] = b.mask[o];
#pragma unroll
    for (int k = 0; k < NF; ++k) own[(4 + k) * S + s] = b.f[k * CS + o];
  }
  for (int s = tid; s < NF * SW; s += THREADS) acc[s] = 0.f;
  for (int s = tid; s < 4 + 4 * b.n_coef; s += THREADS) cf[s] = b.cheb[s];
  __syncthreads();

  AT* A = reinterpret_cast<AT*>(b.A);
  const long long a_row = (long long)N_HALF * W;
  const long long a_im = (long long)c * 2 * S * a_row;  // A[c, 0]
  const long long a_bq = a_im + (long long)S * a_row;   // A[c, 1]
  const int nc = b.n_coef;
  float* wpart = part + warp * NF * W;

  for (int t = 0; t < T; ++t) {
    const long long wt = ((long long)h * C + c) * T + t;
    const int j0 = b.j0[wt];
    const float zs = b.zsh[wt];

    float xi[MAX_RPW], yi[MAX_RPW], zi[MAX_RPW], mi[MAX_RPW];
    float fi[NR][3][MAX_RPW], u[NR][3][MAX_RPW];
#pragma unroll
    for (int q = 0; q < MAX_RPW; ++q) {
      const int i = q < rpw ? t * R + warp + WARPS * q : 0;
      xi[q] = own[i];
      yi[q] = own[S + i];
      zi[q] = own[2 * S + i];
      mi[q] = own[3 * S + i];
#pragma unroll
      for (int r = 0; r < NRHS; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fi[r][k][q] = own[(4 + 3 * r + k) * S + i];
          u[r][k][q] = 0.f;
        }
    }

    for (int w = lane; w < W; w += 32) {
      const int rank = j0 + w;
      const bool wrap = rank >= nv;
      const int j = wrap ? rank - nv : rank;
      const long long o = (long long)nbr * S + min(j, S - 1);
      const float xw = b.px[o] + sx;
      const float yw = b.py[o] + sy;
      const float zw = (b.pz[o] + (wrap ? b.Lz : 0.f)) - zs;
      const float mw = (w < nv) ? b.mask[o] : 0.f;
      float fw[NR][3], tp[NR][3];
#pragma unroll
      for (int r = 0; r < NRHS; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fw[r][k] = b.f[(3 * r + k) * CS + o];
          tp[r][k] = 0.f;
        }
#pragma unroll
      for (int q = 0; q < MAX_RPW; ++q) {
        if (q >= rpw) break;
        const int i = t * R + warp + WARPS * q;
        const float dx = xi[q] - xw, dy = yi[q] - yw, dz = zi[q] - zw;
        const long long ai = (long long)i * a_row + (long long)h * W + w;
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const bool valid = (mi[q] * mw > 0.f) && (d2 < b.cut2) &&
                           (d2 >= b.dr2) && !(h == 0 && j == i);
        const float d2s = valid ? d2 : 1.f;
        const float dist = sqrtf(d2s);
        const bool in_lo = dist < b.mid;
        const float tt = in_lo ? (2.f * dist - cf[0]) / cf[1]
                               : (2.f * dist - cf[2]) / cf[3];
        const float uf1 = clenshaw(cf + 4, cf + 4 + 2 * nc, in_lo, tt, nc);
        const float uf2 =
            clenshaw(cf + 4 + nc, cf + 4 + 3 * nc, in_lo, tt, nc);
        const AT s1 = from_f32<AT>(valid ? uf1 : 0.f);
        const AT s2 = from_f32<AT>(valid ? (uf2 - uf1) / d2s : 0.f);
        A[a_im + ai] = s1;
        A[a_bq + ai] = s2;
        const float F1 = to_f32(s1), Bq = to_f32(s2);
#pragma unroll
        for (int r = 0; r < NRHS; ++r) {
          const float g = Bq * (dx * fw[r][0] + dy * fw[r][1] + dz * fw[r][2]);
          u[r][0][q] += F1 * fw[r][0] + g * dx;
          u[r][1][q] += F1 * fw[r][1] + g * dy;
          u[r][2][q] += F1 * fw[r][2] + g * dz;
          if (h > 0) {
            const float gi =
                Bq * (dx * fi[r][0][q] + dy * fi[r][1][q] + dz * fi[r][2][q]);
            tp[r][0] += F1 * fi[r][0][q] + gi * dx;
            tp[r][1] += F1 * fi[r][1][q] + gi * dy;
            tp[r][2] += F1 * fi[r][2][q] + gi * dz;
          }
        }
      }
      if (transposed) {
#pragma unroll
        for (int r = 0; r < NRHS; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k) wpart[(3 * r + k) * W + w] = tp[r][k];
      }
    }

    // forward rows: fixed-order butterfly across the warp's lanes
#pragma unroll
    for (int q = 0; q < MAX_RPW; ++q) {
      if (q >= rpw) break;
#pragma unroll
      for (int r = 0; r < NRHS; ++r) {
        float v0 = u[r][0][q], v1 = u[r][1][q], v2 = u[r][2][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, off);
          v1 += __shfl_xor_sync(0xffffffffu, v1, off);
          v2 += __shfl_xor_sync(0xffffffffu, v2, off);
        }
        if (lane == 0) {
          const int i = t * R + warp + WARPS * q;
          float* out = b.uo + (((long long)c * 9 + h) * NF + 3 * r) * S + i;
          out[0] = v0;
          out[S] = v1;
          out[2 * S] = v2;
        }
      }
    }

    // transposed lanes: fixed-order sum of the warp partials into ranks
    if (transposed) {
      __syncthreads();
      for (int w = tid; w < W; w += THREADS) {
        for (int k = 0; k < NF; ++k) {
          float s = 0.f;
          for (int p = 0; p < WARPS; ++p) s += part[(p * NF + k) * W + w];
          acc[k * SW + j0 + w] += s;
        }
      }
      __syncthreads();
    }
  }

  // fold cyclic ranks to slots: ranks < nv are slots, ranks in [nv, nv + W)
  // wrap to slots [0, W)
  if (transposed) {
    float* out = b.uo + ((long long)c * 9 + 4 + h) * NF * S;
    for (int s = tid; s < S; s += THREADS) {
      for (int k = 0; k < NF; ++k) {
        const float head = s < nv ? acc[k * SW + s] : 0.f;
        const float tail = s < W ? acc[k * SW + nv + s] : 0.f;
        out[k * S + s] = head + tail;
      }
    }
  }
}

template <int MODE, int NRHS, typename AT>
cudaError_t launch(const Band& b, cudaStream_t stream) {
  constexpr int NF = 3 * NRHS;
  const size_t smem =
      sizeof(float) * ((4 + NF) * (size_t)b.S + NF * (size_t)(b.S + b.W) +
                       (size_t)WARPS * NF * b.W + 4 + 4 * (size_t)b.n_coef);
  auto kernel = banded_kernel<MODE, NRHS, AT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b.ncx * b.ncy, N_HALF);
  kernel<<<grid, THREADS, smem, stream>>>(b);
  return cudaGetLastError();
}

template <typename AT>
cudaError_t dispatch(int mode, int nrhs, const Band& b, cudaStream_t stream) {
  if (mode == MODE_BUILD)
    return nrhs == 0 ? launch<MODE_BUILD, 0, AT>(b, stream)
                     : cudaErrorInvalidValue;
  if (nrhs == 1) return launch<MODE_BUILD_MV, 1, AT>(b, stream);
  if (nrhs == 2) return launch<MODE_BUILD_MV, 2, AT>(b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pse_banded(int mode, int nrhs, const float* px, const float* py,
                          const float* pz, const float* mask, const float* f,
                          const int* j0, const float* zsh, const int* n_valid,
                          const float* cheb, int n_coef, float mid, float cut2,
                          float dr2, int ncx, int ncy, int S, int R, int W,
                          float Lx, float Ly, float Lz, float tilt, int a_bf16,
                          void* A, float* uo, cudaStream_t stream) {
  if (R % WARPS != 0 || R > WARPS * MAX_RPW || S % R != 0 || W % 32 != 0 ||
      mode < MODE_BUILD_MV || mode > MODE_BUILD)
    return (int)cudaErrorInvalidValue;
  Band b{px,  py,   pz,   mask, f,   j0,  zsh, n_valid, cheb, n_coef, mid,
         cut2, dr2, ncx, ncy, S,   R,   W,   S / R,   Lx,   Ly,     Lz,
         tilt, A,   uo};
  const cudaError_t e = a_bf16
                            ? dispatch<__nv_bfloat16>(mode, nrhs, b, stream)
                            : dispatch<float>(mode, nrhs, b, stream);
  return (int)e;
}

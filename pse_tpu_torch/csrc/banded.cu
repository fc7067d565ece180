// Banded near-field mobility: the fused pair-coefficient build + first
// matvec, and the matvec that streams the stored coefficients back.
//
// Replaces two Pallas kernels of pse_tpu/ops/banded_nearfield.py:
//   * `_build_mv_kernel` (:1472, launched by `build_mv_banded`, :1693): build
//     A = (imrr, bco/d^2) over the half stencil and apply it at once;
//   * `_matvec_kernel` (:1147, launched by `matvec_banded`, :1392): u = M_real f
//     from one read of A, forward and transposed.
// Both compute what `matvec_banded_reference` computes (that module's plain
// version), with A rounded to the block dtype before it is applied, in the
// build and in every later matvec alike, so Lanczos sees one operator.
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
//     uo (C, 9, 3, S); for h >= 1 the transposed product u_j += F1 f_i +
//     Bq d (d . f_i) is summed by cyclic rank in shared memory over all tiles,
//     folded to slots, and written to plane 4 + h at the OWN column; torch
//     sums the forward planes and rolls the transposed ones onto their target
//     columns (banded_nearfield._finish_u).
//
// What bounds it on the H100: at bench scale (C = 216, S = 576, W = 128,
// bf16) the matvec must read A, 318.5 MB, >= ~95 us at 3.35 TB/s; the build
// writes the same bytes.  The pair arithmetic (~80 M pairs, ~40 flops each
// forward + transposed, plus a degree-8 Clenshaw pair in the build) is of
// the same order on the CUDA cores.
//
// Design: 256 threads (8 warps) per block; lane w of a warp walks window
// lanes w, w+32, ... (coalesced A and window reads) and the warp's rows are
// warp, warp+8, ... (R/8 per warp, held in registers).  Forward sums are
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

// (0,0) then the positive half stencil (banded_nearfield.full_xy_offsets)
__constant__ int OX[N_HALF] = {0, 0, 1, 1, 1};
__constant__ int OY[N_HALF] = {0, 1, -1, 0, 1};

struct Band {
  const float *px, *py, *pz, *mask;  // (C, S) slot coordinates / occupancy
  const float* f;                    // (3, C, S) right-hand side, pads zero
  const int* j0;                     // (5, C, T) window start ranks
  const float* zsh;                  // (5, C, T) window z image shifts
  const int* n_valid;                // (C,) occupied slots per column
  const float* cheb;                 // chebyshev.device_coeffs layout
  int n_coef;
  float mid, cut2, dr2;
  int ncx, ncy, S, R, W, T;
  float Lx, Ly, Lz, tilt;
  void* A;    // (C, 2, S, 5W) block dtype: (imrr, bco/d^2)
  float* uo;  // (C, 9, 3, S)
};

__device__ __forceinline__ float clenshaw(const float* c_lo, const float* c_hi,
                                          bool in_lo, float t, int n) {
  const float t2 = 2.f * t;
  float b1 = 0.f, b2 = 0.f;
  for (int k = n - 1; k > 0; --k) {
    const float ck = in_lo ? c_lo[k] : c_hi[k];
    const float nb = ck + t2 * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  return (in_lo ? c_lo[0] : c_hi[0]) + t * b1 - b2;
}

template <bool BUILD, typename AT>
__global__ void __launch_bounds__(THREADS) banded_kernel(Band b) {
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
  const float sy = wy * b.Ly;
  const float sx = wx * b.Lx + b.tilt * sy;

  float* own = smem;                      // 7 x S: x, y, z, m, f0, f1, f2
  float* acc = own + 7 * S;               // 3 x (S + W): transposed, by rank
  float* part = acc + 3 * (S + W);        // WARPS x 3 x W: per-warp partials
  float* cf = part + WARPS * 3 * W;       // Chebyshev operand (build)
  const int SW = S + W;

  for (int s = tid; s < S; s += THREADS) {
    const long long o = (long long)c * S + s;
    own[s] = b.px[o];
    own[S + s] = b.py[o];
    own[2 * S + s] = b.pz[o];
    own[3 * S + s] = b.mask[o];
    own[4 * S + s] = b.f[o];
    own[5 * S + s] = b.f[CS + o];
    own[6 * S + s] = b.f[2 * CS + o];
  }
  for (int s = tid; s < 3 * SW; s += THREADS) acc[s] = 0.f;
  if (BUILD)
    for (int s = tid; s < 4 + 4 * b.n_coef; s += THREADS) cf[s] = b.cheb[s];
  __syncthreads();

  AT* A = reinterpret_cast<AT*>(b.A);
  const long long a_row = (long long)N_HALF * W;
  const long long a_im = (long long)c * 2 * S * a_row;  // A[c, 0]
  const long long a_bq = a_im + (long long)S * a_row;   // A[c, 1]
  const int nc = b.n_coef;
  float* wpart = part + warp * 3 * W;

  for (int t = 0; t < T; ++t) {
    const long long wt = ((long long)h * C + c) * T + t;
    const int j0 = b.j0[wt];
    const float zs = b.zsh[wt];

    float xi[MAX_RPW], yi[MAX_RPW], zi[MAX_RPW], mi[MAX_RPW];
    float fi0[MAX_RPW], fi1[MAX_RPW], fi2[MAX_RPW];
    float u0[MAX_RPW], u1[MAX_RPW], u2[MAX_RPW];
#pragma unroll
    for (int q = 0; q < MAX_RPW; ++q) {
      const int i = q < rpw ? t * R + warp + WARPS * q : 0;
      xi[q] = own[i];
      yi[q] = own[S + i];
      zi[q] = own[2 * S + i];
      mi[q] = own[3 * S + i];
      fi0[q] = own[4 * S + i];
      fi1[q] = own[5 * S + i];
      fi2[q] = own[6 * S + i];
      u0[q] = u1[q] = u2[q] = 0.f;
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
      const float fw0 = b.f[o], fw1 = b.f[CS + o], fw2 = b.f[2 * CS + o];
      float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_RPW; ++q) {
        if (q >= rpw) break;
        const int i = t * R + warp + WARPS * q;
        const float dx = xi[q] - xw, dy = yi[q] - yw, dz = zi[q] - zw;
        const long long ai = (long long)i * a_row + (long long)h * W + w;
        float F1, Bq;
        if (BUILD) {
          const float d2 = dx * dx + dy * dy + dz * dz;
          const bool valid = (mi[q] * mw > 0.f) && (d2 < b.cut2) &&
                             (d2 >= b.dr2) && !(h == 0 && j == i);
          const float d2s = valid ? d2 : 1.f;
          const float r = sqrtf(d2s);
          const bool in_lo = r < b.mid;
          const float tt = in_lo ? (2.f * r - cf[0]) / cf[1]
                                 : (2.f * r - cf[2]) / cf[3];
          const float uf1 = clenshaw(cf + 4, cf + 4 + 2 * nc, in_lo, tt, nc);
          const float uf2 =
              clenshaw(cf + 4 + nc, cf + 4 + 3 * nc, in_lo, tt, nc);
          const AT s1 = from_f32<AT>(valid ? uf1 : 0.f);
          const AT s2 = from_f32<AT>(valid ? (uf2 - uf1) / d2s : 0.f);
          A[a_im + ai] = s1;
          A[a_bq + ai] = s2;
          F1 = to_f32(s1);
          Bq = to_f32(s2);
        } else {
          F1 = to_f32(A[a_im + ai]);
          Bq = to_f32(A[a_bq + ai]);
        }
        const float g = Bq * (dx * fw0 + dy * fw1 + dz * fw2);
        u0[q] += F1 * fw0 + g * dx;
        u1[q] += F1 * fw1 + g * dy;
        u2[q] += F1 * fw2 + g * dz;
        if (h > 0) {
          const float gi = Bq * (dx * fi0[q] + dy * fi1[q] + dz * fi2[q]);
          t0 += F1 * fi0[q] + gi * dx;
          t1 += F1 * fi1[q] + gi * dy;
          t2 += F1 * fi2[q] + gi * dz;
        }
      }
      if (h > 0) {
        wpart[w] = t0;
        wpart[W + w] = t1;
        wpart[2 * W + w] = t2;
      }
    }

    // forward rows: fixed-order butterfly across the warp's lanes
#pragma unroll
    for (int q = 0; q < MAX_RPW; ++q) {
      if (q >= rpw) break;
      float v0 = u0[q], v1 = u1[q], v2 = u2[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (lane == 0) {
        const int i = t * R + warp + WARPS * q;
        float* out = b.uo + ((long long)c * 9 + h) * 3 * S + i;
        out[0] = v0;
        out[S] = v1;
        out[2 * S] = v2;
      }
    }

    // transposed lanes: fixed-order sum of the warp partials into ranks
    if (h > 0) {
      __syncthreads();
      for (int w = tid; w < W; w += THREADS) {
        for (int k = 0; k < 3; ++k) {
          float s = 0.f;
          for (int p = 0; p < WARPS; ++p) s += part[(p * 3 + k) * W + w];
          acc[k * SW + j0 + w] += s;
        }
      }
      __syncthreads();
    }
  }

  // fold cyclic ranks to slots: ranks < nv are slots, ranks in [nv, nv + W)
  // wrap to slots [0, W)
  if (h > 0) {
    float* out = b.uo + ((long long)c * 9 + 4 + h) * 3 * S;
    for (int s = tid; s < S; s += THREADS) {
      for (int k = 0; k < 3; ++k) {
        const float head = s < nv ? acc[k * SW + s] : 0.f;
        const float tail = s < W ? acc[k * SW + nv + s] : 0.f;
        out[k * S + s] = head + tail;
      }
    }
  }
}

template <bool BUILD, typename AT>
cudaError_t launch(const Band& b, size_t smem, cudaStream_t stream) {
  auto kernel = banded_kernel<BUILD, AT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b.ncx * b.ncy, N_HALF);
  kernel<<<grid, THREADS, smem, stream>>>(b);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pse_banded(int build, const float* px, const float* py,
                          const float* pz, const float* mask, const float* f,
                          const int* j0, const float* zsh, const int* n_valid,
                          const float* cheb, int n_coef, float mid, float cut2,
                          float dr2, int ncx, int ncy, int S, int R, int W,
                          float Lx, float Ly, float Lz, float tilt, int a_bf16,
                          void* A, float* uo, cudaStream_t stream) {
  if (R % WARPS != 0 || R > WARPS * MAX_RPW || S % R != 0 || W % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Band b{px,  py,   pz,   mask, f,   j0,  zsh, n_valid, cheb, n_coef, mid,
         cut2, dr2, ncx, ncy, S,   R,   W,   S / R,   Lx,   Ly,     Lz,
         tilt, A,   uo};
  const size_t smem =
      sizeof(float) * (7 * (size_t)S + 3 * (size_t)(S + W) +
                       (size_t)WARPS * 3 * W + (build ? 4 + 4 * n_coef : 0));
  cudaError_t e;
  if (a_bf16)
    e = build ? launch<true, __nv_bfloat16>(b, smem, stream)
              : launch<false, __nv_bfloat16>(b, smem, stream);
  else
    e = build ? launch<true, float>(b, smem, stream)
              : launch<false, float>(b, smem, stream);
  return (int)e;
}

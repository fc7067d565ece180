// Banded near-field matvec: u = M_real f from one read of the stored
// coefficients A, forward and transposed, for one or two right-hand sides.
//
// Replaces `_matvec_kernel` of pse_tpu/ops/banded_nearfield.py (:1147,
// launched by `matvec_banded`, :1392).  Semantics are banded.cu's (see the
// notes there): one block per (column c, stored offset h); the window of
// tile t is the neighbour column's cyclic ranks j0 + w, w < W, its z
// shifted by the tile's zsh; the forward product u_i += F1 f_j + Bq d (d .
// f_j) goes to plane h of uo (C, 9, 3 NRHS, S); for h >= 1 the transposed
// product u_j += F1 f_i + Bq d (d . f_i) is summed by cyclic rank, folded to
// slots and written to plane 4 + h.  d is rebuilt from the float32 slot
// coordinates exactly as the build computes it.
//
// What bounds it on the H100: A.  At bench scale (C = 216, S = 576, R = 32,
// W = 128, bf16) A is 318.5 MB, >= 95 us at 3.35 TB/s; the pair arithmetic
// (~25 float32 instructions per stored pair and right-hand side, forward
// and transposed) is of the same order on the CUDA cores.  The design:
//   * tiles past ceil(n_valid[c] / R) hold no occupied row, so their A and
//     f rows are zero: they are skipped (no A read, no arithmetic) and their
//     forward rows written as zeros (~17 % of A at bench scale);
//   * a thread owns LPT = 8 window lanes of one tile for all R rows: one
//     16-byte load per A plane and row (two at float32), RG rows loaded
//     before any is used; the lanes' window coordinates and f sit in
//     registers, so the transposed sums stay in registers over the tile;
//   * G = W / 8 (rounded up to a power of two) threads cover a tile's
//     lanes and THREADS / G tiles run at once; each thread writes its RG
//     rows' forward partial sums to shared memory, and after a __syncwarp
//     one thread per (row, component) sums the G partials in thread order
//     (fewer shared-memory operations than a shuffle butterfly per row,
//     which timed markedly slower);
//   * the block stages the own rows (x, y, z, f) of each pass of tiles in
//     shared memory; each tile group loads its window (neighbour slot by
//     rank, the wrap's z + Lz applied) from global memory in coalesced
//     rows into its own scratch, from which a thread reads its lanes in
//     16-byte loads; the same scratch then holds the group's row sums and
//     its transposed partials.  After each pass the tiles' partials are
//     added into the rank accumulator in tile order by one thread per
//     rank.  No float atomics: reruns are bitwise equal;
//   * shared memory grows with S only by the rank accumulator, 3 NRHS
//     (S + W) floats, beside at most 81 KB (one RHS) or 121 KB (two) of
//     fixed size: one RHS launches at S up to 12,128 or more, two up to
//     4,384 or more (W = 64, R = 32), above build_mv's limits in banded.cu
//     (5,632 and 3,408 at most);
//   * the blocks with a transposed half run first and the lighter h = 0
//     blocks last, where they fill the grid's last wave (1080 blocks, two
//     per SM at the bench shapes).
// Its H100 times are in PERF.md.
#include "common.cuh"

namespace {

constexpr int N_HALF = 5;
constexpr int THREADS = 256;
constexpr int LPT = 8;  // window lanes per thread

__constant__ int OX[N_HALF] = {0, 0, 1, 1, 1};
__constant__ int OY[N_HALF] = {0, 1, -1, 0, 1};

struct MV {
  const float *px, *py, *pz;  // (C, S) slot coordinates
  const float* f;             // (3 NRHS, C, S) right-hand sides, pads 0
  const int* j0;              // (5, C, T) window start ranks
  const float* zsh;           // (5, C, T) window z image shifts
  const int* n_valid;         // (C,) occupied slots per column
  int ncx, ncy, S, R, W, T, G;
  float Lx, Ly, Lz, tilt;
  const void* A;  // (C, 2, S, 5W) block dtype: (imrr, bco/d^2)
  float* uo;      // (C, 9, 3 NRHS, S)
};

// LPT consecutive coefficients of one A row (16-byte aligned)
template <typename AT>
struct Coef8;

template <>
struct Coef8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float operator[](int l) const {
    const unsigned w = l < 2 ? v.x : (l < 4 ? v.y : (l < 6 ? v.z : v.w));
    return __uint_as_float((l & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Coef8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ float operator[](int l) const {
    const float4& q = l < 4 ? a : b;
    const int m = l & 3;
    return m == 0 ? q.x : (m == 1 ? q.y : (m == 2 ? q.z : q.w));
  }
};

// Own rows staged per pass of tiles: the P = THREADS / G tiles that run at
// once, or all T.
__host__ __device__ __forceinline__ int pass_rows(int G, int T, int R) {
  return (THREADS / G < T ? THREADS / G : T) * R;
}

// A tile group's scratch: its window's 3 + NF rows of G LPT lanes, which
// the forward sums of a load group (RG NF G <= 4 NF G floats) and then
// the transposed partials (NF rows) reuse; one row of padding when
// several groups share a warp.
__host__ __device__ __forceinline__ int group_floats(int nf, int G) {
  return (3 + nf) * G * LPT + (G < 32 ? G : 0);
}

// Shared memory floats: a pass's own (x, y, z, 0) and NRHS (f, 0) rows as
// float4, the rank accumulator, the P tile groups' scratch, and the
// per-tile j0 and zsh.
size_t smem_floats(int nrhs, int S, int W, int T, int G, int R) {
  const int nf = 3 * nrhs;
  return 4 * (size_t)(1 + nrhs) * pass_rows(G, T, R) +
         (size_t)nf * (S + W) + (size_t)(THREADS / G) * group_floats(nf, G) +
         2 * (size_t)T;
}

template <int NRHS, typename AT, bool TR>
__device__ __forceinline__ void column_block(const MV& b, float* smem,
                                             const int c, const int h) {
  constexpr int NF = 3 * NRHS;
  constexpr int RG = sizeof(AT) == 2 ? 4 : 2;  // rows per load group
  const int S = b.S, W = b.W, R = b.R, T = b.T, G = b.G;
  const int SW = S + W, P = THREADS / G, GL = G * LPT;
  const int PR = pass_rows(G, T, R);
  const int C = b.ncx * b.ncy;
  const long long CS = (long long)C * S;
  const int tid = threadIdx.x;

  const int cx = c / b.ncy, cy = c % b.ncy;
  const int ox = OX[h], oy = OY[h];
  const int nbr =
      ((cx + ox + b.ncx) % b.ncx) * b.ncy + (cy + oy + b.ncy) % b.ncy;
  const int nv = b.n_valid[nbr];
  const int Tv = (b.n_valid[c] + R - 1) / R;  // tiles with occupied rows
  const float wx = (cx + ox >= b.ncx) ? 1.f : ((cx + ox < 0) ? -1.f : 0.f);
  const float wy = (cy + oy >= b.ncy) ? 1.f : ((cy + oy < 0) ? -1.f : 0.f);
  const float sy = wy * b.Ly;
  const float sx = __fadd_rn(wx * b.Lx, __fmul_rn(b.tilt, sy));

  float4* ownp = reinterpret_cast<float4*>(smem);          // PR
  float4* ownf = ownp + PR;                                 // NRHS x PR
  float* acc = reinterpret_cast<float*>(ownf + NRHS * PR);  // NF x SW
  const int WS = group_floats(NF, G);
  float* scr = acc + NF * SW;                                // P x WS
  int* tj0 = reinterpret_cast<int*>(scr + P * WS);           // T
  float* tzs = reinterpret_cast<float*>(tj0 + T);            // T

  // the own rows of the pass of tiles from t0
  auto stage_own = [&](int t0) {
    const int i0 = t0 * R, n = min(PR, Tv * R - i0);
    for (int s = tid; s < n; s += THREADS) {
      const long long o = (long long)c * S + i0 + s;
      ownp[s] = make_float4(b.px[o], b.py[o], b.pz[o], 0.f);
#pragma unroll
      for (int r = 0; r < NRHS; ++r)
        ownf[r * PR + s] = make_float4(b.f[3 * r * CS + o],
                                       b.f[(3 * r + 1) * CS + o],
                                       b.f[(3 * r + 2) * CS + o], 0.f);
    }
  };
  stage_own(0);
  for (int t = tid; t < T; t += THREADS) {
    const long long wt = ((long long)h * C + c) * T + t;
    tj0[t] = b.j0[wt];
    tzs[t] = b.zsh[wt];
  }
  if (TR)
    for (int s = tid; s < NF * SW; s += THREADS) acc[s] = 0.f;
  float* fwd = b.uo + ((long long)c * 9 + h) * NF * S;
  for (int s = Tv * R + tid; s < S; s += THREADS)
#pragma unroll
    for (int k = 0; k < NF; ++k) fwd[k * S + s] = 0.f;
  __syncthreads();

  const int p = tid / G, g = tid % G, w0 = g * LPT;
  float* grp = scr + p * WS;  // this tile group's scratch
  const bool lanes = w0 < W;  // W = 192 leaves a quarter of the group idle
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((tid & 31) & ~(G - 1));
  const AT* A = reinterpret_cast<const AT*>(b.A);
  const long long a_row = (long long)N_HALF * W;

  for (int t0 = 0; t0 < Tv; t0 += P) {
    if (t0 > 0) {  // the last pass is done with its own rows
      __syncthreads();
      stage_own(t0);
      __syncthreads();
    }
    const int t = t0 + p;
    if (t < Tv) {  // the same for the G threads of a tile
      const int j0 = tj0[t];
      const float zs = tzs[t];
      const AT* a_im = A + ((long long)c * 2 * S + (long long)t * R) * a_row +
                       (long long)h * W + w0;
      const AT* a_bq = a_im + (long long)S * a_row;
      auto load_rows = [&](Coef8<AT>* im, Coef8<AT>* bq, int i0) {
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          if (lanes) {
            im[rr].load(a_im + (i0 + rr) * a_row);
            bq[rr].load(a_bq + (i0 + rr) * a_row);
          } else {
            im[rr].zero();
            bq[rr].zero();
          }
        }
      };
      Coef8<AT> im[RG], bq[RG];
      load_rows(im, bq, 0);  // in flight while the window loads
      // the window's GL lanes into the scratch, lane wl of each row by
      // thread wl % G: rank q < nv is slot q, rank q >= nv is slot q - nv
      // one period up
#pragma unroll
      for (int m = 0; m < LPT; ++m) {
        const int wl = g + G * m;
        const int q = min(j0 + wl, SW - 1);
        const bool wrap = q >= nv;
        const long long o =
            (long long)nbr * S + min(wrap ? q - nv : q, S - 1);
        grp[wl] = __ldg(b.px + o) + sx;
        grp[GL + wl] = __ldg(b.py + o) + sy;
        grp[2 * GL + wl] = (__ldg(b.pz + o) + (wrap ? b.Lz : 0.f)) - zs;
#pragma unroll
        for (int k = 0; k < NF; ++k)
          grp[(3 + k) * GL + wl] = __ldg(b.f + k * CS + o);
      }
      __syncwarp(gmask);
      // this thread's LPT lanes of each row, two 16-byte loads a row
      float xw[LPT], yw[LPT], zw[LPT], fw[NF][LPT], tp[NF][LPT];
      auto lanes8 = [&](float* dst, int row) {
        const float4* src =
            reinterpret_cast<const float4*>(grp + row * GL + w0);
        const float4 lo = src[0], hi = src[1];
        dst[0] = lo.x, dst[1] = lo.y, dst[2] = lo.z, dst[3] = lo.w;
        dst[4] = hi.x, dst[5] = hi.y, dst[6] = hi.z, dst[7] = hi.w;
      };
      lanes8(xw, 0);
      lanes8(yw, 1);
      lanes8(zw, 2);
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        lanes8(fw[k], 3 + k);
#pragma unroll
        for (int l = 0; l < LPT; ++l) tp[k][l] = 0.f;
      }
      __syncwarp(gmask);  // the scratch holds the row sums from here
      float* redp = grp;
      for (int i0 = 0; i0 < R; i0 += RG) {
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const int i = p * R + i0 + rr;  // row t R + i0 + rr of the column
          const float4 pi = ownp[i];
          float fi[NF], u[NF];
#pragma unroll
          for (int r = 0; r < NRHS; ++r) {
            const float4 q = ownf[r * PR + i];
            fi[3 * r] = q.x;
            fi[3 * r + 1] = q.y;
            fi[3 * r + 2] = q.z;
          }
#pragma unroll
          for (int k = 0; k < NF; ++k) u[k] = 0.f;
#pragma unroll
          for (int l = 0; l < LPT; ++l) {
            const float F1 = im[rr][l], Bq = bq[rr][l];
            const float dx = pi.x - xw[l], dy = pi.y - yw[l],
                        dz = pi.z - zw[l];
#pragma unroll
            for (int r = 0; r < NRHS; ++r) {
              const float gq = Bq * (dx * fw[3 * r][l] + dy * fw[3 * r + 1][l] +
                                     dz * fw[3 * r + 2][l]);
              u[3 * r] = fmaf(gq, dx, fmaf(F1, fw[3 * r][l], u[3 * r]));
              u[3 * r + 1] =
                  fmaf(gq, dy, fmaf(F1, fw[3 * r + 1][l], u[3 * r + 1]));
              u[3 * r + 2] =
                  fmaf(gq, dz, fmaf(F1, fw[3 * r + 2][l], u[3 * r + 2]));
              if (TR) {
                const float gi = Bq * (dx * fi[3 * r] + dy * fi[3 * r + 1] +
                                       dz * fi[3 * r + 2]);
                tp[3 * r][l] =
                    fmaf(gi, dx, fmaf(F1, fi[3 * r], tp[3 * r][l]));
                tp[3 * r + 1][l] =
                    fmaf(gi, dy, fmaf(F1, fi[3 * r + 1], tp[3 * r + 1][l]));
                tp[3 * r + 2][l] =
                    fmaf(gi, dz, fmaf(F1, fi[3 * r + 2], tp[3 * r + 2][l]));
              }
            }
          }
          // the row's partial sums, one per thread of the tile
#pragma unroll
          for (int k = 0; k < NF; ++k) redp[(rr * NF + k) * G + g] = u[k];
        }
        // forward rows: each of the group's RG NF sums over the G threads,
        // in thread order, by one thread
        __syncwarp(gmask);
        for (int o = g; o < RG * NF; o += G) {
          const float4* v = reinterpret_cast<const float4*>(redp + o * G);
          float sum = 0.f;
          for (int q = 0; q < G / 4; ++q) {
            const float4 x = v[q];
            sum += x.x;
            sum += x.y;
            sum += x.z;
            sum += x.w;
          }
          fwd[(o % NF) * S + t * R + i0 + o / NF] = sum;
        }
        __syncwarp(gmask);
        if (i0 + RG < R) load_rows(im, bq, i0 + RG);
      }
      if (TR && lanes)
#pragma unroll
        for (int k = 0; k < NF; ++k)
#pragma unroll
          for (int l = 0; l < LPT; ++l)
            grp[k * GL + w0 + l] = tp[k][l];
    }
    if (TR) {
      // the pass's partials into the ranks, in tile order
      __syncthreads();
      const int np = min(P, Tv - t0);
      for (int q = tid; q < SW; q += THREADS) {
        float s[NF];
#pragma unroll
        for (int k = 0; k < NF; ++k) s[k] = acc[k * SW + q];
        for (int pp = 0; pp < np; ++pp) {
          const int d = q - tj0[t0 + pp];
          if (d >= 0 && d < W)
#pragma unroll
            for (int k = 0; k < NF; ++k) s[k] += scr[pp * WS + k * GL + d];
        }
#pragma unroll
        for (int k = 0; k < NF; ++k) acc[k * SW + q] = s[k];
      }
      __syncthreads();
    }
  }

  // fold cyclic ranks to slots: ranks < nv are slots, ranks in [nv, nv + W)
  // wrap to slots [0, W)
  if (TR) {
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

template <int NRHS, typename AT>
__global__ void __launch_bounds__(THREADS, NRHS == 1 ? 2 : 1)
    matvec_kernel(MV b) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the blocks with a transposed half first, the lighter h = 0 ones last,
  // so that they fill the last wave
  const int C = b.ncx * b.ncy;
  const int item = blockIdx.x + C * blockIdx.y;
  const int c = item % C, h = item < (N_HALF - 1) * C ? 1 + item / C : 0;
  if (h > 0)
    column_block<NRHS, AT, true>(b, smem, c, h);
  else
    column_block<NRHS, AT, false>(b, smem, c, h);
}

template <int NRHS, typename AT>
cudaError_t launch(const MV& b, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * smem_floats(NRHS, b.S, b.W, b.T, b.G, b.R);
  auto kernel = matvec_kernel<NRHS, AT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b.ncx * b.ncy, N_HALF);
  kernel<<<grid, THREADS, smem, stream>>>(b);
  return cudaGetLastError();
}

template <typename AT>
cudaError_t dispatch(int nrhs, const MV& b, cudaStream_t stream) {
  if (nrhs == 1) return launch<1, AT>(b, stream);
  if (nrhs == 2) return launch<2, AT>(b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pse_banded_matvec(int nrhs, const float* px, const float* py,
                                 const float* pz, const float* f,
                                 const int* j0, const float* zsh,
                                 const int* n_valid, int ncx, int ncy, int S,
                                 int R, int W, float Lx, float Ly, float Lz,
                                 float tilt, int a_bf16, const void* A,
                                 float* uo, cudaStream_t stream) {
  // R a multiple of 8 (so of each load group) dividing S; W a multiple of
  // 64 up to 256, so that every A row segment is 16-byte aligned
  if (R % 8 != 0 || R > 32 || S % R != 0 || W % 64 != 0 || W > 256 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int G = 8;
  while (G * LPT < W) G *= 2;
  const MV b{px, py, pz, f,     j0, zsh, n_valid, ncx, ncy, S, R,
             W,  S / R, G, Lx, Ly, Lz,  tilt,    A,   uo};
  const cudaError_t e = a_bf16 ? dispatch<__nv_bfloat16>(nrhs, b, stream)
                               : dispatch<float>(nrhs, b, stream);
  return (int)e;
}

// Banded near-field mobility on the H100: the pair-coefficient build and
// the matvec that streams the stored coefficients back to one or two
// right-hand sides: two kernels that share their tile layout.
//
// Replaces three Pallas kernels of pse_tpu/ops/banded_nearfield.py:
//   * `_matvec_kernel` (:1147, launched by `matvec_banded`, :1392): u =
//     M_real f from one read of the stored A;
//   * `_build_kernel` (:733, launched by `build_banded_blocks`, :894): build
//     A = (imrr, bco/d^2) over the half stencil (the TPU kernel's second
//     output, the prefolded coordinates pos_cyc, feeds only its MXU matvec
//     and has no counterpart);
//   * `_build_mv_kernel` (:1472, launched by `build_mv_banded`, :1693): build
//     A and apply it at once.  Here that is the build kernel, then the matvec
//     kernel on the A it wrote (banded_nearfield._launch_banded): versions
//     that built each tile inside the matvec's block kept its registers and
//     shared memory and timed slower on the H100 at one and two right-hand
//     sides (PERF.md).  So build_mv's u is the matvec's u on its A,
//     bit for bit, and Lanczos sees one operator.
// The float32 build equals its plain version `build_banded_blocks_reference`
// bit for bit; a bfloat16 A is that float32 A rounded once.
//
// Semantics (per column c and stored offset h, h in 0..4):
//   * the neighbour column is c + (OX[h], OY[h]) on the periodic column grid;
//     its xy image shift at the grid edge includes the tilt:
//     sx = wx*Lx + tilt*sy, sy = wy*Ly;
//   * the window of tile t is in cyclic rank coordinates: lane w is rank
//     j0 + w, slot j = rank (rank < nv) or rank - nv with z + Lz (rank >= nv),
//     nv the neighbour's valid count; lanes w >= nv are masked;
//   * the matvec subtracts the per-(offset, column, tile) z shift zsh from
//     the window z, so its dz needs no per-pair minimum-image round; the
//     build, which decides which pairs are valid, takes dz as the stored z
//     separation less the lane's image, which for every valid pair is the
//     minimum image in the float32 operations of
//     box.min_image_components, so that a pair within rounding of rcut is
//     valid from both of its slots (the offset-0 windows visit it twice;
//     dx and dy there are exact negatives) and in the plain 9-offset
//     version alike;
//   * valid pairs have dr^2 <= d^2 < rcut^2, both slots occupied (slot masks
//     are 0 or 1, the CellBins contract), and are not the self pair
//     (excluded at offset 0 only); the Chebyshev branch select is at r = 2a;
//   * the forward product u_i += F1 f_j + Bq d (d . f_j) goes to plane h of
//     uo (C, 9, 3 NRHS, S); for h >= 1 the transposed product u_j += F1 f_i +
//     Bq d (d . f_i) is summed by cyclic rank, folded to slots and written to
//     plane 4 + h at the OWN column; torch sums the forward planes and rolls
//     the transposed ones onto their target columns
//     (banded_nearfield._finish_u).
//
// Occupancy classes (spec.classes, the TPU kernels' `pack=`): A is stored
// per class in one allocation, class k as (c_k, 2, t_k R, 5W) for the packed
// columns perm[off_k, off_k + c_k), the tiles at or past t_k not stored.  One
// launch covers every class: the matvec's grid walks (packed column p,
// offset), the build's (offset, packed column p, tile t < t_k(p)), each
// block finding its class in a table of at most MAXK entries held in the
// kernel's parameters, and each block reads its own rows and writes its u
// planes at the actual column perm[p], so no gather restores the order.
// Without classes (a null perm) the table is one class of T = S / R tiles
// and perm the identity; the matvec is then instantiated with PK = false,
// the single-class code with the packed indirection compiled out (with it,
// the single-class matvec timed 14 % slower on the H100, PERF.md); the
// build reads the one-class table (it timed the same).
//
// What bounds them on the H100: A.  At bench scale (C = 216, S = 576, R =
// 32, W = 128, bf16) A is 318.5 MB, >= 95 us at 3.35 TB/s, written by the
// build and read by the matvec.  The arithmetic is of the same order on the
// CUDA cores: the matvec's ~25 float32 instructions per stored pair and
// right-hand side, forward and transposed, over the ~66 M pairs of the
// non-empty tiles; the build's geometry and validity test of each of those
// pairs (~12), and for the ~5 M valid ones (nonzero A) the pair functions:
// a square root, two IEEE divisions and two degree-8 Clenshaw recurrences
// rounded step by step (~100).  The design:
//   * tiles past ceil(n_valid[c] / R) hold no occupied row, so their A and
//     f rows are zero: the matvec skips them and writes their forward rows
//     as zeros, the build stores their A rows as zeros (~17 % of A at bench
//     scale);
//   * a thread owns LPT = 8 window lanes of one tile for all R rows, RG rows
//     at a time: one 16-byte load or store per A plane and row (two at
//     float32); G = W / 8 (rounded up to a power of two) threads cover a
//     tile's lanes, and each tile group loads its window (neighbour slot by
//     rank; in the matvec, the wrap's z + Lz and zsh applied) from global
//     memory in coalesced rows
//     into its own shared-memory scratch, from which a thread reads its
//     lanes in 16-byte loads into registers;
//   * the matvec: one block per (column c, offset h), the own rows
//     of each pass of THREADS / G tiles staged in shared memory, the lanes'
//     f in registers so the transposed sums stay in registers over the
//     tile; each thread writes its RG rows' forward partial sums to its
//     group's scratch, and after a __syncwarp one thread per (row,
//     component) sums the G partials in thread order (fewer shared-memory
//     operations than a shuffle butterfly per row, which timed markedly
//     slower); after each pass the tiles' transposed partials are added into
//     the rank accumulator in tile order by one thread per rank.  No float
//     atomics: reruns are bitwise equal.  Its shared memory grows with S
//     only by that accumulator, 3 NRHS (S + W) floats, beside at most 81 KB
//     (one RHS) or 121 KB (two): it launches at S up to 12,128 or more with
//     one RHS and 4,384 or more with two (W = 64, R = 32).  The blocks with
//     a transposed half run first and the lighter h = 0 blocks last, where
//     they fill the grid's last wave;
//   * the build runs on a grid of tiles: each tile group takes one (offset,
//     column, tile), so blocks are of one size (per (column, offset) they
//     left a long last wave: 0.19 against 0.145 ms on the H100, PERF.md),
//     and its shared memory does not grow with S.  It computes the pair
//     functions only where a pair is valid (a branch per pair would run
//     them whenever any lane of the warp needs them, nearly always): for RG
//     rows it tests every pair, queues the valid ones (d^2 and destination)
//     in its group's scratch, each thread's in lane order at a prefix of
//     the group's counts taken from ballots of their bits, evaluates the
//     queue two entries per thread with every thread busy (the main path's
//     nine coefficients unrolled), writes the rounded coefficients into the
//     RG rows staged in shared memory (zeros elsewhere), and stores each
//     thread's lanes with 16-byte stores.
// Their H100 times and resources are in PERF.md.
#include "common.cuh"

namespace {

constexpr int N_HALF = 5;
constexpr int THREADS = 256;
constexpr int LPT = 8;  // window lanes per thread
constexpr int MAXK = 4;  // occupancy classes at most (3 below the cap + 1)

__constant__ int OX[N_HALF] = {0, 0, 1, 1, 1};
__constant__ int OY[N_HALF] = {0, 1, -1, 0, 1};

struct Band {
  const float *px, *py, *pz;  // (C, S) slot coordinates
  const float* mask;          // (C, S) slot occupancy, 0 or 1 (build)
  const float* f;             // (3 NRHS, C, S) right-hand sides, pads 0
  const int* j0;              // (5, C, T) window start ranks
  const float* zsh;           // (5, C, T) window z image shifts
  const int* n_valid;         // (C,) occupied slots per column
  const float* cheb;          // chebyshev.device_coeffs layout (build)
  int n_coef;
  float mid, cut2, dr2;
  int ncx, ncy, S, R, W, T, G;
  float Lx, Ly, Lz, tilt;
  void* A;    // (C, 2, S, 5W) block dtype: (imrr, bco/d^2), or by class
  float* uo;  // (C, 9, 3 NRHS, S)
  // occupancy classes in packed (need-descending) order
  const int* perm;        // (C,) packed -> actual column, or null (identity)
  int K;                  // number of classes (1 without packing)
  int ct[MAXK];           // tiles stored per column of class k
  int coff[MAXK];         // first packed column of class k
  int ctl[MAXK];          // first entry of class k in a tile list of offset
  long long cbase[MAXK];  // A element offset of class k
  int TT;                 // stored tiles per offset, sum_k c_k ct[k]
};

// Fills the class table: n_classes (tiles, columns) pairs in packed order,
// or none for one class of all T tiles (entries past K are never read).
// False if they do not fit.
bool set_classes(Band& b, const int* perm, int n_classes, const int* tiles,
                 const int* cols) {
  const int C = b.ncx * b.ncy;
  b.perm = perm;
  b.K = n_classes > 0 ? n_classes : 1;
  if (b.K > MAXK || (n_classes > 0 && perm == nullptr)) return false;
  long long base = 0;
  int off = 0, tl = 0;
  for (int k = 0; k < b.K; ++k) {
    const int t = n_classes > 0 ? tiles[k] : b.T;
    const int c = n_classes > 0 ? cols[k] : C;
    if (t < 1 || t > b.T || c < 1) return false;
    b.ct[k] = t;
    b.coff[k] = off;
    b.ctl[k] = tl;
    b.cbase[k] = base;
    off += c;
    tl += c * t;
    base += (long long)c * 2 * t * b.R * N_HALF * b.W;
  }
  b.TT = tl;
  return off == C;
}

// Packed column p: its actual column, its class's stored tiles and the A
// element offset of its (2, tiles R, 5W) block.
struct Packed {
  int c, tk;
  long long base;
};

__device__ __forceinline__ Packed packed_column(const Band& b, int p) {
  int tk = b.ct[0], off = b.coff[0];
  long long base = b.cbase[0];
#pragma unroll
  for (int k = 1; k < MAXK; ++k)
    if (k < b.K && p >= b.coff[k]) {
      tk = b.ct[k];
      off = b.coff[k];
      base = b.cbase[k];
    }
  Packed q;
  q.c = b.perm ? b.perm[p] : p;
  q.tk = tk;
  q.base = base + (long long)(p - off) * 2 * tk * b.R * (N_HALF * b.W);
  return q;
}

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
// float4, the rank accumulator, the P tile groups' scratch, the per-tile
// j0 and zsh, and with classes the column's first A row and stored tiles.
size_t smem_floats(int nrhs, int S, int W, int T, int G, int R, bool pk) {
  const int nf = 3 * nrhs;
  return 4 * (size_t)(1 + nrhs) * pass_rows(G, T, R) +
         (size_t)nf * (S + W) + (size_t)(THREADS / G) * group_floats(nf, G) +
         2 * (size_t)T + (pk ? 2 : 0);
}

template <int NRHS, typename AT, bool TR, bool PK>
__device__ __forceinline__ void column_block(const Band& b, float* smem,
                                             const int pc, const int h) {
  constexpr int NF = 3 * NRHS;
  constexpr int RG = sizeof(AT) == 2 ? 4 : 2;  // rows per load group
  const int S = b.S, W = b.W, R = b.R, T = b.T, G = b.G;
  const int SW = S + W, P = THREADS / G, GL = G * LPT;
  const int PR = pass_rows(G, T, R);
  const int C = b.ncx * b.ncy;
  const long long CS = (long long)C * S;
  const int tid = threadIdx.x;

  // packed column pc is column c (pc itself without classes)
  const Packed col = PK ? packed_column(b, pc) : Packed{pc, T, 0};
  const int c = col.c;
  const int cx = c / b.ncy, cy = c % b.ncy;
  const int ox = OX[h], oy = OY[h];
  const int nbr =
      ((cx + ox + b.ncx) % b.ncx) * b.ncy + (cy + oy + b.ncy) % b.ncy;
  const int nv = b.n_valid[nbr];
  // tiles with occupied rows, within the stored ones (a column past its
  // class's tiles is flagged by class_assignment)
  const int Tv = PK ? min((b.n_valid[c] + R - 1) / R, col.tk)
                    : (b.n_valid[c] + R - 1) / R;
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
  // with classes: the column's first A row and its stored tiles, read from
  // here per tile so that no register holds them across the tile loop
  int* tcol = reinterpret_cast<int*>(tzs + T);               // 2

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
  if (PK && tid == 0) {
    tcol[0] = (int)(col.base / ((long long)N_HALF * W));
    tcol[1] = col.tk;
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
      const AT* a_im =
          A + ((PK ? (long long)tcol[0] : (long long)c * 2 * S) +
               (long long)t * R) * a_row +
          (long long)h * W + w0;
      const AT* a_bq = a_im + (long long)(PK ? tcol[1] * R : S) * a_row;
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

template <int NRHS, typename AT, bool PK>
__global__ void __launch_bounds__(THREADS, NRHS == 1 ? 2 : 1)
    matvec_kernel(Band b) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the blocks with a transposed half first, the lighter h = 0 ones last,
  // so that they fill the last wave; p is a packed column
  const int C = b.ncx * b.ncy;
  const int item = blockIdx.x + C * blockIdx.y;
  const int p = item % C, h = item < (N_HALF - 1) * C ? 1 + item / C : 0;
  if (h > 0)
    column_block<NRHS, AT, true, PK>(b, smem, p, h);
  else
    column_block<NRHS, AT, false, PK>(b, smem, p, h);
}

template <int NRHS, typename AT, bool PK>
cudaError_t launch(const Band& b, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * smem_floats(NRHS, b.S, b.W, b.T, b.G, b.R, PK);
  auto kernel = matvec_kernel<NRHS, AT, PK>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(b.ncx * b.ncy, N_HALF);
  kernel<<<grid, THREADS, smem, stream>>>(b);
  return cudaGetLastError();
}

template <typename AT>
cudaError_t dispatch(int nrhs, const Band& b, cudaStream_t stream) {
  const bool pk = b.perm != nullptr;
  if (nrhs == 1)
    return pk ? launch<1, AT, true>(b, stream) : launch<1, AT, false>(b, stream);
  if (nrhs == 2)
    return pk ? launch<2, AT, true>(b, stream) : launch<2, AT, false>(b, stream);
  return cudaErrorInvalidValue;
}

// The build's coefficients at a valid d^2, (imrr, bco / d^2): the pair
// functions (common.cuh) and a true division, as the plain build rounds them.
template <int NC>
__device__ __forceinline__ void pair_coefs(const float* cf, int n, float mid,
                                           float d2, float& s1, float& s2) {
  float uf2;
  pair_functions<NC>(cf, n, mid, d2, s1, uf2);
  s2 = (uf2 - s1) / d2;
}

// A build tile group's scratch: its window's 4 rows (x, y, z, mask) of G
// LPT lanes, then a queue of RG G LPT valid pairs (d^2 and destination)
// and the RG rows' two A planes staged in the block dtype (RG = 8 /
// a_bytes rows at a time); one row of padding when several groups share a
// warp.
__host__ __device__ __forceinline__ int build_floats(int G, int a_bytes) {
  const int GL = G * LPT, rg = 8 / a_bytes;
  return 2 * rg * GL + rg * GL * a_bytes / 2 + (G < 32 ? G : 0);
}

// The build over a grid of tiles: tile group p of block x takes tile k = x P
// + p of the (offset, packed column, stored tile) list, occupied or not (an
// empty tile's rows are stored as zeros from its empty staging), so the
// blocks are of one size and the last wave is short.
template <typename AT, int NC>
__global__ void __launch_bounds__(THREADS, 2) build_tiles(Band b) {
  constexpr int RG = sizeof(AT) == 2 ? 4 : 2;  // rows per batch
  constexpr int V = LPT * sizeof(AT) / 16;     // 16-byte words per segment
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = b.S, W = b.W, R = b.R, T = b.T, G = b.G;
  const int SW = S + W, P = THREADS / G, GL = G * LPT;
  const int C = b.ncx * b.ncy;
  const int tid = threadIdx.x, p = tid / G, g = tid % G, w0 = g * LPT;
  const int nc = b.n_coef;
  const int CF = (4 + 4 * nc + 3) & ~3;
  float* cf = smem;                                            // CF
  float4* own = reinterpret_cast<float4*>(smem + CF) + p * R;  // R a group
  const int WS = build_floats(G, sizeof(AT));
  float* grp = smem + CF + 4 * P * R + p * WS;                 // WS a group
  for (int s = tid; s < 4 + 4 * nc; s += THREADS) cf[s] = b.cheb[s];

  // this group's tile: offset h, packed column pc (column c), tile t, the
  // stored tiles of one (pc, h) consecutive; live if it holds an occupied row
  const int k = blockIdx.x * P + p;
  const bool tile = k < N_HALF * b.TT;
  const int kk = tile ? k : 0;
  const int h = kk / b.TT, ent = kk % b.TT;
  int tl = b.ctl[0], tk = b.ct[0], off = b.coff[0];
  long long base = b.cbase[0];
#pragma unroll
  for (int q = 1; q < MAXK; ++q)
    if (q < b.K && ent >= b.ctl[q]) {
      tl = b.ctl[q];
      tk = b.ct[q];
      off = b.coff[q];
      base = b.cbase[q];
    }
  const int pc = off + (ent - tl) / tk, t = (ent - tl) % tk;
  const int c = b.perm ? b.perm[pc] : pc;
  const int cx = c / b.ncy, cy = c % b.ncy;
  const int ox = OX[h], oy = OY[h];
  const int nbr =
      ((cx + ox + b.ncx) % b.ncx) * b.ncy + (cy + oy + b.ncy) % b.ncy;
  const int nv = b.n_valid[nbr];
  const bool live = tile && t * R < b.n_valid[c];
  const float wx = (cx + ox >= b.ncx) ? 1.f : ((cx + ox < 0) ? -1.f : 0.f);
  const float wy = (cy + oy >= b.ncy) ? 1.f : ((cy + oy < 0) ? -1.f : 0.f);
  const float sy = wy * b.Ly;
  const float sx = __fadd_rn(wx * b.Lx, __fmul_rn(b.tilt, sy));
  const long long wt = ((long long)h * C + c) * T + t;
  const int j0 = b.j0[wt];
  // dz is the stored z separation less Lz times the lane's z image kz (its
  // wrap, less the tile's zsh over Lz), rounded as
  // box.min_image_components rounds the minimum image: where kz is the
  // nearest image (every pair within rcut < Lz / 2, unless a tile's band
  // spans nearly Lz) the two are the same float, and elsewhere |dz| > Lz /
  // 2 > rcut; so the offset-0 windows, which visit a pair from both of its
  // slots, take one d^2 for it
  const float kzs = rintf(__fdiv_rn(b.zsh[wt], b.Lz));
  // its own rows, and its window's GL lanes, lane wl of each row by thread
  // wl % G: rank q < nv is slot q, rank q >= nv is slot q - nv (z as
  // stored: the pair's z image comes from its separation)
  if (live) {
    for (int r = g; r < R; r += G) {
      const long long o = (long long)c * S + t * R + r;
      own[r] = make_float4(b.px[o], b.py[o], b.pz[o], b.mask[o]);
    }
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
      const int wl = g + G * m;
      const int q = min(j0 + wl, SW - 1);
      const bool wrap = q >= nv;
      const long long o = (long long)nbr * S + min(wrap ? q - nv : q, S - 1);
      grp[wl] = __ldg(b.px + o) + sx;
      grp[GL + wl] = __ldg(b.py + o) + sy;
      grp[2 * GL + wl] = __ldg(b.pz + o);
      grp[3 * GL + wl] = wl < nv ? __ldg(b.mask + o) : 0.f;
    }
  }
  __syncthreads();
  const bool lanes = w0 < W;
  float xw[LPT], yw[LPT], zw[LPT], mw[LPT];
  auto lanes8 = [&](float* dst, int row) {
    const float4* src = reinterpret_cast<const float4*>(grp + row * GL + w0);
    const float4 lo = src[0], hi = src[1];
    dst[0] = lo.x, dst[1] = lo.y, dst[2] = lo.z, dst[3] = lo.w;
    dst[4] = hi.x, dst[5] = hi.y, dst[6] = hi.z, dst[7] = hi.w;
  };
  lanes8(xw, 0);
  lanes8(yw, 1);
  lanes8(zw, 2);
  lanes8(mw, 3);
  unsigned mwb = 0;  // this thread's occupied lanes
  float lzk[LPT];    // Lz kz of each lane
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    mwb |= (live && lanes && mw[l] > 0.f) << l;
    lzk[l] = b.Lz * ((j0 + w0 + l >= nv ? 1.f : 0.f) - kzs);
  }
  // every shuffle, ballot and __syncwarp takes the whole warp: a group
  // whose tile is empty or past the list runs along with no valid pair
  const bool warp_live = __any_sync(0xffffffffu, live);
  __syncwarp();  // the scratch holds the queue from here
  AT* A = reinterpret_cast<AT*>(b.A);
  const long long a_row = (long long)N_HALF * W;
  AT* a_im = A + base + ((long long)(pc - off) * 2 * tk + t) * R * a_row +
             (long long)h * W + w0;
  AT* a_bq = a_im + (long long)tk * R * a_row;
  // the queue: each valid pair's d^2 and its destination, the lane index in
  // the staged planes of the RG rows
  float2* queue = reinterpret_cast<float2*>(grp);
  AT* stg = reinterpret_cast<AT*>(grp + 2 * RG * GL);
  const int rb = j0 + w0;  // rank of this thread's lane 0
  const unsigned lane = tid & 31;
  const unsigned gbits =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned before = gbits & ((1u << lane) - 1u);
  for (int i0 = 0; i0 < R; i0 += RG) {
    // every pair's geometry and validity; the valid pairs go to the queue,
    // each thread's in lane order after those of the threads before it;
    // this thread's staged lanes start at zero
    int n = 0;  // entries the group has queued
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp)
#pragma unroll
        for (int v = 0; v < V; ++v)
          reinterpret_cast<uint4*>(stg + (kp * RG + rr) * GL + w0)[v] =
              make_uint4(0u, 0u, 0u, 0u);
      if (!warp_live) continue;
      const int i = t * R + i0 + rr;  // own slot
      const float4 pi = own[i0 + rr];
      // lanes that may pair with row i: occupied, and at offset 0 not its
      // own slot (rank i, or rank i + nv one period up)
      unsigned ok = pi.w > 0.f ? mwb : 0u;
      if (h == 0) {
        const int d = i - rb, e = i + nv - rb;
        if (d >= 0 && d < LPT && i < nv) ok &= ~(1u << d);
        if (e >= 0 && e < LPT) ok &= ~(1u << e);
      }
      float d2[LPT];
      unsigned bits = 0;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const float dx = pi.x - xw[l], dy = pi.y - yw[l];
        const float dz = __fsub_rn(__fsub_rn(pi.z, zw[l]), lzk[l]);
        d2[l] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                          __fmul_rn(dz, dz));
        bits |= (unsigned)(d2[l] < b.cut2 && d2[l] >= b.dr2) << l;
      }
      bits &= ok;
      // the group's prefix and total of the counts (0..8), from their bits
      const int cnt = __popc(bits);
      int pos = n, tot = 0;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const unsigned vk = __ballot_sync(0xffffffffu, (cnt >> kb) & 1);
        pos += __popc(vk & before) << kb;
        tot += __popc(vk & gbits) << kb;
      }
      n += tot;
#pragma unroll
      for (int l = 0; l < LPT; ++l)
        if ((bits >> l) & 1u)
          queue[pos++] =
              make_float2(d2[l], __int_as_float(rr * GL + w0 + l));
    }
    __syncwarp();
    // the pair functions over the queue, two entries per thread at a time,
    // every thread of the group busy; the rounded coefficients go to their
    // staged lanes
    for (int e = g; e < n; e += 2 * G) {
      const bool two = e + G < n;
      const float2 qa = queue[e], qb = queue[two ? e + G : e];
      float s1, s2, u1, u2;
      pair_coefs<NC>(cf, nc, b.mid, qa.x, s1, s2);
      pair_coefs<NC>(cf, nc, b.mid, qb.x, u1, u2);
      const int da = __float_as_int(qa.y), db = __float_as_int(qb.y);
      stg[da] = from_f32<AT>(s1);
      stg[RG * GL + da] = from_f32<AT>(s2);
      if (two) {
        stg[db] = from_f32<AT>(u1);
        stg[RG * GL + db] = from_f32<AT>(u2);
      }
    }
    __syncwarp();
    // this thread's staged lanes of the RG rows to A, both planes (zeros in
    // an empty tile)
    if (tile && lanes)
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint4* src =
              reinterpret_cast<const uint4*>(stg + rr * GL + w0);
          __stcs(reinterpret_cast<uint4*>(a_im + (i0 + rr) * a_row) + v,
                 src[v]);
          __stcs(reinterpret_cast<uint4*>(a_bq + (i0 + rr) * a_row) + v,
                 src[RG * GL * sizeof(AT) / 16 + v]);
        }
  }
}

template <typename AT, int NC>
cudaError_t launch_build(const Band& b, cudaStream_t stream) {
  const int P = THREADS / b.G;
  const size_t smem =
      sizeof(float) * (((4 + 4 * b.n_coef + 3) & ~3) + 4 * (size_t)P * b.R +
                       (size_t)P * build_floats(b.G, sizeof(AT)));
  auto kernel = build_tiles<AT, NC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = N_HALF * b.TT;
  kernel<<<(tiles + P - 1) / P, THREADS, smem, stream>>>(b);
  return cudaGetLastError();
}

// R a multiple of 8 (so of each load group) up to 32 dividing S; W a
// multiple of 64 up to 256, so that every A row segment is 16-byte aligned
bool shapes_ok(int S, int R, int W, const void* A) {
  return R % 8 == 0 && R <= 32 && S % R == 0 && W % 64 == 0 && W <= 256 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

int group_threads(int W) {
  int G = 8;
  while (G * LPT < W) G *= 2;
  return G;
}

}  // namespace

// perm, n_classes, class_tiles, class_cols: the occupancy classes in packed
// order (class_tiles and class_cols on the host, perm on the device), or
// null, 0, null, null for one class.
extern "C" int pse_banded_matvec(int nrhs, const float* px, const float* py,
                                 const float* pz, const float* f,
                                 const int* j0, const float* zsh,
                                 const int* n_valid, int ncx, int ncy, int S,
                                 int R, int W, float Lx, float Ly, float Lz,
                                 float tilt, int a_bf16, const void* A,
                                 float* uo, const int* perm, int n_classes,
                                 const int* class_tiles, const int* class_cols,
                                 cudaStream_t stream) {
  if (!shapes_ok(S, R, W, A)) return (int)cudaErrorInvalidValue;
  Band b{};
  b.px = px, b.py = py, b.pz = pz, b.f = f, b.j0 = j0, b.zsh = zsh;
  b.n_valid = n_valid;
  b.ncx = ncx, b.ncy = ncy, b.S = S, b.R = R, b.W = W, b.T = S / R;
  b.G = group_threads(W);
  b.Lx = Lx, b.Ly = Ly, b.Lz = Lz, b.tilt = tilt;
  b.A = const_cast<void*>(A), b.uo = uo;
  if (!set_classes(b, perm, n_classes, class_tiles, class_cols))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = a_bf16 ? dispatch<__nv_bfloat16>(nrhs, b, stream)
                               : dispatch<float>(nrhs, b, stream);
  return (int)e;
}

extern "C" int pse_banded_build(const float* px, const float* py,
                                const float* pz, const float* mask,
                                const int* j0, const float* zsh,
                                const int* n_valid, const float* cheb,
                                int n_coef, float mid, float cut2, float dr2,
                                int ncx, int ncy, int S, int R, int W,
                                float Lx, float Ly, float Lz, float tilt,
                                int a_bf16, void* A, const int* perm,
                                int n_classes, const int* class_tiles,
                                const int* class_cols, cudaStream_t stream) {
  if (!shapes_ok(S, R, W, A)) return (int)cudaErrorInvalidValue;
  Band b{};
  b.px = px, b.py = py, b.pz = pz, b.mask = mask, b.j0 = j0, b.zsh = zsh;
  b.n_valid = n_valid, b.cheb = cheb, b.n_coef = n_coef;
  b.mid = mid, b.cut2 = cut2, b.dr2 = dr2;
  b.ncx = ncx, b.ncy = ncy, b.S = S, b.R = R, b.W = W, b.T = S / R;
  b.G = group_threads(W);
  b.Lx = Lx, b.Ly = Ly, b.Lz = Lz, b.tilt = tilt, b.A = A;
  if (!set_classes(b, perm, n_classes, class_tiles, class_cols))
    return (int)cudaErrorInvalidValue;
  // the main path's degree-8 fits unrolled, any other degree through the
  // general recurrence
  const cudaError_t e =
      a_bf16 ? (n_coef == 9 ? launch_build<__nv_bfloat16, 9>(b, stream)
                            : launch_build<__nv_bfloat16, 0>(b, stream))
             : (n_coef == 9 ? launch_build<float, 9>(b, stream)
                            : launch_build<float, 0>(b, stream));
  return (int)e;
}

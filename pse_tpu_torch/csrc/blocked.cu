// Blocked near field on the H100: the blocked engine's pair blocks, (noff,
// 6, C, cap, cap) in the block dtype, in one launch; and their application,
// u = M_real f, in two (cell_products, cell_sums, at the end of this file).
//
// Replaces no TPU kernel: the JAX package builds the blocks in plain XLA
// (pse_tpu/ops/blocked_nearfield.py::build_pair_blocks), and its plain
// PyTorch twin (blocked_nearfield.build_pair_blocks_reference) runs one
// offset at a time on float32 (C, cap, cap) temporaries, with a rolled copy
// of each slot array, a kernel for every arithmetic step and six rounding
// copies: ~2,800 launches a step at N = 100k.
//
// Semantics (per stored offset o of a contiguous range of the half stencil,
// cell c and slot pair (i, j)):
//   * slot i of cell c pairs with slot j of cell c + o, periodic on the
//     (ncx, ncy, ncz) grid with z fastest in the flat cell id, as
//     cellbins.roll_cells; d is the minimum image of the tilted box of
//     own - other (z, then y with the tilt on x, then x);
//   * a pair is valid if both slots are occupied (masks 0 or 1), dr^2 <=
//     d^2 < rcut^2 and, at offset (0,0,0), i != j;
//   * the six components are imrr + (bco e_a) e_b with e = d (1 / sqrt(d^2)),
//     imrr = UF1 and bco = UF2 - UF1 at a valid pair, and imrr = bco = 0, e =
//     d at any other, so that every padded or invalid slot pair holds a zero
//     (its sign as the plain path's);
//   * the float32 values are those of banded_nearfield.pair_components on
//     the card bit for bit: every step is rounded as PyTorch's CUDA kernels
//     round it, with no contraction to a fused multiply-add, round half to
//     even, and a division of a tensor by a box length as a product with the
//     length's float32 reciprocal (PyTorch divides a CUDA tensor by a Python
//     scalar so); a bfloat16 block is that value rounded once.
//
// What bounds it on the H100: its writes.  At N = 100k (cells (9, 13, 13),
// cap 112, the 14 offsets of the half stencil, bfloat16) the blocks are
// 3.20 GB, 0.958 ms at 3.35 TB/s; the slot arrays it reads are 2.7 MB, from
// L2.  The arithmetic is ~50 float32 operations per slot pair (the minimum
// image, d^2, the test, the six components and their rounding), ~267 M
// pairs, ~0.45 ms of the CUDA cores; the pair functions (a square root, two
// divisions, two Clenshaw recurrences) are due at the few % of pairs within
// the cut.  So the design keeps the arithmetic under the writes and the
// writes whole:
//   * one block per (cell, offset); the neighbour cell comes from the grid,
//     so no rolled copy is made;
//   * the four slot arrays of the own cell are staged in shared memory, and
//     each thread holds its 8 neighbour slots in registers for all its rows;
//   * thread (r, v) of a block writes slots 8v .. 8v + 7 of rows r, r + RPB,
//     ...: one 16-byte vector (bfloat16) or two (float32) into each of the
//     six planes per row, with streaming stores; cap is a multiple of 8, so
//     a vector never splits a row, and the threads of a warp, in order,
//     write consecutive vectors: 512 contiguous bytes a store (bfloat16);
//   * the pair functions run for valid pairs only: a warp queues the d^2 of
//     its valid pairs in shared memory, each lane's in slot order after the
//     lanes before it (a prefix from four ballots), evaluates the queue with
//     every lane busy, two entries a lane at a time, and each lane reads its
//     results back in the same order (a branch per pair would run them
//     whenever any lane of the warp had a valid pair at that slot);
//   * no float atomics and no reductions: reruns are bitwise equal.
// Its H100 time against that bound is in PERF.md.
#include "common.cuh"

namespace {

constexpr int LPT = 8;           // slots j per thread and row
constexpr int QLEN = 32 * LPT;   // a warp's queue: every pair of one row pass
constexpr int MAX_OFFSETS = 27;  // the whole 3 x 3 x 3 stencil
constexpr int MAX_THREADS = 256;

struct Blocked {
  const float *px, *py, *pz;  // (C, cap) slot coordinates
  const float* mask;          // (C, cap) slot occupancy, 0 or 1
  const float* cheb;          // chebyshev.device_coeffs layout
  int n_coef;
  float mid, cut2, dr2;
  int ncx, ncy, ncz, cap;
  int rows;                   // RPB: rows a block covers per pass
  float Lx, Ly, Lz;           // box lengths
  float rLx, rLy, rLz;        // their float32 reciprocals
  float tLy;                  // tilt_xy * Ly, rounded to float32
  int ox[MAX_OFFSETS], oy[MAX_OFFSETS], oz[MAX_OFFSETS];
  void* out;                  // (noff, 6, C, cap, cap) block dtype
};

// The 8 values of one plane's row segment as 32-bit words, and their
// 16-byte stores.
template <typename AT>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  static constexpr int WORDS = 4;
  __device__ __forceinline__ static void put(unsigned* w, int l, float a,
                                             float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[l / 2] = *reinterpret_cast<const unsigned*>(&h);
  }
};

template <>
struct Row8<float> {
  static constexpr int WORDS = 8;
  __device__ __forceinline__ static void put(unsigned* w, int l, float a,
                                             float b) {
    w[l] = __float_as_uint(a);
    w[l + 1] = __float_as_uint(b);
  }
};

__device__ __forceinline__ int wrap_index(int a, int n) {
  return ((a % n) + n) % n;
}

template <typename AT, int NC>
__global__ void __launch_bounds__(MAX_THREADS, 2) pair_blocks(Blocked b) {
  constexpr int WORDS = Row8<AT>::WORDS;
  extern __shared__ float4 smem4[];
  const int cap = b.cap, nv = cap / LPT, RPB = b.rows;
  const int C = b.ncx * b.ncy * b.ncz;
  const int c = blockIdx.x, oi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nc = NC > 0 ? NC : b.n_coef;
  float4* own = smem4;                                      // cap
  float4* queue = own + cap + (tid >> 5) * QLEN;            // QLEN a warp
  float* cf = reinterpret_cast<float*>(own + cap + (blockDim.x >> 5) * QLEN);

  // the neighbour cell c + o, z fastest
  const int ox = b.ox[oi], oy = b.oy[oi], oz = b.oz[oi];
  const int cz = c % b.ncz, cy = (c / b.ncz) % b.ncy, cx = c / (b.ncz * b.ncy);
  const int cn = (wrap_index(cx + ox, b.ncx) * b.ncy +
                  wrap_index(cy + oy, b.ncy)) * b.ncz +
                 wrap_index(cz + oz, b.ncz);
  for (int s = tid; s < cap; s += blockDim.x) {
    const long long o = (long long)c * cap + s;
    own[s] = make_float4(b.px[o], b.py[o], b.pz[o], b.mask[o]);
  }
  for (int s = tid; s < 4 + 4 * nc; s += blockDim.x) cf[s] = b.cheb[s];

  // this thread's slots j0 .. j0 + 7 of the neighbour, and its first row
  const bool thread = tid < nv * RPB;
  const int r0 = thread ? tid / nv : 0, j0 = thread ? (tid % nv) * LPT : 0;
  float xj[LPT], yj[LPT], zj[LPT], mj[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const long long o = (long long)cn * cap + j0 + l;
    xj[l] = __ldg(b.px + o);
    yj[l] = __ldg(b.py + o);
    zj[l] = __ldg(b.pz + o);
    mj[l] = __ldg(b.mask + o);
  }
  __syncthreads();
  const bool self = ox == 0 && oy == 0 && oz == 0;
  const long long plane = (long long)C * cap * cap;
  AT* out = reinterpret_cast<AT*>(b.out) +
            ((long long)oi * 6 * C + c) * cap * cap + j0;
  const unsigned before = (1u << lane) - 1u;
  for (int i0 = 0; i0 < cap; i0 += RPB) {
    const int i = i0 + r0;
    const bool act = thread && i < cap;
    const float4 pi = own[act ? i : 0];
    // every pair's minimum image, d^2 and validity
    float dx[LPT], dy[LPT], dz[LPT], d2[LPT];
    unsigned bits = 0;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      float x = __fsub_rn(pi.x, xj[l]);
      float y = __fsub_rn(pi.y, yj[l]);
      float z = __fsub_rn(pi.z, zj[l]);
      z = __fsub_rn(z, __fmul_rn(rintf(__fmul_rn(z, b.rLz)), b.Lz));
      const float iy = rintf(__fmul_rn(y, b.rLy));
      y = __fsub_rn(y, __fmul_rn(iy, b.Ly));
      x = __fsub_rn(x, __fmul_rn(iy, b.tLy));
      x = __fsub_rn(x, __fmul_rn(rintf(__fmul_rn(x, b.rLx)), b.Lx));
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      dx[l] = x, dy[l] = y, dz[l] = z, d2[l] = r2;
      const bool valid = act && __fmul_rn(pi.w, mj[l]) > 0.f &&
                         r2 < b.cut2 && r2 >= b.dr2 && !(self && i == j0 + l);
      bits |= (unsigned)valid << l;
    }
    // the warp's queue: this lane's valid pairs at the prefix of the
    // counts (0..8) of the lanes before it
    const int cnt = __popc(bits);
    int pos = 0, tot = 0;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const unsigned v = __ballot_sync(0xffffffffu, (cnt >> kb) & 1);
      pos += __popc(v & before) << kb;
      tot += __popc(v) << kb;
    }
    {
      int q = pos;
#pragma unroll
      for (int l = 0; l < LPT; ++l)
        if ((bits >> l) & 1u) queue[q++].x = d2[l];
    }
    __syncwarp();
    // (UF1, UF2 - UF1, 1 / sqrt(d^2)) of the queue, every lane busy
    for (int e = lane; e < tot; e += 64) {
      const bool two = e + 32 < tot;
      const float da = queue[e].x, db = queue[two ? e + 32 : e].x;
      float a1, a2, u1, u2;
      const float ra = pair_functions<NC>(cf, nc, b.mid, da, a1, a2);
      const float rb = pair_functions<NC>(cf, nc, b.mid, db, u1, u2);
      queue[e] = make_float4(a1, __fsub_rn(a2, a1), __frcp_rn(ra), 0.f);
      if (two)
        queue[e + 32] = make_float4(u1, __fsub_rn(u2, u1), __frcp_rn(rb), 0.f);
    }
    __syncwarp();
    // the six components, in the block dtype, two slots at a time
    unsigned w[6][WORDS];
    int q = pos;
#pragma unroll
    for (int l = 0; l < LPT; l += 2) {
      float cm[2][6];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = l + h;
        float imrr = 0.f, bco = 0.f, inv = 1.f;
        if ((bits >> m) & 1u) {
          const float4 r = queue[q++];
          imrr = r.x, bco = r.y, inv = r.z;
        }
        const float ex = __fmul_rn(dx[m], inv), ey = __fmul_rn(dy[m], inv),
                    ez = __fmul_rn(dz[m], inv);
        const float bx = __fmul_rn(bco, ex), by = __fmul_rn(bco, ey),
                    bz = __fmul_rn(bco, ez);
        cm[h][0] = __fadd_rn(imrr, __fmul_rn(bx, ex));
        cm[h][1] = __fmul_rn(bx, ey);
        cm[h][2] = __fmul_rn(bx, ez);
        cm[h][3] = __fadd_rn(imrr, __fmul_rn(by, ey));
        cm[h][4] = __fmul_rn(by, ez);
        cm[h][5] = __fadd_rn(imrr, __fmul_rn(bz, ez));
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) Row8<AT>::put(w[k], l, cm[0][k], cm[1][k]);
    }
    if (act) {
      AT* row = out + (long long)i * cap;
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int v = 0; v < WORDS / 4; ++v)
          __stcs(reinterpret_cast<uint4*>(row + k * plane) + v,
                 make_uint4(w[k][4 * v], w[k][4 * v + 1], w[k][4 * v + 2],
                            w[k][4 * v + 3]));
    }
    __syncwarp();  // the next pass rewrites the queue
  }
}

// Rows per pass and threads: the RPB (nv RPB <= MAX_THREADS threads, in
// whole warps) with the fewest thread-rows idle, the larger on a tie.
void shape_of(int cap, int& rows, int& threads) {
  const int nv = cap / LPT;
  long long best = -1;
  for (int r = 1; r * nv <= MAX_THREADS; ++r) {
    const int t = (r * nv + 31) / 32 * 32;
    const long long cost = (long long)((cap + r - 1) / r) * t;
    if (best < 0 || cost <= best) best = cost, rows = r, threads = t;
  }
}

template <typename AT, int NC>
cudaError_t launch(const Blocked& b, int noff, int threads,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * ((size_t)b.cap + (threads / 32) * QLEN) +
                      sizeof(float) * (4 + 4 * (size_t)b.n_coef);
  auto kernel = pair_blocks<AT, NC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b.ncx * b.ncy * b.ncz, noff);
  kernel<<<grid, threads, smem, stream>>>(b);
  return cudaGetLastError();
}

}  // namespace

// offsets: 3 noff ints on the host, (ox, oy, oz) of each stored offset in
// the order of out's first axis.  cap a multiple of 8 up to 8 MAX_THREADS.
extern "C" int pse_blocked_build(const float* px, const float* py,
                                 const float* pz, const float* mask,
                                 const float* cheb, int n_coef, float mid,
                                 float cut2, float dr2, int ncx, int ncy,
                                 int ncz, int cap, float Lx, float Ly,
                                 float Lz, float rLx, float rLy, float rLz,
                                 float tLy, int noff, const int* offsets,
                                 int a_bf16, void* out, cudaStream_t stream) {
  if (cap < LPT || cap % LPT || cap > LPT * MAX_THREADS || noff < 1 ||
      noff > MAX_OFFSETS || ncx < 1 || ncy < 1 || ncz < 1 || n_coef < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Blocked b{};
  b.px = px, b.py = py, b.pz = pz, b.mask = mask;
  b.cheb = cheb, b.n_coef = n_coef, b.mid = mid, b.cut2 = cut2, b.dr2 = dr2;
  b.ncx = ncx, b.ncy = ncy, b.ncz = ncz, b.cap = cap;
  b.Lx = Lx, b.Ly = Ly, b.Lz = Lz, b.rLx = rLx, b.rLy = rLy, b.rLz = rLz;
  b.tLy = tLy, b.out = out;
  for (int k = 0; k < noff; ++k)
    b.ox[k] = offsets[3 * k], b.oy[k] = offsets[3 * k + 1],
    b.oz[k] = offsets[3 * k + 2];
  int threads = 32;
  shape_of(cap, b.rows, threads);
  // the main path's degree-8 fits unrolled, any other degree through the
  // general recurrence
  const cudaError_t e =
      a_bf16 ? (n_coef == 9 ? launch<__nv_bfloat16, 9>(b, noff, threads, stream)
                            : launch<__nv_bfloat16, 0>(b, noff, threads, stream))
             : (n_coef == 9 ? launch<float, 9>(b, noff, threads, stream)
                            : launch<float, 0>(b, noff, threads, stream));
  return (int)e;
}

// ---------------------------------------------------------------------------
// The matvec: u = M_real f in cell layout (3, C, cap) from the stored blocks.
//
// Replaces no TPU kernel: the JAX package applies the blocks in plain XLA
// (pse_tpu/ops/blocked_nearfield.py::matvec_cells, einsum GEMVs), and its
// plain PyTorch twin (blocked_nearfield.matvec_cells_reference) makes a
// float32 copy of the bf16 blocks for each group of offsets (4.1 GB at
// N = 100k) and runs torch.bmm on it forward and transposed, with ~50 small
// gathers and sums an application: ~12.5 ms against a bound of well under
// one.
//
// Semantics, per stored offset o (index oi) and cell c, with the six
// components mapped as blocked_nearfield._COMP:
//   u(c)     += A[o, ., c] f(c + o)                  (forward, every o)
//   u(c + o) += A[o, ., c]^T f(c)                    (transposed, oi >= first_t:
//                                                     (0,0,0) applies forward only)
//   u(c)     += self f(c) mask(c)                    (the self term)
// in float32 from the blocks as stored (bf16 or float32, converted in
// registers; no TF32 or lower-precision sums), as the plain version's
// float32 upcast.
//
// What bounds it on the H100: the bytes of the blocks it has to read.  The
// build leaves every slot pair with a padded slot zero (above), so only the
// rows i < n_c and the columns j < n_(c+o) of a block are live, n_c being one
// past the last occupied slot of cell c.  At N = 100k (cells (9, 13, 13), cap
// 112, 14 offsets, bf16) the live pairs are ~1.07 GB (0.32 ms at 3.35
// TB/s) of the 3.2 GB stored; the arithmetic, 18 float32 FMAs a slot pair,
// is far under it.  The design:
//   * cell_products, one block per (cell, offset): the live counts of c and
//     c + o from the masks (the neighbour cell from the grid, as the build
//     finds it), then each live row once, up to n_(c+o) rounded up to a
//     16-byte vector (8 bf16): a warp's lanes split a row's vectors, W lanes
//     a row (W <= 32; wider rows go in chunks of 32 vectors), and each lane
//     holds f(c + o) of its 8 columns and their transposed sums in registers
//     over all its rows: both products from one streaming read (__ldcs) of
//     each live 16 bytes, never a float32 copy in device memory;
//   * the forward row sums reduce over a row's W lanes by shuffles, the
//     transposed column sums over the block's rows in shared memory, each in
//     a fixed order, into a partial buffer part (nparts, 3, C, cap): part[oi]
//     the forward sums of offset oi for cell c, part[noff + oi - first_t] the
//     transposed sums for cell c + o (each cell of each part has one writer);
//   * cell_sums adds, per slot, the self term, the forward parts in offset
//     order, then the transposed parts in offset order (live slots; zero
//     beyond).  The partial buffer is ~30 MB at N = 100k, mostly in L2.
//   * no float atomics: reruns are bitwise equal.
// Its H100 time against that bound is in PERF.md.
namespace {

constexpr int MV_THREADS = 128;
constexpr int MV_WARPS = MV_THREADS / 32;

struct CellMv {
  const void* a;         // (noff, 6, C, cap, cap) block dtype
  const float* f;        // (3, C, cap)
  const float* mask;     // (C, cap)
  float* part;           // (noff + noff - first_t, 3, C, cap)
  int* live;             // (C,) one past each cell's last occupied slot
  int ncx, ncy, ncz, cap, noff, first_t;
  int ox[MAX_OFFSETS], oy[MAX_OFFSETS], oz[MAX_OFFSETS];
};

// Eight stored values of one plane's row, loaded as stored (16 or 32
// bytes), read back as float32.
template <typename AT>
struct Seg8;

template <>
struct Seg8<__nv_bfloat16> {
  unsigned w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  __device__ __forceinline__ float operator[](int l) const {
    const unsigned x = w[l >> 1];
    return __uint_as_float((l & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};

template <>
struct Seg8<float> {
  float v[8];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = 0.f;
  }
  __device__ __forceinline__ float operator[](int l) const { return v[l]; }
};

template <typename AT>
__global__ void __launch_bounds__(MV_THREADS, 4) cell_products(CellMv b) {
  extern __shared__ float4 mv_smem[];
  __shared__ int red[2][MV_WARPS];
  const int cap = b.cap, C = b.ncx * b.ncy * b.ncz;
  const int c = blockIdx.x, oi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* fown = mv_smem;                                  // cap: f(c)
  float4* fwd = fown + cap;                                // cap: row sums
  float* wsm = reinterpret_cast<float*>(fwd + cap);        // 24 MV_THREADS

  const int ox = b.ox[oi], oy = b.oy[oi], oz = b.oz[oi];
  const int cz = c % b.ncz, cy = (c / b.ncz) % b.ncy, cx = c / (b.ncz * b.ncy);
  const int cn = (wrap_index(cx + ox, b.ncx) * b.ncy +
                  wrap_index(cy + oy, b.ncy)) * b.ncz +
                 wrap_index(cz + oz, b.ncz);
  // the live slots of c (no) and of c + o (nn)
  int no = 0, nn = 0;
  for (int s = tid; s < cap; s += MV_THREADS) {
    if (b.mask[(long long)c * cap + s] != 0.f) no = s + 1;
    if (b.mask[(long long)cn * cap + s] != 0.f) nn = s + 1;
  }
  no = __reduce_max_sync(0xffffffffu, no);
  nn = __reduce_max_sync(0xffffffffu, nn);
  if (lane == 0) red[0][warp] = no, red[1][warp] = nn;
  __syncthreads();
  no = nn = 0;
#pragma unroll
  for (int w = 0; w < MV_WARPS; ++w)
    no = max(no, red[0][w]), nn = max(nn, red[1][w]);
  if (oi == 0 && tid == 0) b.live[c] = no;
  const long long plane = (long long)C * cap;              // of f, u, part
  for (int i = tid; i < no; i += MV_THREADS) {
    const long long o = (long long)c * cap + i;
    fown[i] = make_float4(b.f[o], b.f[o + plane], b.f[o + 2 * plane], 0.f);
    fwd[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const AT* A = reinterpret_cast<const AT*>(b.a) +
                ((long long)oi * 6 * C + c) * cap * cap;
  const long long aplane = (long long)C * cap * cap;
  const int nvl = (nn + 7) / 8;            // c + o's live 8-slot vectors
  for (int v0 = 0; v0 < nvl; v0 += 32) {
    const int W = min(32, nvl - v0);       // lanes a row
    const int per = 32 / W;                // rows a warp
    const int S = MV_WARPS * per;          // rows a pass
    const int seg = lane / W, v = lane - seg * W;
    const bool on = seg < per;
    const int r = warp * per + seg;        // this lane's row in a pass
    const int j = 8 * (v0 + v);            // its first column
    float fj[8][3], tw[8][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (on) {
        const float4* q = reinterpret_cast<const float4*>(
            b.f + k * plane + (long long)cn * cap + j);
        lo = q[0], hi = q[1];
      }
      fj[0][k] = lo.x, fj[1][k] = lo.y, fj[2][k] = lo.z, fj[3][k] = lo.w;
      fj[4][k] = hi.x, fj[5][k] = hi.y, fj[6][k] = hi.z, fj[7][k] = hi.w;
#pragma unroll
      for (int l = 0; l < 8; ++l) tw[l][k] = 0.f;
    }
    for (int i0 = 0; i0 < no; i0 += S) {
      const int i = i0 + r;
      const bool act = on && i < no;
      Seg8<AT> a[6];
      float4 fi = make_float4(0.f, 0.f, 0.f, 0.f);
      if (act) {
        const AT* row = A + (long long)i * cap + j;
#pragma unroll
        for (int k = 0; k < 6; ++k) a[k].load(row + k * aplane);
        fi = fown[i];
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) a[k].zero();
      }
      float ux = 0.f, uy = 0.f, uz = 0.f;
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const float xx = a[0][l], xy = a[1][l], xz = a[2][l], yy = a[3][l],
                    yz = a[4][l], zz = a[5][l];
        ux = fmaf(xz, fj[l][2], fmaf(xy, fj[l][1], fmaf(xx, fj[l][0], ux)));
        uy = fmaf(yz, fj[l][2], fmaf(yy, fj[l][1], fmaf(xy, fj[l][0], uy)));
        uz = fmaf(zz, fj[l][2], fmaf(yz, fj[l][1], fmaf(xz, fj[l][0], uz)));
        tw[l][0] = fmaf(xz, fi.z, fmaf(xy, fi.y, fmaf(xx, fi.x, tw[l][0])));
        tw[l][1] = fmaf(yz, fi.z, fmaf(yy, fi.y, fmaf(xy, fi.x, tw[l][1])));
        tw[l][2] = fmaf(zz, fi.z, fmaf(yz, fi.y, fmaf(xz, fi.x, tw[l][2])));
      }
      // the row's sum over its W lanes, a tree in lane order
      for (int off = 1; off < W; off <<= 1) {
        const float tx = __shfl_down_sync(0xffffffffu, ux, off);
        const float ty = __shfl_down_sync(0xffffffffu, uy, off);
        const float tz = __shfl_down_sync(0xffffffffu, uz, off);
        if (v + off < W) ux += tx, uy += ty, uz += tz;
      }
      if (act && v == 0) {
        const float4 q = fwd[i];
        fwd[i] = make_float4(q.x + ux, q.y + uy, q.z + uz, 0.f);
      }
    }
    if (oi >= b.first_t) {
      // the columns' transposed sums over the block's rows, in row order
      if (on) {
#pragma unroll
        for (int l = 0; l < 8; ++l)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            wsm[((r * W + v) * 8 + l) * 3 + k] = tw[l][k];
      }
      __syncthreads();
      float* out = b.part + (long long)(b.noff + oi - b.first_t) * 3 * plane +
                   (long long)cn * cap + 8 * v0;
      for (int e = tid; e < 24 * W; e += MV_THREADS) {
        const int k = e / (8 * W), jj = e - k * 8 * W;
        float t = 0.f;
        for (int q = 0; q < S; ++q) t += wsm[(q * 8 * W + jj) * 3 + k];
        out[k * plane + jj] = t;
      }
    }
    __syncthreads();  // the next chunk maps rows to other lanes
  }
  float* out = b.part + (long long)oi * 3 * plane + (long long)c * cap;
  for (int i = tid; i < no; i += MV_THREADS) {
    const float4 q = fwd[i];
    out[i] = q.x, out[plane + i] = q.y, out[2 * plane + i] = q.z;
  }
}

// u per slot: the self term, then the parts in order (live slots; 0 beyond).
__global__ void cell_sums(const float* f, const float* mask, const float* part,
                          const int* live, int nparts, long long plane,
                          int cap, float self, float* u) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  const bool on = (int)(e % cap) < live[e / cap];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float x = 0.f;
    if (on) {
      x = __fmul_rn(__fmul_rn(self, f[k * plane + e]), mask[e]);
      for (int p = 0; p < nparts; ++p)
        x = __fadd_rn(x, part[(p * 3 + k) * plane + e]);
    }
    u[k * plane + e] = x;
  }
}

template <typename AT>
cudaError_t launch_matvec(const CellMv& b, float self, float* u,
                          cudaStream_t stream) {
  const size_t smem =
      2 * sizeof(float4) * (size_t)b.cap + sizeof(float) * 24 * MV_THREADS;
  auto kernel = cell_products<AT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int C = b.ncx * b.ncy * b.ncz;
  kernel<<<dim3(C, b.noff), MV_THREADS, smem, stream>>>(b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long plane = (long long)C * b.cap;
  cell_sums<<<(unsigned)((plane + 255) / 256), 256, 0, stream>>>(
      b.f, b.mask, b.part, b.live, 2 * b.noff - b.first_t, plane, b.cap,
      self, u);
  return cudaGetLastError();
}

}  // namespace

// a: (noff, 6, C, cap, cap) blocks as build_pair_blocks leaves them (every
// slot pair with a padded slot zero); f: (3, C, cap) float32; mask: (C,
// cap); offsets: 3 noff ints on the host, as for pse_blocked_build; first_t:
// 1 if offsets[0] is (0,0,0), which applies forward only, else 0.  Scratch:
// part (2 noff - first_t, 3, C, cap) float32, live (C,) int32.  u: (3, C,
// cap) float32.
extern "C" int pse_blocked_matvec(const void* a, const float* f,
                                  const float* mask, float self, int ncx,
                                  int ncy, int ncz, int cap, int noff,
                                  const int* offsets, int first_t, int a_bf16,
                                  float* part, int* live, float* u,
                                  cudaStream_t stream) {
  if (cap < LPT || cap % LPT || cap > LPT * MAX_THREADS || noff < 1 ||
      noff > MAX_OFFSETS || ncx < 1 || ncy < 1 || ncz < 1 ||
      (first_t != 0 && first_t != 1) ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(f) % 16)
    return (int)cudaErrorInvalidValue;
  CellMv b{};
  b.a = a, b.f = f, b.mask = mask, b.part = part, b.live = live;
  b.ncx = ncx, b.ncy = ncy, b.ncz = ncz, b.cap = cap, b.noff = noff;
  b.first_t = first_t;
  for (int k = 0; k < noff; ++k)
    b.ox[k] = offsets[3 * k], b.oy[k] = offsets[3 * k + 1],
    b.oz[k] = offsets[3 * k + 2];
  const cudaError_t e =
      a_bf16 ? launch_matvec<__nv_bfloat16>(b, self, u, stream)
             : launch_matvec<float>(b, self, u, stream);
  return (int)e;
}

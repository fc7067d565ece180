// The binning's tail after the sort, in one launch: cid-sorted keys -> padded
// (C, cap) slots, the within-cell rank of every particle, the cells' starts
// and counts, and the overflow flag.
//
// Replaces the Pallas kernel pse_tpu/cellbins.py:123 `_fill_kernel`
// (launched by `_fill_cells_pallas`, cellbins.py:197) and the XLA work
// around it: `_cell_starts_counts` (searchsorted starts, cummax ranks and
// the overflow test, cellbins.py:222), the inverse-permutation sort of the
// ranks and the sort payloads that carried positions and values.  Slot s of
// cell c takes the particle of sorted row starts[c] + s when s < counts[c];
// pad slots get mask 0, pid n and zero positions / values (the CellBins
// contract).  rank_of[order[i]] = i - starts[cell] for every sorted row i,
// ranks >= cap included; overflow is set when a cell holds more than cap.
//
// What bounds it on the H100: bytes.  Per particle it reads its key, its
// order entry, 12 bytes of coordinates and 12 of values and writes its rank;
// per slot it writes 32 bytes: a few MB per binning at N = 100k, a few
// microseconds at 3.35 TB/s.  The launch and the dependent loads of the
// searches are of the same order, so the design keeps both short: one
// launch, and a cell's bounds in ~5 dependent loads.
//
// Design: grid C + 1 blocks.  Block c < C finds [start, end) of its cell
// with two 32-ary warp searches over sorted_cid (warp 0: lower bound of c,
// warp 1: of c + 1), then its threads fill the cap slots from row
// order[start + s] of the unsorted sources and write the ranks (one writer
// per element: order is a permutation), and thread 0 writes starts[c] and
// counts[c].  Block C writes the overflow flag: cell c overflows when
// sorted_cid[lb(c) + cap] == c; each thread searches four cells in
// lockstep and the block ORs the results.  No atomics, and no output needs
// zeroing first.  The TPU kernel's 128-lane reads and rolls and its f32 pid
// packing were TPU devices; here the ragged shift is plain indexing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 4;       // cells a thread of the overflow block searches

struct FillArgs {
  const int* cid;              // (n,) sorted cell ids
  const long long* order;      // (n,) the sort's permutation
  const float* x;              // unsorted coordinates, element stride `stride`
  const float* y;
  const float* z;
  const float* vals;           // (n, 3) unsorted values, or null
  int n, C, cap, stride;
  float* px;                   // (C, cap) each
  float* py;
  float* pz;
  float* mask;
  int* pid;
  float* vout;                 // (3, C, cap), or null
  int* rank_of;                // (n,)
  int* starts;                 // (C,)
  int* counts;                 // (C,)
  unsigned char* overflow;     // () bool
};

// First index of the sorted a[0, n) with a[i] >= key, by all 32 lanes of a
// warp on the same key: each step's 32 probes cut the range into 33 parts.
__device__ int warp_lower_bound(const int* __restrict__ a, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                    // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long len = hi - lo;
    const int p = lo + (int)((lane + 1) * len / 33);
    const unsigned ge = __ballot_sync(0xffffffffu, a[p] >= key);
    if (ge == 0) {
      lo += (int)(32 * len / 33) + 1;
    } else {
      const int f = __ffs(ge) - 1;
      const int lo_next = f == 0 ? lo : lo + (int)(f * len / 33) + 1;
      hi = lo + (int)((f + 1) * len / 33);
      lo = lo_next;
    }
  }
  return lo;
}

// Lower bounds of kKeys keys in the sorted a[0, n), n >= 1, in lockstep:
// the branchless search takes the same probe count for every key, so the
// keys' loads issue together.
__device__ void lower_bounds(const int* __restrict__ a, int n,
                             const int (&key)[kKeys], int (&out)[kKeys]) {
  int base[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) base[k] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
      base[k] = a[base[k] + half] < key[k] ? base[k] + half : base[k];
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < kKeys; ++k) out[k] = base[k] + (a[base[k]] < key[k]);
}

__device__ void write_overflow(const FillArgs& a) {
  bool over = false;
  if (a.n > 0) {
    for (int c0 = 0; c0 < a.C; c0 += kKeys * kThreads) {
      int key[kKeys], lb[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k)
        key[k] = min(c0 + k * kThreads + (int)threadIdx.x, a.C - 1);
      lower_bounds(a.cid, a.n, key, lb);
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const int e = lb[k] + a.cap;
        over |= e < a.n && a.cid[e] == key[k];
      }
    }
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) *a.overflow = over ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) fill_cells_kernel(const FillArgs a) {
  const int c = blockIdx.x;
  if (c == a.C) {
    write_overflow(a);
    return;
  }
  __shared__ int bounds[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int b = warp_lower_bound(a.cid, a.n, c + warp);
    if ((threadIdx.x & 31) == 0) bounds[warp] = b;
  }
  __syncthreads();
  const int start = bounds[0];
  const int count = bounds[1] - start;
  if (threadIdx.x == 0) {
    a.starts[c] = start;
    a.counts[c] = count;
  }
  const long long row = (long long)c * a.cap;
  const long long plane = (long long)a.C * a.cap;
  for (int s = threadIdx.x; s < a.cap; s += kThreads) {
    const long long o = row + s;
    if (s < count) {
      const int p = (int)a.order[start + s];
      const long long q = (long long)p * a.stride;
      a.px[o] = a.x[q];
      a.py[o] = a.y[q];
      a.pz[o] = a.z[q];
      a.mask[o] = 1.f;
      a.pid[o] = p;
      a.rank_of[p] = s;
      if (a.vals != nullptr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) a.vout[k * plane + o] = a.vals[3LL * p + k];
      }
    } else {
      a.px[o] = 0.f;
      a.py[o] = 0.f;
      a.pz[o] = 0.f;
      a.mask[o] = 0.f;
      a.pid[o] = a.n;
      if (a.vals != nullptr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) a.vout[k * plane + o] = 0.f;
      }
    }
  }
  // the ranks past the last slot of an overfull cell
  for (int s = a.cap + threadIdx.x; s < count; s += kThreads)
    a.rank_of[(int)a.order[start + s]] = s;
}

}  // namespace

extern "C" int pse_fill_cells(const int* sorted_cid, const long long* order,
                              const float* x, const float* y, const float* z,
                              int stride, const float* vals, int n, int C,
                              int cap, float* px, float* py, float* pz,
                              float* mask, int* pid, float* vout, int* rank_of,
                              int* starts, int* counts,
                              unsigned char* overflow, cudaStream_t stream) {
  const FillArgs a{sorted_cid, order, x,    y,    z,       vals,
                   n,          C,     cap,  stride, px,    py,
                   pz,         mask,  pid,  vout, rank_of, starts,
                   counts,     overflow};
  fill_cells_kernel<<<C + 1, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* pse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

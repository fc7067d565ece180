// Cell-slot fill: cid-sorted particle rows -> padded (C, cap) slot layout.
//
// Replaces the Pallas kernel pse_tpu/cellbins.py:123 `_fill_kernel`
// (launched by `_fill_cells_pallas`, cellbins.py:197).  Slot s of cell c
// takes sorted row starts[c] + s when s < counts[c]; pad slots get mask 0,
// pid n and zero positions / values (the CellBins contract).
//
// What bounds it on the H100: bytes.  Each output slot is written once and
// each valid particle row read once: about 24 bytes per slot plus 16-28 per
// particle, a few MB per binning at N=100k, so a few microseconds at
// 3.35 TB/s; launch overhead is of the same order.
//
// Design: one thread per (cell, slot), grid (ceil(cap/128), C); consecutive
// threads read consecutive sorted rows and write consecutive slots, so loads
// and stores coalesce.  The TPU kernel's 128-lane read + roll and its f32
// pid packing were TPU devices; here the ragged shift is plain indexing.
#include "common.cuh"

__global__ void fill_cells_kernel(const float* __restrict__ pos_t,
                                  const int* __restrict__ order,
                                  const float* __restrict__ vals_t,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ counts, int n, int C,
                                  int cap, float* __restrict__ px,
                                  float* __restrict__ py,
                                  float* __restrict__ pz,
                                  float* __restrict__ mask,
                                  int* __restrict__ pid,
                                  float* __restrict__ vout) {
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  const long long o = (long long)c * cap + s;
  const bool valid = s < counts[c];
  const long long src = valid ? (long long)starts[c] + s : 0;
  px[o] = valid ? pos_t[src] : 0.f;
  py[o] = valid ? pos_t[(long long)n + src] : 0.f;
  pz[o] = valid ? pos_t[2LL * n + src] : 0.f;
  mask[o] = valid ? 1.f : 0.f;
  pid[o] = valid ? order[src] : n;
  if (vout != nullptr) {
    const long long plane = (long long)C * cap;
    for (int k = 0; k < 3; ++k)
      vout[k * plane + o] = valid ? vals_t[(long long)k * n + src] : 0.f;
  }
}

extern "C" int pse_fill_cells(const float* pos_t, const int* order,
                              const float* vals_t, const int* starts,
                              const int* counts, int n, int C, int cap,
                              float* px, float* py, float* pz, float* mask,
                              int* pid, float* vout, cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((cap + threads - 1) / threads, C);
  fill_cells_kernel<<<grid, threads, 0, stream>>>(
      pos_t, order, vals_t, starts, counts, n, C, cap, px, py, pz, mask, pid,
      vout);
  return (int)cudaGetLastError();
}

extern "C" const char* pse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

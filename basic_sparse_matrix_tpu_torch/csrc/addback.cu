// K4 + K5: add sheared delta rows into their storage runs of the
// supernodal factor values, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute one function over two slot
// layouts:
//   * basic_sparse_matrix_tpu/ops/pallas/addback_resident.py::
//     addback_resident (kernel body _make_kernel, pallas_call at
//     addback_resident.py:106), slots (CQ,) with tcpf[c] < 0 dead;
//   * basic_sparse_matrix_tpu/ops/pallas/panel_addback.py::panel_addback
//     (kernel body _make_kernel, pallas_call at panel_addback.py:135),
//     slots (St, Wt) with (s, w) live iff w < twd[s].
// The Python wrappers flatten both into (starts, rows): for every slot c
// with starts[c] >= 0,
//   lvals[starts[c] + q] += rows[c, q]   for q in [0, len)
// Elements past the end of lvals are dropped.
//
// What differs from the TPU kernels: the TPU runs the slots one after
// another (a sequential loop inside one grid step, the factor resident in
// VMEM or moved by 1024-aligned DMA windows), so overlapping spans are
// summed in order. Here one thread block takes one slot and all slots run
// at once. Live spans may overlap (the zero tails of a row land in the
// neighbouring runs, and a caller may pass overlapping runs outright), so a
// plain read-modify-write would lose updates: every add is an atomicAdd.
// Elements that are exactly zero (the tails, and the padded slots of a
// quantised shape) are skipped, which changes no result and saves most of
// the atomics. The order of the adds into one element is not fixed, so
// the float32 sum may differ in its last bits from run to run.
//
// What bounds it on the H100: the atomics on the factor values (one per
// nonzero row element, resolved in L2, where the whole factor of the main
// path fits) and the read of rows (CQ * len * 4 bytes, streamed once).
// Offsets are 64-bit.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void addback_kernel(float* __restrict__ lvals, long long n,
                               const float* __restrict__ rows,
                               const int* __restrict__ starts, int len) {
  const long long c = blockIdx.x;
  const int st = __ldg(starts + c);
  if (st < 0) return;  // dead slot: uniform across the block
  const float* r = rows + c * len;
  float* dst = lvals + st;
  const long long avail = n - st;
#pragma unroll 4
  for (int q = threadIdx.x; q < len; q += THREADS) {
    const float v = __ldg(r + q);
    if (v != 0.f && q < avail) atomicAdd(dst + q, v);
  }
}

}  // namespace

extern "C" int bsm_addback(float* lvals, long long n, const float* rows,
                           const int* starts, int nslots, int len,
                           void* stream) {
  if (nslots <= 0 || len <= 0) return 0;
  addback_kernel<<<(unsigned)nslots, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(lvals, n, rows,
                                                        starts, len);
  return static_cast<int>(cudaGetLastError());
}

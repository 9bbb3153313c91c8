// K3: contiguous-run reads of the supernodal factor values, for Hopper
// (sm_90a).
//
// Replaces basic_sparse_matrix_tpu/ops/pallas/runs_read.py::runs_read
// (kernel body _make_kernel, pallas_call at runs_read.py:98; wrapper
// win_kernel).
//
// What it computes: for every system b of a batch of Bt factor value
// arrays (one sparsity pattern, Bt sets of values) and every run slot c of
// stf (CRQ slots, shared by the batch),
//   out[b, c, q] = lvals[b, stf[c] + q]   for q in [0, l_pad)
// where stf[c] >= 0. A dead slot (stf[c] < 0) and every element past the
// end of its own system's lvals (n elements each) read as 0: a run near the
// end of system b never reads the head of system b + 1. (The TPU kernel
// leaves dead rows unwritten; the callers mask them either way. It has no
// batch axis: JAX's vmap maps it over the systems.)
//
// What differs from the TPU kernel: the TPU keeps the whole factor value
// array resident in VMEM and rotates each run into place from 128-lane
// aligned windows, with the run starts in SMEM. On Hopper there is no such
// alignment rule: one warp copies one run, consecutive lanes on consecutive
// elements, so every warp-wide load is one contiguous (unaligned) 128-byte
// span and every store a contiguous one. The factor at the main path's size
// (n = 35,937: 9.6M values, 38 MB) fits the H100's 50 MB L2, which plays the
// part of the TPU kernel's VMEM residency: the runs of one level overlap
// and are read from L2.
//
// What bounds it on the H100: bytes moved, Bt * CRQ * l_pad * 4 written and
// about as many read (mostly from L2). Eight runs per 256-thread block keep
// enough loads in flight; there is no arithmetic. The batch is the grid's y
// axis, so one launch reads a level's runs for every system. Offsets are
// 64-bit.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // runs per thread block, one warp each

__global__ void runs_read_kernel(const float* __restrict__ lvals, long long n,
                                 const int* __restrict__ stf, int crq,
                                 int l_pad, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * WARPS + warp;
  if (c >= crq) return;
  const long long b = blockIdx.y;  // the system
  const int st = __ldg(stf + c);
  float* o = out + (b * crq + c) * l_pad;
  // Elements of this run that lie inside this system's lvals (0 for a dead
  // slot).
  const long long avail = st < 0 ? 0 : n - st;
  const float* src = lvals + b * n + (st < 0 ? 0 : st);
#pragma unroll 4
  for (int q = lane; q < l_pad; q += 32) {
    float v = 0.f;
    if (q < avail) v = __ldg(src + q);
    o[q] = v;
  }
}

}  // namespace

// lvals (bt, n), stf (crq,), out (bt, crq, l_pad), all contiguous; bt <=
// 65535 (the grid's y axis).
extern "C" int bsm_runs_read(const float* lvals, long long n, const int* stf,
                             int crq, int l_pad, int bt, float* out,
                             void* stream) {
  if (crq <= 0 || l_pad <= 0 || bt <= 0) return 0;
  if (bt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((crq + WARPS - 1) / WARPS), (unsigned)bt);
  runs_read_kernel<<<grid, WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(lvals, n, stf, crq,
                                                          l_pad, out);
  return static_cast<int>(cudaGetLastError());
}

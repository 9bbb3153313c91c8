// K6: per-entry fused multiply-add into an output tile, for Hopper (sm_90a).
//
// Replaces benchmarks/entry_fma_probe.py::build (kernel body `kernel`,
// pallas_call at entry_fma_probe.py:67), the cost probe of the streaming
// SpMM's inner step.
//
// What it computes: C = 0, then for every entry e in [0, E)
//   C[ii[e], :] += vv[e] * B[kk[e], :]
// with B and C of shape (R, lanes), float32. Entries that name the same
// output row are summed.
//
// What differs from the TPU kernel: the TPU holds the whole C tile and B in
// its vector memory and walks the entries one after another on one core, so
// the adds into one row happen in entry order. A Hopper thread block has at
// most 227 KB of shared memory and cannot hold a (4096, 128) float32 tile
// (2 MiB), and one block would leave 131 SMs idle. Here C stays in global
// memory, where at these sizes it lives in the 50 MB L2 (the part the TPU's
// vector memory plays), and the entries run in parallel: one thread takes
// four adjacent lanes of one entry, so a warp covers 128 lanes of an entry
// with one 16-byte load of B per thread. Output rows repeat (E entries over
// R rows), so a plain read-modify-write would lose updates: every add is an
// atomicAdd, resolved in L2. With 16-byte aligned rows the add is Hopper's
// vector atomicAdd(float4*), one instruction for four lanes. The order of
// the adds into one element is not fixed, so the float32 sum may differ in
// its last bits from the serial loop and from run to run.
//
// What bounds it on the H100: at the probe's sizes the launch itself (the
// tile is a few MiB and E a few thousand, microseconds of work); at large E
// the L2 atomics, one per entry and 16 bytes of lanes. The launcher clears C
// with cudaMemsetAsync on the same stream before the kernel.
//
// Why C is not held in a thread-block cluster's shared memory, where the
// tile would fit (the lanes cut into slices, a cluster of 16 blocks a slice,
// adds through distributed shared memory, C written once): measured, that
// design loses at every shape (device time against this kernel: default
// shape 25.6 against 9.1 us, 512 lanes 74.2 against 15.0 us, every entry in
// one row 3181 against 45.3 us). One scalar add per entry and lane crosses
// the SM-to-SM network where this kernel issues a quarter as many float4
// atomics in L2.
//
// The wrapper checks the indices on the host side of the call
// (0 <= ii, kk < R), so the kernels do no bounds checks. Offsets are
// 64-bit. Plain C interface for ctypes; the launch goes on the caller's
// stream and the function returns the first CUDA error of its calls.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// One thread per (entry, group of 4 lanes); lanes % 4 == 0 and B, C
// 16-byte aligned.
__global__ void entry_fma_vec4(const int* __restrict__ ii,
                               const int* __restrict__ kk,
                               const float* __restrict__ vv,
                               const float* __restrict__ B,
                               float* __restrict__ C, long long work,
                               int groups, int lanes) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= work) return;
  const long long e = t / groups;
  const int g = (int)(t - e * groups);
  const long long i = __ldg(ii + e);
  const long long k = __ldg(kk + e);
  const float v = __ldg(vv + e);
  const float4 b = __ldg(reinterpret_cast<const float4*>(B + k * lanes) + g);
  atomicAdd(reinterpret_cast<float4*>(C + i * lanes) + g,
            make_float4(v * b.x, v * b.y, v * b.z, v * b.w));
}

// One thread per (entry, lane): any width, any alignment.
__global__ void entry_fma_scalar(const int* __restrict__ ii,
                                 const int* __restrict__ kk,
                                 const float* __restrict__ vv,
                                 const float* __restrict__ B,
                                 float* __restrict__ C, long long work,
                                 int lanes) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= work) return;
  const long long e = t / lanes;
  const int l = (int)(t - e * lanes);
  const long long i = __ldg(ii + e);
  const long long k = __ldg(kk + e);
  atomicAdd(C + i * lanes + l, __ldg(vv + e) * __ldg(B + k * lanes + l));
}

}  // namespace

// vec is 4 when lanes % 4 == 0 and B, C are 16-byte aligned, else 1.
extern "C" int bsm_entry_fma(const int* ii, const int* kk, const float* vv,
                             const float* B, float* C, long long entries,
                             int rows, int lanes, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || lanes <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(
      C, 0, (size_t)rows * (size_t)lanes * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (entries <= 0) return 0;
  const long long per_entry = vec == 4 ? lanes / 4 : lanes;
  if ((entries * per_entry + THREADS - 1) / THREADS > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec == 4) {
    const int groups = lanes / 4;
    const long long work = entries * groups;
    entry_fma_vec4<<<(unsigned)((work + THREADS - 1) / THREADS), THREADS, 0,
                     s>>>(ii, kk, vv, B, C, work, groups, lanes);
  } else {
    const long long work = entries * lanes;
    entry_fma_scalar<<<(unsigned)((work + THREADS - 1) / THREADS), THREADS,
                       0, s>>>(ii, kk, vv, B, C, work, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// A second kernel ("cluster") was built for the tiles that fit a
// thread-block cluster's shared memory, the probe's own sizes among them.
// There the global-atomic kernel above is two device operations (the memset
// and the kernel), each near the floor of a launch, and every add is a
// read-modify-write in L2. entry_fma_cluster is ONE launch with no global
// atomics: the lanes are cut into slices, one cluster of CS blocks (16, the
// non-portable size, or 8) per slice; block `rank` of a cluster holds rows
// [rank * rpb, (rank + 1) * rpb) of its lane slice in its own shared memory
// (R 4096 x 16 lanes over 16 blocks: 16 KB a block), so the cluster's
// distributed shared memory holds the whole slice of the tile, as the TPU's
// vector memory holds the tile. Every block zeroes its share, the cluster
// synchronises, each block takes E / CS of the entries and adds
// v * B[k, lane] into the OWNING block's shared memory through
// cluster.map_shared_rank (a scalar atomicAdd: rows repeat, and the float4
// form exists for global memory only), the cluster synchronises again, and
// every block writes its rows of C once, coalesced. Every cluster reads all
// entries, so the number of clusters is kept near what the card runs side
// by side. The order of the adds is still not fixed.
//   What bounds it on the H100: the adds into other blocks' shared memory.
// One scalar add per entry and lane (1M at the probe's default shape
// against 262,144 float4 atomics in L2) crosses the SM-to-SM network, and
// adds into one address queue at about 0.4 us each. Measured device time,
// cluster against atomic (probes/entry_fma_probe.py): default shape 25.6
// against 9.1 us, 512 lanes 74.2 against 15.0 us, every entry in one row
// 3181 against 45.3 us. The wrapper therefore launches it only on request;
// the atomic kernel keeps every tile.
//
// The wrapper checks the indices on the host side of the call
// (0 <= ii, kk < R), so the kernels do no bounds checks. Offsets are
// 64-bit. Plain C interface for ctypes; every launch goes on the caller's
// stream and the functions return the first CUDA error of their calls.

#include <cooperative_groups.h>
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

constexpr int CT = 512;  // threads of a cluster kernel block

// grid n_clusters * CS blocks in clusters of CS; cluster c owns lanes
// [c * ls, min((c + 1) * ls, lanes)); dynamic shared memory rpb * ls floats.
__global__ void __launch_bounds__(CT)
entry_fma_cluster(const int* __restrict__ ii, const int* __restrict__ kk,
                  const float* __restrict__ vv, const float* __restrict__ B,
                  float* __restrict__ C, long long entries, int rows,
                  int lanes, int rpb, int ls) {
  namespace cg = cooperative_groups;
  extern __shared__ float share[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane0 = (int)(blockIdx.x / cs) * ls;
  const int nl = min(ls, lanes - lane0);

  for (int t = threadIdx.x; t < rpb * ls; t += CT) share[t] = 0.f;
  cluster.sync();

  const long long per_block = (entries + cs - 1) / cs;
  const long long e0 = rank * per_block;
  const long long mine = min(per_block, entries - e0);  // may be <= 0
  for (long long t = threadIdx.x; t < mine * nl; t += CT) {
    const long long e = e0 + t / nl;
    const int l = (int)(t % nl);
    const int i = __ldg(ii + e);
    const long long k = __ldg(kk + e);
    const int owner = i / rpb;
    float* dst = cluster.map_shared_rank(share, owner);
    atomicAdd(dst + (i - owner * rpb) * ls + l,
              __ldg(vv + e) * __ldg(B + k * lanes + lane0 + l));
  }
  cluster.sync();

  const int r0 = rank * rpb;
  const int nr = min(rpb, rows - r0);  // may be <= 0
  for (int t = threadIdx.x; t < nr * nl; t += CT) {
    const int r = t / nl;
    const int l = t - r * nl;
    C[(long long)(r0 + r) * lanes + lane0 + l] = share[r * ls + l];
  }
}

cudaError_t cluster_attributes(int cs, size_t smem) {
  static size_t smem_set = 48 * 1024;
  static bool non_portable = false;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        entry_fma_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (cs > 8 && !non_portable) {
    cudaError_t err = cudaFuncSetAttribute(
        entry_fma_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  return cudaSuccess;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int n_clusters, int cs, size_t smem, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(n_clusters * cs));
  cfg->blockDim = dim3(CT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// How many clusters of cs blocks with smem bytes of dynamic shared memory
// each the card can hold at once (0: such a cluster cannot be resident), or
// minus the CUDA error.
extern "C" int bsm_entry_fma_cluster_fit(int cs, int smem) {
  cudaError_t err = cluster_attributes(cs, (size_t)smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, 1, cs, (size_t)smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, entry_fma_cluster, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

// The cluster kernel: n_clusters lane slices of ls lanes, clusters of cs
// blocks holding rpb rows each (cs * rpb >= rows, n_clusters * ls >= lanes,
// rpb * ls * 4 bytes of shared memory a block).
extern "C" int bsm_entry_fma_cluster(const int* ii, const int* kk,
                                     const float* vv, const float* B,
                                     float* C, long long entries, int rows,
                                     int lanes, int cs, int rpb, int ls,
                                     int n_clusters, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  if (cs <= 0 || rpb <= 0 || ls <= 0 || (long long)cs * rpb < rows ||
      (long long)n_clusters * ls < lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)rpb * ls * sizeof(float);
  cudaError_t err = cluster_attributes(cs, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, n_clusters, cs, smem,
                 static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, entry_fma_cluster, ii, kk, vv, B, C, entries,
                           rows, lanes, rpb, ls);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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

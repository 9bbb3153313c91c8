// K2: cell-binned streaming SpMM for Hopper (sm_90a).
//
// Replaces basic_sparse_matrix_tpu/ops/pallas/stream_kernel.py::_spmm_stream3
// (kernel body _make_stream_kernel3, pallas_call at stream_kernel.py:178)
// and its two other layouts, _spmm_stream ("row") and _spmm_stream3p
// ("vregp"): all three compute the same function, and this one kernel
// serves them.
//
// What it computes: the host plan bins the stored entries by (row tile rt,
// k tile kt) cell; each cell holds cellmax slots (i, k, v), padded with
// (0, 0, 0). For every cell and slot,
//   C[rt*tile_m + i, :] += v * B[kt*tile_k + k, :]
// A padding slot adds 0 * B[kt*tile_k] to row rt*tile_m, as on the TPU.
//
// What differs from the TPU kernel: the TPU keeps a tile_m x n output tile
// resident in its vector memory across a sequential kt sweep. A Hopper
// thread block has at most 227 KB of shared memory, so tile_m is small
// (pick_tile_m: tile_m x column-slice x 4 B <= 48 KB) and one thread block
// owns one (row tile, column slice) and walks its n_kt cells in order.
// Entries of one cell can hit the same output row, so the work is split
// over COLUMNS, never over entries: each thread owns VEC adjacent columns
// of the slice and applies every entry of the cell to them. A thread only
// ever touches its own columns of the shared tile, so there are no races,
// no atomics and no __syncthreads. Runs of entries on one row are summed
// in registers and folded into the shared tile when the row changes.
//
// What bounds it on the H100: every entry reads one B row slice (VEC * 4 B
// per thread, a contiguous 16 B-per-thread row segment) from L2/HBM at a
// data-dependent address, so the kernel is bound by that gather: about
// nnz * n * 4 bytes of B reads. Unrolling by U = 8 keeps eight independent
// B loads in flight per thread. The plan is validated on the host when it
// is built (0 <= i < tile_m, 0 <= k < tile_k, rows and columns in range),
// so the kernel does no bounds checks on i and k. Offsets are 64-bit.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int U = 8;  // slots per unrolled step; cellmax is a multiple of 16

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void fma(T& acc, float v, const T& b) { acc = fmaf(v, b, acc); }
  __device__ static void add(float* p, const T& x) { *p += x; }
  __device__ static void store(float* p, const T& x) { *p = x; }
  __device__ static T get(const float* p) { return *p; }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void fma(T& acc, float v, const T& b) {
    acc.x = fmaf(v, b.x, acc.x);
    acc.y = fmaf(v, b.y, acc.y);
    acc.z = fmaf(v, b.z, acc.z);
    acc.w = fmaf(v, b.w, acc.w);
  }
  __device__ static void add(float* p, const T& x) {
    float4 s = *reinterpret_cast<float4*>(p);
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    *reinterpret_cast<float4*>(p) = s;
  }
  __device__ static void store(float* p, const T& x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  __device__ static T get(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

// grid (n_rt, ceil(N / cw)), block cw / VEC threads, dynamic shared memory
// tile_m * cw floats: the row tile's output for this column slice.
template <int VEC>
__global__ void stream_spmm_kernel(const int* __restrict__ ii,
                                   const int* __restrict__ kk,
                                   const float* __restrict__ vv,
                                   const float* __restrict__ B,
                                   float* __restrict__ C,
                                   int rows, int N, int n_kt, int cellmax,
                                   int tile_m, int tile_k, long long ldb,
                                   long long ldc, int cw) {
  using V = Vec<VEC>;
  extern __shared__ float tile[];
  const int rt = blockIdx.x;
  const int lc = threadIdx.x * VEC;                 // column inside the slice
  const int col = blockIdx.y * cw + lc;             // global column
  if (col >= N) return;  // N % VEC == 0, so a thread's columns are all in or all out

  for (int r = 0; r < tile_m; ++r) V::store(tile + (long long)r * cw + lc, V::zero());

  for (int kt = 0; kt < n_kt; ++kt) {
    const long long cell = ((long long)rt * n_kt + kt) * cellmax;
    const int* ci = ii + cell;
    const int* ck = kk + cell;
    const float* cv = vv + cell;
    const float* Bk = B + (long long)kt * tile_k * ldb + col;
    int cur = __ldg(ci);
    typename V::T acc = V::zero();
    for (int e = 0; e < cellmax; e += U) {
      int i[U], k[U];
      float v[U];
      typename V::T b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        i[u] = __ldg(ci + e + u);
        k[u] = __ldg(ck + e + u);
        v[u] = __ldg(cv + e + u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) b[u] = V::load(Bk + (long long)k[u] * ldb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i[u] != cur) {  // uniform across the block: every thread sees the same slot
          V::add(tile + (long long)cur * cw + lc, acc);
          acc = V::zero();
          cur = i[u];
        }
        V::fma(acc, v[u], b[u]);
      }
    }
    V::add(tile + (long long)cur * cw + lc, acc);
  }

  const long long r0 = (long long)rt * tile_m;
  for (int r = 0; r < tile_m && r0 + r < rows; ++r)
    V::store(C + (r0 + r) * ldc + col, V::get(tile + (long long)r * cw + lc));
}

template <int VEC>
int launch(const int* ii, const int* kk, const float* vv, const float* B,
           float* C, int n_rt, int n_kt, int cellmax, int tile_m, int tile_k,
           int rows, int N, long long ldb, long long ldc, int cw,
           cudaStream_t stream) {
  const size_t smem = (size_t)tile_m * cw * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_spmm_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((unsigned)n_rt, (unsigned)((N + cw - 1) / cw));
  const dim3 block((unsigned)(cw / VEC));
  stream_spmm_kernel<VEC><<<grid, block, smem, stream>>>(
      ii, kk, vv, B, C, rows, N, n_kt, cellmax, tile_m, tile_k, ldb, ldc, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec is 4 when N % 4 == 0 and B, C are 16-byte aligned, else 1; cw (the
// column slice) is a multiple of vec.
extern "C" int bsm_spmm_stream(const int* ii, const int* kk, const float* vv,
                               const float* B, float* C, int n_rt, int n_kt,
                               int cellmax, int tile_m, int tile_k, int rows,
                               int N, long long ldb, long long ldc, int cw,
                               int vec, void* stream) {
  if (n_rt <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch<4>(ii, kk, vv, B, C, n_rt, n_kt, cellmax, tile_m, tile_k,
                     rows, N, ldb, ldc, cw, s);
  return launch<1>(ii, kk, vv, B, C, n_rt, n_kt, cellmax, tile_m, tile_k,
                   rows, N, ldb, ldc, cw, s);
}

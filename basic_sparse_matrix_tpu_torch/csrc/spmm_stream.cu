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
// That kernel ("tile" below) reads one whole row of B from device memory for
// every slot. Where B is far larger than the 50 MB L2 and every row of B is
// used many times (1M x 1M, 32 entries a row, 512 columns: 65.5 GB of B
// reads for a 2 GB B), it runs at 82% of the HBM rate for traffic that is 32
// times what the function needs. The second kernel here ("sliced") cuts the
// COLUMNS of B instead: a slice of SW = 32 columns over all K rows is K*128
// bytes (a row's piece is one whole 128-byte L2 line, so B is read as it
// lies), and while every row tile is swept for one slice, a slice that fits
// L2 is read from HBM once.
//
//   * stream_sliced_kernel is a persistent grid whose OUTER loop is the
//     slice and whose inner loop strides over units of ST/G consecutive
//     rows, so the whole card works on one slice at a time whatever order
//     the hardware starts blocks in. G = 8 threads own one row and one
//     float4 of the slice each; a thread walks its row's slots (the plan
//     keeps a cell's slots sorted by row; the per-cell row pointers come
//     from the host plan) with SU independent B loads in flight, keeps the
//     sum in registers and writes its float4 of C once. No shared output
//     tile, no atomics; the sum of a row is taken in slot order, so the
//     result is the same from call to call (and, for finite B, the same as
//     the tile kernel's). A unit's kk/vv are staged through shared memory in
//     windows of SWIN slots with coalesced streaming loads (a thread's own
//     walk of consecutive slots is not coalesced); the window is skewed by
//     one element in 32 so that rows 32 slots apart fall in different
//     banks. Padding slots (they follow a cell's live slots) are never
//     visited.
//
//   What bounds it on the H100 (probes/stream_slice_probe.py): the slot
//   arrays are read again for every slice (8 B a slot), and every slot is one
//   gather of 128 bytes. A slice that fits L2 (K = 200k: 25.6 MB) is
//   gathered from L2 (2.46 ms against the tile kernel's 4.45), a slice that
//   does not (K = 1M: 128 MB) streams from HBM at 3.1 TB/s (21.4 ms against
//   23.7). Why no narrower slice: 4, 8 or 16 columns of a B repacked
//   slice-major do fit L2 at K = 1M, but a gather of 32-byte sectors from L2
//   reaches only 3.2 TB/s from a 32 MB array (4.4 from 16 MB), no more than
//   HBM gives the tile kernel's 2 KB reads, and the slot re-reads and C's
//   32-byte writes evict part of the slice: measured 67, 32 and 122 ms at
//   8, 16 and 4 columns.
//
// l2_gather_probe_kernel measures what the sliced kernel's gather can reach:
// pairs of threads read 32-byte pieces at hashed addresses of an array.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the functions return cudaGetLastError() of the launch.

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

// ---- the sliced kernel ------------------------------------------------------

constexpr int ST = 256;     // threads of a block
constexpr int SW = 32;      // columns of a slice: one 128-byte line a row of B
constexpr int G = SW / 4;   // threads of a row, one float4 of the slice each
constexpr int SWIN = 4096;  // slots staged per window (33 KB with the skew)
constexpr int SU = 4;       // independent B loads in flight per thread

__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& b) {
  acc.x = fmaf(v, b.x, acc.x);
  acc.y = fmaf(v, b.y, acc.y);
  acc.z = fmaf(v, b.z, acc.z);
  acc.w = fmaf(v, b.w, acc.w);
}

// Persistent grid. Slice s reads B + s*SW + k*ldb and writes C + s*SW +
// r*ldc (both row-major). Plans with one k tile: cell rt is row tile rt, and
// rp is the per-cell row pointer array, (n_rt, tile_m + 1) int32 offsets
// into the cell's cellmax slots.
__global__ void __launch_bounds__(ST)
stream_sliced_kernel(const int* __restrict__ rp, const int* __restrict__ kk,
                     const float* __restrict__ vv,
                     const float* __restrict__ B, float* __restrict__ C,
                     int rows, int N, int tile_m, int cellmax, int n_slices,
                     long long ldb, long long ldc) {
  constexpr int RB = ST / G;  // rows of a unit
  __shared__ int2 win[SWIN + SWIN / 32];
  __shared__ long long span[2];
  const int lr = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int n_units = (rows + RB - 1) / RB;

  for (int s = 0; s < n_slices; ++s) {
    // N % 4 == 0: a thread's four columns are all in or all out
    const bool live_col = s * SW + g * 4 < N;
    const float* Bs = B + s * SW + g * 4;
    float* Cs = C + s * SW + g * 4;
    for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
      const int r = unit * RB + lr;
      const int r_last = min(unit * RB + RB, rows) - 1;
      long long beg = 0, end = 0;
      if (r < rows) {
        const int rt = r / tile_m;
        const int* p = rp + (long long)rt * (tile_m + 1) + (r - rt * tile_m);
        beg = (long long)rt * cellmax + __ldg(p);
        end = (long long)rt * cellmax + __ldg(p + 1);
      }
      // the slots from the unit's first row to its last, with the padding
      // that lies between two of its cells
      if (threadIdx.x == 0) span[0] = beg;
      if (r == r_last && g == 0) span[1] = end;
      __syncthreads();
      const long long f0 = span[0], f1 = span[1];
      __syncthreads();

      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long w0 = f0; w0 < f1; w0 += SWIN) {
        const int cnt = (int)min((long long)SWIN, f1 - w0);
        for (int j = threadIdx.x; j < cnt; j += ST)
          win[skew(j)] = make_int2(__ldcs(kk + w0 + j),
                                   __float_as_int(__ldcs(vv + w0 + j)));
        __syncthreads();
        const long long lo = max(beg, w0), hi = min(end, w0 + cnt);
        if (live_col && lo < hi) {
          int e = (int)(lo - w0);
          const int e1 = (int)(hi - w0);
          for (; e + SU <= e1; e += SU) {
            int2 kv[SU];
            float4 b[SU];
#pragma unroll
            for (int u = 0; u < SU; ++u) kv[u] = win[skew(e + u)];
#pragma unroll
            for (int u = 0; u < SU; ++u)
              b[u] = __ldg(reinterpret_cast<const float4*>(
                  Bs + (long long)kv[u].x * ldb));
#pragma unroll
            for (int u = 0; u < SU; ++u)
              fma4(acc, __int_as_float(kv[u].y), b[u]);
          }
          for (; e < e1; ++e) {
            const int2 kv = win[skew(e)];
            fma4(acc, __int_as_float(kv.y),
                 __ldg(reinterpret_cast<const float4*>(
                     Bs + (long long)kv.x * ldb)));
          }
        }
        __syncthreads();
      }
      if (live_col && r < rows)
        __stcs(reinterpret_cast<float4*>(Cs + (long long)r * ldc), acc);
    }
  }
}

// Blocks of the persistent grid: what fits the card at once.
int sliced_grid(int n_units, int* blocks) {
  static int resident = 0;  // the card does not change
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_sliced_kernel, ST, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm <= 0)
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    resident = sms * per_sm;
  }
  *blocks = n_units < resident ? n_units : resident;
  return 0;
}

// Pairs of threads read 32-byte pieces of A at hashed piece indices, iters
// pieces a pair; out keeps the loads alive.
__global__ void l2_gather_probe_kernel(const float* __restrict__ A,
                                       float* __restrict__ out,
                                       unsigned long long pieces, int iters) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned x = (t >> 1) * 2654435761u + 12345u;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int it = 0; it < iters; it += SU) {
    float4 b[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      x = x * 1664525u + 1013904223u;
      const unsigned long long piece = ((unsigned long long)x * pieces) >> 32;
      b[u] = __ldg(reinterpret_cast<const float4*>(A + piece * 8) + (t & 1));
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) fma4(acc, 1.f, b[u]);
  }
  out[t] = acc.x + acc.y + acc.z + acc.w;
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

// The sliced kernel on a plan with one k tile; N % 4 == 0, B and C
// row-major with row strides ldb and ldc.
extern "C" int bsm_spmm_stream_sliced(const int* rp, const int* kk,
                                      const float* vv, const float* B,
                                      float* C, int rows, int N, int tile_m,
                                      int cellmax, long long ldb,
                                      long long ldc, void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  if (N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_units = (rows + ST / G - 1) / (ST / G);
  int blocks = 0;
  const int status = sliced_grid(n_units, &blocks);
  if (status != 0) return status;
  stream_sliced_kernel<<<blocks, ST, 0, static_cast<cudaStream_t>(stream)>>>(
      rp, kk, vv, B, C, rows, N, tile_m, cellmax, (N + SW - 1) / SW, ldb,
      ldc);
  return static_cast<int>(cudaGetLastError());
}

// threads = blocks * 256; every pair of threads reads iters pieces of 32
// bytes out of the first pieces * 32 bytes of A; out holds blocks * 256
// floats. iters is a multiple of 4.
extern "C" int bsm_l2_gather_probe(const float* A, float* out,
                                   long long pieces, int iters, int blocks,
                                   void* stream) {
  if (pieces <= 0 || iters <= 0 || blocks <= 0 || iters % SU != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  l2_gather_probe_kernel<<<blocks, ST, 0, static_cast<cudaStream_t>(stream)>>>(
      A, out, (unsigned long long)pieces, iters);
  return static_cast<int>(cudaGetLastError());
}

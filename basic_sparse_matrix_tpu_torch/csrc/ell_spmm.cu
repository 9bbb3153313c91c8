// K8: the ELL (padded-row) sparse product, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's ELL path is plain jnp
// (ops/ell.py: _spmm_ell_direct, _spmm_ell_unrolled, _spmm_ell_barriered,
// _spmm_ell_chunked, four formulations that steer XLA's fusion). The port
// ran it as aten operations: for SpMM an index_select gather of every
// slot's row of B into a (rows, width, N) intermediate, a multiply and a
// sum, in 1 GiB row chunks; for SpMV an int64 copy of the column table at
// every call, a gather, a multiply and a sum.
//
// What it computes, from the ELL's int32 cols and float32 vals of shape
// (rows, width), row-major, and B of shape (K, N) with any strides:
//   C[r, j] = sum_k vals[r, k] * B[cols[r, k], j]
// with padding slots (col 0, val 0) read as 0 * B[0, j], as the plain
// version reads them (a non-finite B[0] gives NaN there too).
//
// What bounds it on the H100: bytes. The plain version wrote the gathered
// rows to device memory and read them back (width * N floats a row: 3.8 GB
// an N = 32 product at HPCG's 104^3 grid, 0.24 GB of A); an SpMV moved
// about 1.1 GB where A's slots are 0.24 GB. This kernel reads A once, each
// slot's row of B through the read-only path (from L1 or L2: the rows a
// block needs are neighbours in the stencil, and at 104^3 the three
// z-planes a row reaches hold about 4.2 MB of B at N = 32, inside the 50 MB
// L2), and writes C once. Nothing else touches device memory: no
// intermediate, no chunk loop, no index copy.
//
// The design: a team of T lanes (a power of two, at most a warp) makes one
// output row (SPMV_ROWS rows at once at N = 1); blocks take consecutive
// rows, so rows are walked in index order. The team's shape follows N,
// which the launcher sees:
//   * N = 1 (SpMV): the team's lanes cover a row's slots, lane l taking
//     slots l, l + T, ... (T the least power of two >= width, at most 32:
//     a row's cols and vals are one contiguous read, 108 bytes each at
//     width 27), for SPMV_ROWS consecutive rows at once; each lane sums
//     its slots of a row with one fma each, in k order, and the team adds
//     its lanes by a fixed butterfly of shuffles.
//   * N > 1: the team's lanes cover C's columns, 4 at a time with 16-byte
//     loads where B's rows and C's rows are 16-byte aligned and N % 4 == 0,
//     else one at a time (any N; the last lanes are masked). At N = 32, 8
//     lanes cover a row and a warp makes 4 rows. Each lane walks the whole
//     row's slots, in k order, as one fma chain a column in float32
//     registers; the slots' cols and vals are the same address across the
//     team (one broadcast load).
// No atomics: the result is the same from run to run. The sum order
// differs from torch.sum's (pairwise), so results differ from the plain
// version in the last bits.
//
// Indices are not checked on the device: the wrapper (ops/ell.py) passes
// ELL layouts whose cols lie in [0, K). Offsets are 64-bit. Plain C
// interface for ctypes; the launch goes on the caller's stream (so it can
// be captured in a CUDA graph) and the function returns the first CUDA
// error of its calls.

#include <cuda_runtime.h>

namespace {

// Slots whose loads are issued before their fmas (loads in flight).
constexpr int UNROLL = 8;
// Rows a team of the SpMV walks at once. At HPCG's 104^3 grid, 128 threads
// a block: 0.115 ms for the width-27 SpMV at 4 rows, 0.123 at 2, 0.161 at 8,
// 0.179 at 1 (NVIDIA H100 80GB HBM3, 700 W).
constexpr int SPMV_ROWS = 4;
constexpr unsigned FULL = 0xffffffffu;

// N = 1: a team of T lanes over the slots of SPMV_ROWS consecutive rows at
// once (the rows' loads issued together, so that more bytes are in flight
// than one row's 216), then a butterfly a row.
template <int T>
__global__ void ell_spmv(const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long rows, int width, long long sx,
                         long long sy) {
  constexpr int R = SPMV_ROWS;
  const int lane = threadIdx.x & (T - 1);
  const long long r0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T * R;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int k = lane; k < width; k += T) {
    int c[R];
    float v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool in = r0 + i < rows;
      c[i] = in ? __ldg(cols + (r0 + i) * width + k) : 0;
      v[i] = in ? __ldg(vals + (r0 + i) * width + k) : 0.0f;
    }
    float b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) b[i] = __ldg(x + (long long)c[i] * sx);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = fmaf(v[i], b[i], acc[i]);
  }
  // Every lane of the warp takes part (rows past the end add zeros).
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(FULL, acc[i], off, T);
  // Every lane holds every row's sum: lane i % T writes row i.
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i % T == lane && r0 + i < rows) y[(r0 + i) * sy] = acc[i];
}

// N > 1, 16-byte lanes: B's and C's rows 16-byte aligned, N % 4 == 0.
template <int T>
__global__ void ell_spmm_vec4(const int* __restrict__ cols,
                              const float* __restrict__ vals,
                              const float* __restrict__ B,
                              float* __restrict__ C, long long rows,
                              int width, int groups, long long ldb,
                              long long ldc) {
  const int lane = threadIdx.x & (T - 1);
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (r >= rows) return;
  const int* c = cols + r * width;
  const float* v = vals + r * width;
  for (int g = lane; g < groups; g += T) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k0 = 0; k0 < width; k0 += UNROLL) {
      float4 b[UNROLL];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k0 + u < width) {
          w[u] = __ldg(v + k0 + u);
          b[u] = __ldg(reinterpret_cast<const float4*>(
                           B + (long long)__ldg(c + k0 + u) * ldb) + g);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k0 + u < width) {
          acc.x = fmaf(w[u], b[u].x, acc.x);
          acc.y = fmaf(w[u], b[u].y, acc.y);
          acc.z = fmaf(w[u], b[u].z, acc.z);
          acc.w = fmaf(w[u], b[u].w, acc.w);
        }
      }
    }
    reinterpret_cast<float4*>(C + r * ldc)[g] = acc;
  }
}

// N > 1, one column a lane: any N, any strides.
template <int T>
__global__ void ell_spmm_scalar(const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ B,
                                float* __restrict__ C, long long rows,
                                int width, int n, long long sb0,
                                long long sb1, long long ldc) {
  const int lane = threadIdx.x & (T - 1);
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (r >= rows) return;
  const int* c = cols + r * width;
  const float* v = vals + r * width;
  for (int j = lane; j < n; j += T) {
    const float* bj = B + (long long)j * sb1;
    float acc = 0.0f;
    for (int k0 = 0; k0 < width; k0 += UNROLL) {
      float b[UNROLL];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k0 + u < width) {
          w[u] = __ldg(v + k0 + u);
          b[u] = __ldg(bj + (long long)__ldg(c + k0 + u) * sb0);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (k0 + u < width) acc = fmaf(w[u], b[u], acc);
    }
    C[r * ldc + j] = acc;
  }
}

int team_for(int units) {
  int t = 1;
  while (t < units && t < 32) t <<= 1;
  return t;
}

struct Args {
  const int* cols;
  const float* vals;
  const float* B;
  float* C;
  long long rows;
  int width, n;
  long long sb0, sb1, ldc;
};

template <int T>
void launch(const Args& a, bool vec4, int threads, cudaStream_t s) {
  const long long per_block = threads / T * (a.n == 1 ? SPMV_ROWS : 1);
  const unsigned blocks = (unsigned)((a.rows + per_block - 1) / per_block);
  if (a.n == 1)
    ell_spmv<T><<<blocks, threads, 0, s>>>(a.cols, a.vals, a.B, a.C,
                                           a.rows, a.width, a.sb0, a.ldc);
  else if (vec4)
    ell_spmm_vec4<T><<<blocks, threads, 0, s>>>(
        a.cols, a.vals, a.B, a.C, a.rows, a.width, a.n / 4, a.sb0, a.ldc);
  else
    ell_spmm_scalar<T><<<blocks, threads, 0, s>>>(
        a.cols, a.vals, a.B, a.C, a.rows, a.width, a.n, a.sb0, a.sb1,
        a.ldc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

}  // namespace

// The team size (lanes a row) and the lane width (4 or 1 columns) that
// bsm_ell_spmm takes for this call, written to out[0..1].
extern "C" int bsm_ell_spmm_shape(const float* B, const float* C, int width,
                                  int n, long long sb0, long long sb1,
                                  long long ldc, int* out) {
  const bool vec4 = n > 1 && n % 4 == 0 && sb1 == 1 && sb0 % 4 == 0 &&
                    ldc % 4 == 0 && aligned16(B) && aligned16(C);
  out[0] = team_for(n == 1 ? width : (vec4 ? n / 4 : n));
  out[1] = vec4 ? 4 : 1;
  return 0;
}

// C (rows, n) with row stride ldc (for n = 1 the element stride) =
// ELL(cols, vals) (rows, width) times B (K, n) with strides (sb0, sb1);
// threads a block a multiple of 32, at most 1024.
extern "C" int bsm_ell_spmm(const int* cols, const float* vals,
                            const float* B, float* C, long long rows,
                            int width, int n, long long sb0, long long sb1,
                            long long ldc, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int shape[2];
  bsm_ell_spmm_shape(B, C, width, n, sb0, sb1, ldc, shape);
  if ((rows * shape[0] + threads - 1) / threads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{cols, vals, B, C, rows, width, n, sb0, sb1, ldc};
  const bool vec4 = shape[1] == 4;
  switch (shape[0]) {
    case 1: launch<1>(a, vec4, threads, s); break;
    case 2: launch<2>(a, vec4, threads, s); break;
    case 4: launch<4>(a, vec4, threads, s); break;
    case 8: launch<8>(a, vec4, threads, s); break;
    case 16: launch<16>(a, vec4, threads, s); break;
    default: launch<32>(a, vec4, threads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

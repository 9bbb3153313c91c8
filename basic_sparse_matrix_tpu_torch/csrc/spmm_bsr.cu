// K1: block-sparse (BSR) x dense SpMM for Hopper (sm_90a).
//
// Replaces basic_sparse_matrix_tpu/ops/pallas/spmm_kernel.py::_spmm_bsr
// (kernel body _make_kernel, pallas_call at spmm_kernel.py:178).
//
// What it computes: for every stored dense (bm, bk) block t at block
// coordinates (block_rows[t], block_cols[t]),
//   C[br*bm : +bm, :] += blocks[t] @ B[bc*bk : +bk, :]
// in float32 with float32 FMA accumulation (the TPU kernel's
// Precision.HIGHEST: no TF32, no bf16).
//
// What differs from the TPU kernel: Pallas walks the blocks on a sequential
// grid and zeroes each output tile on its first visit. CUDA blocks run in
// no order, so here the host hands over brow_ptr (n_block_rows + 1), the
// block-row pointer of the row-sorted block list, and ONE thread block owns
// one (block row, row slice, N tile) output tile: it walks that block row's
// blocks in a loop, keeps the sum in registers and writes the tile exactly
// once. No atomics, no zero-init pass. An empty block row writes zeros.
//
// What bounds it on the H100: float32 FMA issue (no tensor-core float32
// path at full precision) once blocks are dense; a (256, 512) block is
// 512 KB of float32, more than a thread block's 227 KB of shared memory,
// so each block is staged through shared memory in TK = 32-deep k-chunks
// together with the matching (TK, TN) chunk of B. Ragged edges (rows,
// K and N that are not tile multiples) are masked in the kernel, so the
// wrapper pads nothing. All element offsets are 64-bit.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;

// One thread block: a (TM, TN) output tile; each thread a (RM, RN)
// register sub-tile whose rows are ty + i*TY and columns tx + j*TX, so
// neighbouring threads read neighbouring shared-memory words and store
// neighbouring global addresses.
template <int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
bsr_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ brow_ptr,
                const int* __restrict__ bcols,
                const float* __restrict__ B,
                float* __restrict__ C,
                int rows, int K, int N, int bm, int bk,
                long long ldb, long long ldc, int m_sub) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  constexpr int NT = TX * TY;
  __shared__ float As[TK][TM + 1];  // A chunk stored k-major; +1 avoids bank conflicts
  __shared__ float Bs[TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int br = blockIdx.x / m_sub;           // block row
  const int m0 = (blockIdx.x % m_sub) * TM;    // first row inside the block
  const int n0 = blockIdx.y * TN;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const long long blk_elems = (long long)bm * bk;
  const int t0 = brow_ptr[br];
  const int t1 = brow_ptr[br + 1];
  for (int t = t0; t < t1; ++t) {
    const float* A = blocks + (long long)t * blk_elems;
    const long long kbase = (long long)bcols[t] * bk;
    for (int k0 = 0; k0 < bk; k0 += TK) {
      for (int idx = tid; idx < TM * TK; idx += NT) {
        const int r = idx / TK, c = idx % TK;
        const int rr = m0 + r, kc = k0 + c;
        As[c][r] = (rr < bm && kc < bk) ? A[(long long)rr * bk + kc] : 0.f;
      }
      for (int idx = tid; idx < TK * TN; idx += NT) {
        const int r = idx / TN, c = idx % TN;
        const long long kg = kbase + k0 + r;
        const int ng = n0 + c;
        Bs[r][c] = (k0 + r < bk && kg < K && ng < N) ? B[kg * ldb + ng] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty + i * TY;
    const long long gr = (long long)br * bm + r;
    if (r >= bm || gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = n0 + tx + j * TX;
      if (c < N) C[gr * ldc + c] = acc[i][j];
    }
  }
}

template <int TM, int TN, int RM, int RN>
void launch(const float* blocks, const int* brow_ptr, const int* bcols,
            const float* B, float* C, int n_block_rows, int rows, int K,
            int N, int bm, int bk, long long ldb, long long ldc,
            cudaStream_t stream) {
  const int m_sub = (bm + TM - 1) / TM;
  const dim3 grid((unsigned)((long long)n_block_rows * m_sub),
                  (unsigned)((N + TN - 1) / TN));
  const dim3 block((TM / RM) * (TN / RN));
  bsr_spmm_kernel<TM, TN, RM, RN><<<grid, block, 0, stream>>>(
      blocks, brow_ptr, bcols, B, C, rows, K, N, bm, bk, ldb, ldc, m_sub);
}

}  // namespace

extern "C" int bsm_spmm_bsr(const float* blocks, const int* brow_ptr,
                            const int* block_cols, const float* B, float* C,
                            int n_block_rows, int rows, int K, int N, int bm,
                            int bk, long long ldb, long long ldc,
                            void* stream) {
  if (n_block_rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm >= 64) {
    // 64 x 64 output tile, 256 threads, 4 x 4 outputs each.
    launch<64, 64, 4, 4>(blocks, brow_ptr, block_cols, B, C, n_block_rows,
                         rows, K, N, bm, bk, ldb, ldc, s);
  } else {
    // Thin blocks (bm = 8 from pick_tiles): 8 x 128 tile, 256 threads.
    launch<8, 128, 1, 4>(blocks, brow_ptr, block_cols, B, C, n_block_rows,
                         rows, K, N, bm, bk, ldb, ldc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: block-sparse (BSR) x dense SpMM for Hopper (sm_90a), on tensor cores.
//
// Replaces basic_sparse_matrix_tpu/ops/pallas/spmm_kernel.py::_spmm_bsr
// (kernel body _make_kernel, pallas_call at spmm_kernel.py:178).
//
// What it computes: for every stored dense (bm, bk) block t at block
// coordinates (block_rows[t], block_cols[t]),
//   C[br*bm : +bm, :] += blocks[t] @ B[bc*bk : +bk, :]
// at float32 accuracy (passes = 3, the TPU kernel's Precision.HIGHEST), or
// in one pass on operands rounded to TF32 (passes = 1, Precision.DEFAULT).
//
// Design:
// * One thread block owns one (block row, row slice, N tile) output tile
//   and writes it exactly once: no atomics, no zero-init pass. It walks
//   only the LIVE blocks of its block row (live_ptr / live_idx, built on
//   the host); the zero block the TPU layout seeds into every block row
//   (the Pallas kernel zeroes a tile on its first visit, so every block
//   row had to be visited) is never read. A block row with no live block
//   writes zeros.
// * The (live block, k0) chunks of a tile form one flat stream, staged
//   through a STAGES-deep ring in dynamic shared memory with cp.async, so
//   copies overlap the math and the ring does not drain at block
//   boundaries. Rows that are 16-byte aligned (bk % 4 == 0 for A, N % 4 ==
//   0 for B) move in 16-byte copies, others in 4-byte ones; every copy
//   past an edge of the block or of B is zero-filled, never read.
// * The products run on the tensor cores: mma.sync m16n8k8, TF32 operands,
//   float32 accumulators. Hopper has no float32 tensor-core path, so
//   passes = 3 splits each operand into hi = rna_tf32(x) and
//   lo = rna_tf32(x - hi) and accumulates a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi (the dropped a_lo*b_lo is ~2^-22 of a product). The split is
//   done once per fragment, between shared memory and registers, with
//   integer instructions (the conversion pipe runs at a quarter of their
//   rate; measured 12-15% slower on the H100).
// * The tensor cores truncate where they add into an accumulator. Summed
//   into one accumulator over a depth of 2048, that left 1.5e-5 of
//   max|ref| against a float64 product; so the MMAs sum one chunk (TK deep)
//   at a time into fresh registers, which join the tile's sum through a
//   rounded float32 add (then ~5e-7 of max|ref|).
// * Thin blocks (bm <= 8, pick_tiles' (8, 128)) compute the transpose
//   C^T = B_panel^T * block^T: the RHS columns run along the MMA's 16-row
//   M and the block's rows along its 8-wide N, so no MMA row is wasted.
// * Shared rows are padded (A by 4 floats, B by 8) so every fragment read
//   of a warp hits 32 distinct banks. All element offsets are 64-bit.
//
// What bounds it on the H100 (80GB HBM3, 700 W): fat blocks run at 37-50
// TFLOP/s of float32 work (110-150 TFLOP/s of TF32 MMAs). A warp issues
// about 4.3 instructions per MMA (the split takes 60% of them), and the
// L2 feeds 2 TB/s of block and panel re-reads across row slices and N
// tiles; mma.sync also reaches only part of the rate wgmma would. Thin
// blocks are bound by the B-panel reads: a (8, bk) block reads a (bk, N)
// panel of B for 16 flops per panel element (3.8 TB/s at (8, 128)).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the launcher returns cudaGetLastError() of the launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;      // k depth of one pipeline chunk
constexpr int STAGES = 4;   // depth of the shared-memory ring
constexpr int A_PAD = 4;    // A row stride TK + 4 = 4 (mod 32 banks)
constexpr int B_PAD = 8;    // B row stride TN + 8 = 8 (mod 32 banks)

// A thread block's output tile is TM rows of a block row by TN RHS
// columns; WARPS_M x WARPS_N warps each own a (TM / WARPS_M, TN / WARPS_N)
// piece of it. TRANS puts the tile's columns on the MMA's M dimension.
// MIN_BLOCKS thread blocks per SM cap the registers a thread may take.
template <int TM_, int TN_, int WARPS_M_, int WARPS_N_, bool TRANS_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr bool TRANS = TRANS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = TM / WARPS_M, WTN = TN / WARPS_N;
  static constexpr int MT = TRANS ? WTN / 16 : WTM / 16;  // 16-row MMA tiles
  static constexpr int NT = TRANS ? WTM / 8 : WTN / 8;    // 8-col MMA tiles
  static constexpr int A_LD = TK + A_PAD, B_LD = TN + B_PAD;
  static constexpr int STAGE = TM * A_LD + TK * B_LD;     // floats
  static constexpr int SMEM = STAGES * STAGE * 4;         // bytes
  static_assert(MT >= 1 && NT >= 1, "warp tile smaller than one MMA");
  static_assert((STAGE * 4) % 16 == 0 && (A_LD * 4) % 16 == 0 &&
                (B_LD * 4) % 16 == 0, "16-byte copies need 16-byte rows");
};

// (64, 256) and (256, 512) blocks: a 64 x 128 tile, 4 warps of 32 x 64,
// 2 blocks per SM (104 KB of ring each, <= 255 registers a thread).
using FatTile = Tile<64, 128, 2, 2, false, 2>;
// (8, 128) blocks: an 8 x 128 tile computed transposed, 4 warps of 8 x 32.
using ThinTile = Tile<8, 128, 1, 4, true, 2>;

// x rounded to TF32, to nearest with ties away from zero, as bits: the
// rounding of cvt.rna.tf32.f32 for finite x, done with two integer
// instructions instead of the conversion pipe (a quarter of their rate).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = SPLIT ? rna_tf32(x - __uint_as_float(hi)) : 0u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async of 16 or 4 bytes; with ok false nothing is read and the
// destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy a (R, W) float region into shared rows of stride LD, VEC floats per
// copy; valid(r, c) says whether the source of the VEC floats at (r, c)
// lies inside the operand, src(r, c) where they are.
template <int R, int W, int LD, int VEC, int THREADS, class Valid, class Src>
__device__ __forceinline__ void stage_copy(float* dst, const float* safe,
                                           Valid valid, Src src) {
  constexpr int PER_ROW = W / VEC, COUNT = R * PER_ROW;
#pragma unroll
  for (int it = 0; it < (COUNT + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (COUNT % THREADS == 0 || i < COUNT) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
      const bool ok = valid(r, c);
      cp_async<VEC * 4>(dst + r * LD + c, ok ? src(r, c) : safe, ok);
    }
  }
}

template <class T, bool SPLIT>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
bsr_spmm_tc(const float* __restrict__ blocks,
            const int* __restrict__ live_ptr,
            const int* __restrict__ live_idx,
            const int* __restrict__ bcols, const float* __restrict__ B,
            float* __restrict__ C, int rows, int K, int N, int bm, int bk,
            long long ldb, long long ldc, int m_sub, int n_tiles, bool vec_a,
            bool vec_b) {
  constexpr int TM = T::TM, TN = T::TN, A_LD = T::A_LD, B_LD = T::B_LD;
  constexpr int MT = T::MT, NT = T::NT, THREADS = T::THREADS;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = (warp / T::WARPS_N) * T::WTM;  // warp's first tile row
  const int wc = (warp % T::WARPS_N) * T::WTN;  // warp's first tile column
  // N tiles vary fastest, so the tiles of one block row run together and
  // share its blocks through L2.
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * TN;
  const unsigned rest = blockIdx.x / n_tiles;
  const int m0 = static_cast<int>(rest % m_sub) * TM;
  const int br = static_cast<int>(rest / m_sub);

  const int p0 = live_ptr[br];
  const int kc = (bk + TK - 1) / TK;  // chunks per block
  const int nch = (live_ptr[br + 1] - p0) * kc;

  auto load = [&](int stage, int j) {
    const int li = live_idx[p0 + j / kc];
    const int k0 = (j % kc) * TK;
    float* as = smem + stage * T::STAGE;
    float* bs = as + TM * A_LD;
    const float* A = blocks + static_cast<long long>(li) * bm * bk;
    const long long kb = static_cast<long long>(bcols[li]) * bk + k0;
    auto a_ok = [&](int r, int c) { return m0 + r < bm && k0 + c < bk; };
    auto a_src = [&](int r, int c) {
      return A + static_cast<long long>(m0 + r) * bk + (k0 + c);
    };
    auto b_ok = [&](int r, int c) {
      return k0 + r < bk && kb + r < K && n0 + c < N;
    };
    auto b_src = [&](int r, int c) { return B + (kb + r) * ldb + (n0 + c); };
    if (vec_a)
      stage_copy<TM, TK, A_LD, 4, THREADS>(as, blocks, a_ok, a_src);
    else
      stage_copy<TM, TK, A_LD, 1, THREADS>(as, blocks, a_ok, a_src);
    if (vec_b)
      stage_copy<TK, TN, B_LD, 4, THREADS>(bs, B, b_ok, b_src);
    else
      stage_copy<TK, TN, B_LD, 1, THREADS>(bs, B, b_ok, b_src);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nch; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk j has landed; every warp is done with j - 1
    if (j + STAGES - 1 < nch) load((j + STAGES - 1) % STAGES, j + STAGES - 1);
    cp_async_commit();

    const float* as = smem + (j % STAGES) * T::STAGE;
    const float* bs = as + TM * A_LD;
    // The tensor cores truncate as they accumulate: their sums span one
    // chunk only and join the tile's sum through a rounded float32 add.
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][n][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      // MMA fragments (PTX m16n8k8 .tf32 layout): a[q] at M row
      // g + 8*(q&1), k tig + 4*(q>>1); b[q] at k tig + 4*q, N col g.
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mo = i * 16 + g + (q & 1) * 8, ko = kk + tig + (q >> 1) * 4;
          const float x = T::TRANS ? bs[ko * B_LD + wc + mo]
                                   : as[(wr + mo) * A_LD + ko];
          split<SPLIT>(x, ah[i][q], al[i][q]);
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int no = n * 8 + g, ko = kk + tig + q * 4;
          const float x = T::TRANS ? as[(wr + no) * A_LD + ko]
                                   : bs[ko * B_LD + wc + no];
          split<SPLIT>(x, bh[n][q], bl[n][q]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (SPLIT) {
            mma_tf32(part[i][n], al[i], bh[n]);
            mma_tf32(part[i][n], ah[i], bl[n]);
          }
          mma_tf32(part[i][n], ah[i], bh[n]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] += part[i][n][q];
  }

  // Accumulator q of MMA tile (i, n) sits at M row i*16 + g + 8*(q>>1),
  // N col n*8 + 2*tig + (q&1).
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int mo = i * 16 + g + (q >> 1) * 8;
        const int no = n * 8 + 2 * tig + (q & 1);
        const int r = m0 + wr + (T::TRANS ? no : mo);
        const int c = n0 + wc + (T::TRANS ? mo : no);
        const long long gr = static_cast<long long>(br) * bm + r;
        if (r < bm && gr < rows && c < N) C[gr * ldc + c] = acc[i][n][q];
      }
}

template <class T, bool SPLIT>
cudaError_t prepare() {
  // The ring exceeds the 48 KB default: opt in once per process.
  static cudaError_t status = cudaFuncSetAttribute(
      bsr_spmm_tc<T, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  return status;
}

struct Args {
  const float* blocks;
  const int* live_ptr;
  const int* live_idx;
  const int* bcols;
  const float* B;
  float* C;
  int n_block_rows, rows, K, N, bm, bk;
  long long ldb, ldc;
};

template <class T, bool SPLIT>
int launch(const Args& a, cudaStream_t stream) {
  const cudaError_t prep = prepare<T, SPLIT>();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  const int m_sub = (a.bm + T::TM - 1) / T::TM;
  const int n_tiles = (a.N + T::TN - 1) / T::TN;
  const long long tiles =
      static_cast<long long>(a.n_block_rows) * m_sub * n_tiles;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_a = a.bk % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.blocks) % 16 == 0;
  const bool vec_b = a.N % 4 == 0 && a.ldb % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.B) % 16 == 0;
  bsr_spmm_tc<T, SPLIT><<<static_cast<unsigned>(tiles), T::THREADS, T::SMEM,
                          stream>>>(
      a.blocks, a.live_ptr, a.live_idx, a.bcols, a.B, a.C, a.rows, a.K, a.N,
      a.bm, a.bk, a.ldb, a.ldc, m_sub, n_tiles, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// threads, tile rows, tile cols, dynamic shared bytes, registers, local
// (spill) bytes per thread, resident thread blocks per SM.
template <class T, bool SPLIT>
int info(int* out) {
  const cudaError_t prep = prepare<T, SPLIT>();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, bsr_spmm_tc<T, SPLIT>);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bsr_spmm_tc<T, SPLIT>, T::THREADS, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[7] = {T::THREADS, T::TM, T::TN, T::SMEM, attr.numRegs,
                       static_cast<int>(attr.localSizeBytes), per_sm};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// passes: 3 for the 3xTF32 split (float32 accuracy), 1 for one TF32 pass.
extern "C" int bsm_spmm_bsr(const float* blocks, const int* live_ptr,
                            const int* live_idx, const int* block_cols,
                            const float* B, float* C, int n_block_rows,
                            int rows, int K, int N, int bm, int bk,
                            long long ldb, long long ldc, int passes,
                            void* stream) {
  if (n_block_rows <= 0 || N <= 0) return 0;
  if (passes != 1 && passes != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{blocks, live_ptr, live_idx, block_cols, B, C, n_block_rows,
               rows, K, N, bm, bk, ldb, ldc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= ThinTile::TM)
    return passes == 3 ? launch<ThinTile, true>(a, s)
                       : launch<ThinTile, false>(a, s);
  return passes == 3 ? launch<FatTile, true>(a, s)
                     : launch<FatTile, false>(a, s);
}

// The launch configuration bsm_spmm_bsr picks for (bm, passes), written
// to out[0..6] as info() lists it.
extern "C" int bsm_spmm_bsr_info(int bm, int passes, int* out) {
  if (bm <= ThinTile::TM)
    return passes == 3 ? info<ThinTile, true>(out)
                       : info<ThinTile, false>(out);
  return passes == 3 ? info<FatTile, true>(out) : info<FatTile, false>(out);
}

extern "C" const char* bsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

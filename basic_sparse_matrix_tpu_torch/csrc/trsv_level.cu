// K7: the level step of the level-scheduled sparse triangular solve, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package writes its level step in plain
// jnp (models/sparse_triangular.py::_solve_scheduled: gathers and a
// segment_sum under fori_loop, which XLA fuses into one compiled loop). The
// port ran it as four aten operations a level (an index_select gather, a
// multiply, an index_add_ into the level's rows, a multiply by the
// reciprocal diagonal) inside a captured CUDA graph: four graph nodes of a
// few microseconds each for a level whose work is a fraction of a
// microsecond (9,360 levels a 32^3 nested-dissection solve, 1,444 an IC(0)
// preconditioner application at 104^3). This kernel was added to take the
// level step out of the launch latency.
//
// What it computes, on y (the unknowns in level order, already holding b):
// for each level in order and each row i of the level,
//   y[i] = (y[i] - sum_e vals[e] * y[cols[e]]) * inv_diag[i]
// over the row's off-diagonal entries e in [eptr[i], eptr[i+1]). Rows of one
// level depend only on rows of earlier levels.
//
// The design. A launch covers either one wide level, spread over many
// blocks, or a run of consecutive narrow levels, walked by one block with
// __syncthreads() between levels (a write before the barrier is visible to
// the whole block after it), so a run of thousands of levels is one graph
// node. The caller's plan (models/sparse_triangular.py::launch_plan) says
// which: a narrow level is one that one block finishes faster than a
// launch costs. Inside a level, each row gets a team of g threads (a power
// of two, from the level's mean row length and the threads at hand): a
// lane sums the entries lane, lane + g, ... of its row in storage order,
// in float32 with one fma each; the team then adds its lanes by a fixed
// butterfly of warp shuffles, and a team wider than a warp (the long rows
// of a separator, which take the whole block) adds its warps' sums,
// through shared memory, by a second fixed butterfly. No atomics: the
// result is the same from run to run. Every launch lets the next one be
// launched at once (programmatic dependent launch, which a captured graph
// keeps as its edge) and reads the unknowns only after the launch before
// it has finished: each launch's start-up and its loads of columns and
// values overlap the launch before.
//
// What bounds it on the H100 (measured, PERF.md, K7): latency. A level in
// a run costs at least about 1 us (the barrier, then dependent reads), and
// one SM streams a run's columns and values at about 25-30 GB/s; a wide
// launch costs about 1.1-1.3 us a level under programmatic dependent
// launch, against a bound of 0.09 us for the bytes of the median IC(0)
// level at 104^3. What the design does about it: a run copies the next
// level's columns, values (16 bytes a copy where aligned), row pointers,
// reciprocal diagonals and right-hand sides into shared memory with
// cp.async while it computes the current level (none of them depends on
// an unknown of the run), so that after a barrier only the gather of y
// waits on memory; a level of fewer than STAGE_MIN entries, or too large
// for the buffers, is read where it lies (correct at any size). Where the
// system has at most Y_CACHE unknowns (32,768: the 32^3 grid), the run
// holds all of them in shared memory, so the gathers, thousands of
// scattered 4-byte reads a level that would each move a 32-byte sector
// from L2, read shared memory; each result is written there and to y.
//
// Shapes: y is (Bt, n, k) float32, contiguous, in level order. The batch
// is on blockIdx.y (each system's values at vstride * bt and reciprocal
// diagonals at dstride * bt; 0 strides share one set) and the right-hand
// side's columns on blockIdx.z, each column an independent solve. The
// launcher walks a host plan of (first level, end level, blocks) rows:
// blocks 0 is a narrow run (one block per system and column), blocks > 0
// one wide level on that many blocks. Launches go on the caller's stream;
// nothing is allocated; the function returns the first CUDA error.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RUN_THREADS = 512;
constexpr int WIDE_THREADS = 256;
constexpr int WARPS = RUN_THREADS / 32;
// Rows a level staged in a run may have (the plan's NARROW_ROWS at most).
constexpr int STAGE_ROWS = 256;
// A system of at most Y_CACHE unknowns is held whole in a run's shared
// memory, so the gathers read shared memory and not L2.
constexpr int Y_CACHE = 32768;
// A run stages a level of at least this many entries; a smaller one is
// read where it lies (its few loads cost less than waiting for a copy).
constexpr int STAGE_MIN = 512;

// A run's shared memory: the unknowns (CACHED), two staging buffers, each
// cols and vals (ENTRIES each, 16-byte aligned), ptr (rows + 1), inv and,
// without the cache, the rows' right-hand sides (rows each), padded to 16
// bytes; then the two parities of the warps' partial sums. Both fit the
// 227 KB a block may have.
template <bool CACHED>
struct Layout {
  static constexpr int Y = CACHED ? Y_CACHE : 0;
  static constexpr int ENTRIES = CACHED ? 6016 : 12288;
  static constexpr int RHS = CACHED ? 0 : STAGE_ROWS;
  static constexpr int WORDS =
      (2 * ENTRIES + 2 * STAGE_ROWS + 1 + RHS + 3) / 4 * 4;
  static constexpr size_t SMEM = (Y + 2 * WORDS + 2 * WARPS) * sizeof(float);
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// 16 bytes, of which the first `bytes` (0 to 16) are read and the rest
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Programmatic dependent launch: a grid lets the next one be launched at
// once, and the next reads the unknowns only after griddepcontrol.wait,
// which returns when the grid before it has finished and its writes are
// visible; what does not depend on y is loaded before.
__device__ __forceinline__ void let_next_grid_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Threads a row gets: the least power of two at or above the level's mean
// row length, at most the block, and small enough that every row has a
// team among the `threads` that share the level (when there are enough).
__device__ __forceinline__ int team_size(int nr, int ne, int threads) {
  const int avg = min((ne + nr - 1) / nr, (int)blockDim.x);
  const int want = avg <= 1 ? 1 : 1 << (32 - __clz(avg - 1));
  const int per_row = max(threads / nr, 1);
  const int fit = 1 << (31 - __clz(per_row));
  return min(want, fit);
}

// Rows [r0, r0 + nr) of one level for one system and one column: row i's
// entries are [ptr[i], ptr[i + 1]) less `ebase` in cols and vals, its
// reciprocal diagonal inv[i], its right-hand side rhs[i * rstride]. The
// unknowns are gathered from yin (row stride kin) and each row's result is
// written to y (row stride k) and, where it is not null, to ycache. The
// block's teams are team0 .. team0 + blockDim.x / g - 1 of `teams` in all;
// every thread of the block calls this with the same arguments but team0
// (the loop trip count is the block's, so the barriers of wide teams are
// uniform). `part` holds 2 * (blockDim.x / 32) floats. WAIT: wait for the
// prior grid before the first read of the unknowns.
template <bool WAIT>
__device__ __forceinline__ void level_step(
    const float* yin, int kin, float* y, int k, float* ycache, int r0, int nr,
    const int* ptr, int ebase, const int* cols, const float* vals,
    const float* inv, const float* rhs, int rstride, int team0, int teams,
    int g, float* part) {
  const int tid = threadIdx.x;
  const int lane = tid & (g - 1);
  const int team = team0 + tid / g;
  const int nwarps = blockDim.x >> 5;
  int parity = 0;
  bool waited = !WAIT;
  auto wait = [&waited]() {
    if (!waited) {
      wait_for_prior_grid();
      waited = true;
    }
  };
  for (int base = 0; base < nr; base += teams) {
    const int i = base + team;
    float s = 0.f;
    if (i < nr) {
      const int a = ptr[i] - ebase, b = ptr[i + 1] - ebase;
      // Four entries' loads in flight at once; the sum keeps their order.
      int e = a + lane;
      for (; e + 3 * g < b; e += 4 * g) {
        const int c0 = cols[e], c1 = cols[e + g], c2 = cols[e + 2 * g],
                  c3 = cols[e + 3 * g];
        const float v0 = vals[e], v1 = vals[e + g], v2 = vals[e + 2 * g],
                    v3 = vals[e + 3 * g];
        wait();
        const float y0 = yin[(long long)c0 * kin],
                    y1 = yin[(long long)c1 * kin],
                    y2 = yin[(long long)c2 * kin],
                    y3 = yin[(long long)c3 * kin];
        s = fmaf(v3, y3, fmaf(v2, y2, fmaf(v1, y1, fmaf(v0, y0, s))));
      }
      for (; e < b; e += g) {
        const int c = cols[e];
        const float v = vals[e];
        wait();
        s = fmaf(v, yin[(long long)c * kin], s);
      }
    }
    if (g <= 32) {
      for (int o = g >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
    } else {
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      // Two parities: the next pass writes the other half, so one barrier
      // a pass keeps a leader's reads apart from the next pass's writes.
      float* half = part + parity * nwarps;
      if ((tid & 31) == 0) half[tid >> 5] = s;
      __syncthreads();
      if (lane < 32) {  // the team's first warp adds its warps' sums
        const int nw = g >> 5, l = tid & 31;
        s = l < nw ? half[(tid >> 5) + l] : 0.f;
        for (int o = nw >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      parity ^= 1;
    }
    if (lane == 0 && i < nr) {
      wait();
      const float v = (rhs[(long long)i * rstride] - s) * inv[i];
      y[(long long)(r0 + i) * k] = v;
      if (ycache != nullptr) ycache[r0 + i] = v;
    }
  }
}

struct Stage {
  int* cols;
  float* vals;
  int* ptr;
  float* inv;
  float* rhs;
};

template <bool CACHED>
__device__ __forceinline__ Stage stage_at(float* bufs, int which) {
  using L = Layout<CACHED>;
  float* base = bufs + which * L::WORDS;
  Stage s;
  s.cols = reinterpret_cast<int*>(base);
  s.vals = base + L::ENTRIES;
  s.ptr = reinterpret_cast<int*>(base + 2 * L::ENTRIES);
  s.inv = base + 2 * L::ENTRIES + STAGE_ROWS + 1;
  s.rhs = s.inv + STAGE_ROWS;
  return s;
}

// The first entry of the staging window of a level starting at entry e0:
// e0 rounded down so that cols + window is 16-byte aligned.
__device__ __forceinline__ int window(const int* cols, int e0) {
  return e0 - (int)((reinterpret_cast<uintptr_t>(cols + e0) >> 2) & 3);
}

// Start copying level [a, b) (row and entry starts) into a buffer: the
// entries [window, b.y) of cols and vals (16 bytes a copy where aligned,
// none read past entry nnz), the rows' pointers, reciprocal diagonals and,
// without the cache, right-hand sides (y's rows, which no earlier level
// writes). False, with nothing copied, when it does not fit.
template <bool CACHED>
__device__ __forceinline__ bool stage_level(Stage s, int2 a, int2 b,
                                            const int* cols,
                                            const float* vals,
                                            const int* eptr,
                                            const float* inv,
                                            const float* y, int k,
                                            long long nnz) {
  const int nr = b.x - a.x, w = window(cols, a.y);
  const int span = b.y - w;
  if (nr > STAGE_ROWS || span < STAGE_MIN
      || span > Layout<CACHED>::ENTRIES - 3)
    return false;
  const bool vec_vals = ((reinterpret_cast<uintptr_t>(vals + w)) & 15) == 0;
  for (int q = threadIdx.x; 4 * q < span; q += blockDim.x) {
    const long long e = (long long)w + 4 * q;
    const int bytes = (int)min(16LL, max(0LL, 4 * (nnz - e)));
    cp_async16(s.cols + 4 * q, cols + e, bytes);
    if (vec_vals) cp_async16(s.vals + 4 * q, vals + e, bytes);
  }
  if (!vec_vals)
    for (int i = threadIdx.x; i < span; i += blockDim.x)
      cp_async4(s.vals + i, vals + w + i);
  for (int i = threadIdx.x; i <= nr; i += blockDim.x)
    cp_async4(s.ptr + i, eptr + a.x + i);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    cp_async4(s.inv + i, inv + a.x + i);
    if (!CACHED) cp_async4(s.rhs + i, y + (long long)(a.x + i) * k);
  }
  return true;
}

// A run of narrow levels [lv0, lv1) on one block per (system, column);
// CACHED: the system's n <= Y_CACHE unknowns live in shared memory.
template <bool CACHED>
__global__ void __launch_bounds__(RUN_THREADS)
trsv_run(float* y, const float* __restrict__ vals,
         const float* __restrict__ inv_diag, const int* __restrict__ cols,
         const int* __restrict__ eptr, const int2* __restrict__ levels,
         int lv0, int lv1, int n, int k, long long nnz, long long vstride,
         long long dstride) {
  using L = Layout<CACHED>;
  extern __shared__ __align__(16) float smem[];
  float* ycache = CACHED ? smem : nullptr;
  float* bufs = smem + L::Y;
  float* part = bufs + 2 * L::WORDS;
  float* yb = y + (long long)blockIdx.y * n * k + blockIdx.z;
  const float* vb = vals + vstride * blockIdx.y;
  const float* db = inv_diag + dstride * blockIdx.y;
  const float* yin = CACHED ? ycache : yb;
  const int kin = CACHED ? 1 : k;
  let_next_grid_launch();
  wait_for_prior_grid();
  if (CACHED)   // read before the first barrier below
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      ycache[i] = yb[(long long)i * k];
  // levels[lv .. lv + 2] at the top of pass lv, each loaded a pass ahead
  // of its use.
  int2 cur = __ldg(levels + lv0), nxt = __ldg(levels + lv0 + 1);
  int2 aft = __ldg(levels + min(lv0 + 2, lv1));
  bool staged = stage_level<CACHED>(stage_at<CACHED>(bufs, 0), cur, nxt,
                                    cols, vb, eptr, db, yb, k, nnz);
  cp_async_commit();
  for (int lv = lv0; lv < lv1; ++lv) {
    const int2 ahead = __ldg(levels + min(lv + 3, lv1));
    cp_async_wait_all();
    __syncthreads();  // the level's inputs staged, earlier levels written
    bool staged_next = false;
    if (lv + 1 < lv1)
      staged_next = stage_level<CACHED>(
          stage_at<CACHED>(bufs, (lv + 1 - lv0) & 1), nxt, aft, cols, vb,
          eptr, db, yb, k, nnz);
    cp_async_commit();
    const int nr = nxt.x - cur.x, ne = nxt.y - cur.y;
    const int g = team_size(nr, ne, blockDim.x);
    const int teams = blockDim.x / g;
    if (staged) {
      const Stage s = stage_at<CACHED>(bufs, (lv - lv0) & 1);
      level_step<false>(yin, kin, yb, k, ycache, cur.x, nr, s.ptr,
                        window(cols, cur.y), s.cols, s.vals, s.inv,
                        CACHED ? ycache + cur.x : s.rhs, 1, 0, teams, g,
                        part);
    } else {
      level_step<false>(yin, kin, yb, k, ycache, cur.x, nr, eptr + cur.x, 0,
                        cols, vb, db + cur.x, yin + (long long)cur.x * kin,
                        kin, 0, teams, g, part);
    }
    cur = nxt;
    nxt = aft;
    aft = ahead;
    staged = staged_next;
  }
}

// One wide level `lv` on gridDim.x blocks per (system, column).
__global__ void __launch_bounds__(WIDE_THREADS)
trsv_wide(float* y, const float* __restrict__ vals,
          const float* __restrict__ inv_diag, const int* __restrict__ cols,
          const int* __restrict__ eptr, const int2* __restrict__ levels,
          int lv, int n, int k, long long vstride, long long dstride) {
  __shared__ float part[2 * WIDE_THREADS / 32];
  let_next_grid_launch();
  const int2 a = __ldg(levels + lv), b = __ldg(levels + lv + 1);
  const int nr = b.x - a.x, ne = b.y - a.y;
  const int g = team_size(nr, ne, blockDim.x * gridDim.x);
  const int per_block = blockDim.x / g;
  float* yb = y + (long long)blockIdx.y * n * k + blockIdx.z;
  level_step<true>(yb, k, yb, k, nullptr, a.x, nr, eptr + a.x, 0, cols,
                   vals + vstride * blockIdx.y,
                   inv_diag + dstride * blockIdx.y + a.x,
                   yb + (long long)a.x * k, k, blockIdx.x * per_block,
                   per_block * gridDim.x, g, part);
}

template <bool CACHED>
cudaError_t prepare() {
  // A run's shared memory exceeds the 48 KB default: opt in once per
  // process.
  static cudaError_t status = cudaFuncSetAttribute(
      trsv_run<CACHED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<CACHED>::SMEM);
  return status;
}

// A launch on `s` that may start while the kernel before it runs (it waits
// for that kernel where it reads y).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                   cudaStream_t s, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

}  // namespace

// y: (bt, n, k) float32 in level order, solved in place. vals (nnz) and
// inv_diag (n) per system at strides vstride and dstride (0: shared).
// cols: (nnz,) int32 level-order columns; eptr: (n + 1,) int32 entry
// pointer of each level-order row; levels: (n_levels + 1, 2) int32 row and
// entry start of each level. plan: host (launches, 3) int32 rows of (first
// level, end level, blocks), blocks 0 a narrow run.
extern "C" int bsm_trsv(float* y, const float* vals, const float* inv_diag,
                        const int* cols, const int* eptr, const int* levels,
                        const int* plan, int launches, int n, int k, int bt,
                        long long nnz, long long vstride, long long dstride,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || bt <= 0 || launches <= 0) return 0;
  if (k > 65535 || bt > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool cached = n <= Y_CACHE;
  const cudaError_t prep = cached ? prepare<true>() : prepare<false>();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  const int2* lv = reinterpret_cast<const int2*>(levels);
  for (int i = 0; i < launches; ++i) {
    const int lv0 = plan[3 * i], lv1 = plan[3 * i + 1];
    const int blocks = plan[3 * i + 2];
    cudaError_t err;
    if (blocks == 0 && cached) {
      err = launch(trsv_run<true>, dim3(1, bt, k), RUN_THREADS,
                   Layout<true>::SMEM, s, y, vals, inv_diag, cols, eptr, lv,
                   lv0, lv1, n, k, nnz, vstride, dstride);
    } else if (blocks == 0) {
      err = launch(trsv_run<false>, dim3(1, bt, k), RUN_THREADS,
                   Layout<false>::SMEM, s, y, vals, inv_diag, cols, eptr, lv,
                   lv0, lv1, n, k, nnz, vstride, dstride);
    } else {
      err = launch(trsv_wide, dim3(blocks, bt, k), WIDE_THREADS, 0, s, y,
                   vals, inv_diag, cols, eptr, lv, lv0, n, k, vstride,
                   dstride);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The kernel's constants, for the wrapper's plan and the probes: run
// threads, wide threads, entries and rows a staged level may have, the
// largest system a run holds in shared memory, and the entries a staged
// level may have then.
extern "C" int bsm_trsv_info(int* out) {
  out[0] = RUN_THREADS;
  out[1] = WIDE_THREADS;
  out[2] = Layout<false>::ENTRIES;
  out[3] = STAGE_ROWS;
  out[4] = Y_CACHE;
  out[5] = Layout<true>::ENTRIES;
  return 0;
}

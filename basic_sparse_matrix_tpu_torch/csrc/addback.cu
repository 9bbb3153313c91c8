// K4 + K5: add a level's update deltas into their storage runs of the
// supernodal factor values, for Hopper (sm_90a). Two entries:
//
// bsm_addback (the span entry) replaces two TPU kernels that compute one
// function over two slot layouts:
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
// bsm_addback_rects (the rect entry) takes the merged rects p (St, Rd, Wt)
// as the level's products leave them, not sheared and not negated:
//   lvals[tcp[s, w] + r - w] -= p[s, r, w]   for w < twd[s], w <= r < tnr[s]
// which is the shear (storage row of column w = p[s, w:, w]) and the
// negation followed by the span entry. It takes a batch of Bt systems of
// one pattern in one launch, lvals (Bt, n) and p (Bt, St, Rd, Wt) with the
// tables tcp, tnr, twd shared: system b adds p[b] into lvals[b], and an
// index outside [0, n) is dropped for each system on its own (it never
// lands in a neighbouring system). The span entry takes one system. The
// TPU kernels need the shear done before them, as an array of 128-lane rows
// padded to a class width, because Mosaic moves aligned windows; a CUDA
// thread reads p[s, r, w] where it lies, so the sheared array, its pads and
// the passes that build them never exist. (The TPU kernels have no batch
// axis: JAX's vmap maps them over the systems.)
//
// What differs from the TPU kernels: the TPU runs the slots one after
// another (a sequential loop inside one grid step, the factor resident in
// VMEM or moved by 1024-aligned DMA windows), so overlapping spans are
// summed in order. Here all slots run at once. Live spans may overlap (the
// zero tails of a row land in the neighbouring runs, and a caller may pass
// overlapping runs outright), so a plain read-modify-write would lose
// updates: every add is an atomic reduction in L2. The order of the adds
// into one element is not fixed, so where several slots hit one element its
// float32 sum may differ in the last bits from run to run; an element hit
// by one slot only gets one add and is bitwise reproducible.
//
// What bounds it on the H100: the read of the rows (or rects), streamed
// once, and the reductions on the factor values, resolved in L2, where the
// whole factor of the main path fits. The design, in that order:
//   * Work by slot, not a block by slot. WARPS take slots, from a loop once
//     the grid reaches a few times what the card holds at once; a row longer
//     than PART elements is cut into parts, each a slot of its own, so long
//     rows spread over warps with no synchronisation. A dead slot costs its
//     warp one 4-byte load (one per part of a long row); the (panel, column)
//     layout's dead columns are told from twd in the kernel, so its wrapper
//     builds no starts array.
//   * 16-byte traffic. The destination lvals + starts[c] has any alignment,
//     so the adds are laid on the destination's 16-byte grid: quad j covers
//     span elements 4j - m .. 4j - m + 3, m the misalignment of the span's
//     first element. A quad wholly inside the span goes as ONE
//     atomicAdd(float4*) (compute capability 9.0); the first and last quads,
//     when cut by the span's ends or by the end of lvals, go as scalar
//     atomicAdds of their inside elements. The source is read in aligned
//     float4s, two per quad when m != 0 (the second hits L1).
//   * Stop at the end of the run. A real row is its column's storage run and
//     then zeros up to the class width. A warp loads its whole part at once
//     (four independent float4 loads a lane, so one memory round trip, not
//     four), ballots which quads hold a nonzero and takes the LAST such quad
//     as the end of the run: the adds, and the second read a shifted quad
//     needs, cover the part up to there only. Every element past the end
//     was read and seen to be zero, so the rule is exact: it never cuts a
//     live value, and zeros inside the run (rect rows that no update of the
//     level touched) are legal. A stop after the first run of zeros from
//     the front would read less and be wrong for those. Quads that are all
//     zero are skipped on the way, as a zero adds nothing.
//   * len % 4 != 0 or rows not 16-byte aligned: a scalar warp loop.
// The rect entry stages a (128 rows, 32 columns) tile of one panel through
// shared memory: read along w as p lies (coalesced), written along r, so a
// warp's adds to one column's run are consecutive addresses and go through
// the same quad logic. The tile is swizzled (column (c + r + r/4) % 32 of
// row r) so that both the row-wise fill and the quad-wise read are free of
// bank conflicts. Rows >= tnr[s], columns >= twd[s] and the upper wedge
// r < w are masked, never read and never added: nothing lands outside the
// runs.
//
// Offsets are 64-bit. Plain C interface for ctypes; the launch goes on the
// caller's stream and the functions return the first CUDA error.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// Elements of a row one warp takes: 4 float4 a lane.
constexpr int PART = 512;
// Rect tile: rows and columns.
constexpr int TR = 128;
constexpr int TC = 32;

// Misalignment, in elements, of lvals[e] on the 16-byte grid.
__device__ __forceinline__ int misalign(const float* lvals, long long e) {
  return (int)(((reinterpret_cast<uintptr_t>(lvals) >> 2) + (uintptr_t)e) & 3);
}

// Add quad v at the 16-byte aligned dst; element k of it is span element
// e0 + k and is inside the span iff 0 <= e0 + k < cnt.
__device__ __forceinline__ void add_quad(float* dst, float4 v, int e0,
                                         int cnt) {
  if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) return;
  if (e0 >= 0 && e0 + 4 <= cnt) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e0 + k >= 0 && e0 + k < cnt && e[k] != 0.f) atomicAdd(dst + k, e[k]);
}

// With a (panel, column) slot layout (twd given), slot c is column c % wt of
// panel c / wt and is dead from column twd[panel] on.
__device__ __forceinline__ bool dead_column(const int* twd, int wt,
                                            long long c) {
  if (twd == nullptr) return false;
  const long long s = c / wt;
  return (int)(c - s * wt) >= __ldg(twd + s);
}

// Span element range [4j - m, 4j - m + 4) out of aligned source quads j - 1
// (lo) and j (hi).
__device__ __forceinline__ float4 shifted(float4 lo, float4 hi, int m) {
  switch (m) {
    case 1: return make_float4(lo.w, hi.x, hi.y, hi.z);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    case 3: return make_float4(lo.y, lo.z, lo.w, hi.x);
    default: return hi;
  }
}

// The span entry, rows in aligned float4s (len % 4 == 0, rows 16-byte
// aligned). A slot is one part of one row; parts = ceil(len / PART).
__global__ void __launch_bounds__(THREADS)
addback_spans_vec(float* __restrict__ lvals, long long n,
                  const float* __restrict__ rows,
                  const int* __restrict__ starts,
                  const int* __restrict__ twd, int wt, long long nparts,
                  int parts, int len) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long v = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       v < nparts; v += nwarps) {
    const long long c = v / parts;
    const int off = (int)(v - c * parts) * PART;
    const int st = __ldg(starts + c);
    // dead slot: uniform across the warp
    if (st < 0 || dead_column(twd, wt, c)) continue;
    const long long first = (long long)st + off;
    // elements of this part that land inside lvals (the drop rule)
    const long long room = n - first;
    int cnt = min(PART, len - off);
    if (room < cnt) cnt = (int)room;
    if (cnt <= 0) continue;
    const float4* src =
        reinterpret_cast<const float4*>(rows + c * len + off);
    const int nq = (cnt + 3) >> 2;  // source quads that hold span elements

    // The part's quads, one aligned float4 a lane and step, all loads in
    // flight at once: quad 32u + lane in q[u].
    float4 q[PART / 128 + 1];
#pragma unroll
    for (int u = 0; u < PART / 128; ++u) {
      const int i = 32 * u + lane;
      q[u] = i < nq ? __ldg(src + i) : zero;
    }
    q[PART / 128] = zero;
    // End of the run: the last quad that holds a nonzero, -1 if none.
    int last = -1;
#pragma unroll
    for (int u = 0; u < PART / 128; ++u) {
      const unsigned hit = __ballot_sync(
          FULL, q[u].x != 0.f || q[u].y != 0.f || q[u].z != 0.f ||
                    q[u].w != 0.f);
      if (hit) last = 32 * u + 31 - __clz(hit);
    }
    if (last < 0) continue;
    cnt = min(cnt, 4 * (last + 1));

    const int m = misalign(lvals, first);
    float* dst = lvals + first - m;  // 16-byte aligned
    const int nd = (m + cnt + 3) >> 2;  // <= last + 2
#pragma unroll
    for (int u = 0; u <= PART / 128; ++u) {
      const int j = 32 * u + lane;
      if (j >= nd) break;
      // quad j - 1 was loaded by the lane before: an L1 hit
      const float4 lo = (m != 0 && j > 0) ? __ldg(src + j - 1) : zero;
      add_quad(dst + 4 * j, shifted(lo, q[u], m), 4 * j - m, cnt);
    }
  }
}

// The span entry for any len and alignment: a warp a slot, scalar adds.
__global__ void __launch_bounds__(THREADS)
addback_spans_scalar(float* __restrict__ lvals, long long n,
                     const float* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ twd, int wt, long long nslots,
                     int len) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long c = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       c < nslots; c += nwarps) {
    const int st = __ldg(starts + c);
    if (st < 0 || dead_column(twd, wt, c)) continue;
    const float* r = rows + c * len;
    float* dst = lvals + st;
    const long long avail = n - st;
    for (int q = lane; q < len && q < avail; q += 32) {
      const float x = __ldg(r + q);
      if (x != 0.f) atomicAdd(dst + q, x);
    }
  }
}

// The rect entry. A tile is rows [r0, r0 + TR) x columns [w0, w0 + TC) of
// one panel; blocks take tiles from a loop.
// With a batch, the tiles of system b follow those of system b - 1: tile t
// is tile t % (St * rtiles * ctiles) of system t / (St * rtiles * ctiles).
template <typename I>
__global__ void __launch_bounds__(THREADS)
addback_rects_kernel(float* __restrict__ lvals, long long n,
                     const float* __restrict__ p, const I* __restrict__ tcp,
                     const I* __restrict__ tnr, const I* __restrict__ twd,
                     long long ntiles, int St, int rtiles, int ctiles, int Rd,
                     int Wt) {
  __shared__ float tile[TR * TC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long per_sys = (long long)St * rtiles * ctiles;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long sys = t / per_sys;       // the system
    const long long ts = t - sys * per_sys;  // its tile
    const long long s = ts / (rtiles * ctiles);
    const int rem = (int)(ts - s * (rtiles * ctiles));
    float* const lv = lvals + sys * n;
    const int r0 = (rem / ctiles) * TR;
    const int w0 = (rem % ctiles) * TC;
    // live columns and rows of the panel; all three tests are uniform
    // across the block
    const int wd = (int)min((long long)__ldg(twd + s), (long long)Wt);
    const int nr = (int)min((long long)__ldg(tnr + s), (long long)Rd);
    // no live column, past the rows, or all wedge
    if (w0 >= wd || r0 >= nr || r0 + TR <= w0) continue;
    const int cw = min(TC, wd - w0);
    const int rh = min(TR, nr - r0);

    // fill: along w as p lies; the wedge r < w stays unread
    const float* src = p + ((sys * St + s) * Rd + r0) * Wt + w0;
    for (int e = threadIdx.x; e < rh * cw; e += THREADS) {
      const int i = e / cw;
      const int c = e - i * cw;
      const float x =
          r0 + i >= w0 + c ? __ldg(src + (long long)i * Wt + c) : 0.f;
      tile[i * TC + ((c + i + (i >> 2)) & (TC - 1))] = x;
    }
    __syncthreads();

    // drain: a warp a column, its rows as quads on the destination's grid
    for (int c = warp; c < cw; c += WARPS) {
      const int w = w0 + c;
      int a = max(w - r0, 0);            // first live tile row
      int b = rh;                        // one past the last
      // lvals index of tile row i is base + i; keep it inside [0, n)
      const long long base = (long long)__ldg(tcp + s * Wt + w) - w + r0;
      if (base + a < 0) a = (int)min(-base, (long long)b);
      if (base + b > n) b = (int)max(n - base, (long long)a);
      const int cnt = b - a;
      if (cnt <= 0) continue;
      const int m = misalign(lv, base + a);
      float* dst = lv + base + a - m;
      const int nd = (m + cnt + 3) >> 2;
      for (int j = lane; j < nd; j += 32) {
        float x[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * j - m + k;
          const int i = a + e;
          x[k] = (e >= 0 && e < cnt)
                     ? -tile[i * TC + ((c + i + (i >> 2)) & (TC - 1))]
                     : 0.f;
        }
        add_quad(dst + 4 * j, make_float4(x[0], x[1], x[2], x[3]),
                 4 * j - m, cnt);
      }
    }
    __syncthreads();
  }
}

// Blocks of `kernel` the card holds at once (the persistent grid), or
// minus the CUDA error.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return max(sms * per_sm, 1);
}

template <typename I>
int launch_rects(float* lvals, long long n, const float* p, const void* tcp,
                 const void* tnr, const void* twd, int Bt, int St, int Rd,
                 int Wt, cudaStream_t s) {
  static int resident = 0;  // per index type
  if (resident <= 0) resident = resident_blocks(addback_rects_kernel<I>);
  if (resident < 0) return -resident;
  const int rtiles = (Rd + TR - 1) / TR;
  const int ctiles = (Wt + TC - 1) / TC;
  const long long ntiles = (long long)Bt * St * rtiles * ctiles;
  const unsigned grid = (unsigned)min(ntiles, (long long)resident);
  addback_rects_kernel<I><<<grid, THREADS, 0, s>>>(
      lvals, n, p, static_cast<const I*>(tcp), static_cast<const I*>(tnr),
      static_cast<const I*>(twd), ntiles, St, rtiles, ctiles, Rd, Wt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A grid of up to GRID_WAVES times what the card holds at once: a warp per
// slot without a loop while the slots are few (a level's operand is mostly
// dead slots, which leave at once, and a loop would chain their loads), a
// loop over the rest when they are many.
constexpr int GRID_WAVES = 8;

// lvals (n,), rows (nslots, len), starts (nslots,); a slot is live iff
// starts[c] >= 0 and, where twd is given (slots laid out (nslots / wt, wt)),
// c % wt < twd[c / wt]. The split is picked here, by len and the alignment
// of rows.
extern "C" int bsm_addback(float* lvals, long long n, const float* rows,
                           const int* starts, const int* twd, int wt,
                           int nslots, int len, void* stream) {
  if (nslots <= 0 || len <= 0) return 0;
  if (twd != nullptr && wt <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident_vec = 0, resident_scalar = 0;
  const bool vec = len % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  if (vec) {
    if (resident_vec <= 0) resident_vec = resident_blocks(addback_spans_vec);
    if (resident_vec < 0) return -resident_vec;
    const int parts = (len + PART - 1) / PART;
    const long long nparts = (long long)nslots * parts;
    const unsigned grid = (unsigned)min(
        (nparts + WARPS - 1) / WARPS, (long long)resident_vec * GRID_WAVES);
    addback_spans_vec<<<grid, THREADS, 0, s>>>(lvals, n, rows, starts, twd,
                                               wt, nparts, parts, len);
  } else {
    if (resident_scalar <= 0)
      resident_scalar = resident_blocks(addback_spans_scalar);
    if (resident_scalar < 0) return -resident_scalar;
    const unsigned grid = (unsigned)min(
        ((long long)nslots + WARPS - 1) / WARPS,
        (long long)resident_scalar * GRID_WAVES);
    addback_spans_scalar<<<grid, THREADS, 0, s>>>(lvals, n, rows, starts, twd,
                                                  wt, nslots, len);
  }
  return static_cast<int>(cudaGetLastError());
}

// lvals (Bt, n), p (Bt, St, Rd, Wt) contiguous, tcp (St, Wt), tnr and twd
// (St,) of 32-bit (idx64 == 0) or 64-bit integers, shared by the batch.
extern "C" int bsm_addback_rects(float* lvals, long long n, const float* p,
                                 const void* tcp, const void* tnr,
                                 const void* twd, int Bt, int St, int Rd,
                                 int Wt, int idx64, void* stream) {
  if (Bt <= 0 || St <= 0 || Rd <= 0 || Wt <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_rects<long long>(lvals, n, p, tcp, tnr, twd, Bt, St,
                                         Rd, Wt, s)
               : launch_rects<int>(lvals, n, p, tcp, tnr, twd, Bt, St, Rd,
                                   Wt, s);
}

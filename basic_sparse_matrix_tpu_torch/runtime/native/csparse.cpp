// Native host-side symbolic sparse analysis for the TPU framework.
//
// The reference crate implements its whole runtime in native (Rust) code;
// per the build contract the TPU framework's host runtime is native C++.
// These routines are the sequential, pointer-chasing graph algorithms that
// XLA is the wrong tool for: COO->CSR conversion, elimination trees,
// symbolic Cholesky fill, and level-set extraction for parallel triangular
// solves. The numeric phases run on TPU; these produce the static schedules
// they consume.
//
// Exported with C linkage for ctypes. All index arrays are int64 (matching
// numpy's default on the host side); all functions are single-threaded and
// allocation-free (callers pass pre-sized buffers).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// COO -> CSR: counting sort by row, then stable per-row ordering by column.
// Duplicates are kept adjacent; the Python wrapper merges them vectorised.
// rows/cols/vals: nnz entries. out_* must be sized: indptr n_rows+1, perm nnz.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int64_t coo_to_csr_perm(int64_t n_rows, int64_t nnz, const int64_t* rows,
                        const int64_t* cols, int64_t* out_indptr,
                        int64_t* out_perm) {
  std::memset(out_indptr, 0, sizeof(int64_t) * (n_rows + 1));
  for (int64_t k = 0; k < nnz; ++k) out_indptr[rows[k] + 1]++;
  for (int64_t r = 0; r < n_rows; ++r) out_indptr[r + 1] += out_indptr[r];
  std::vector<int64_t> next(out_indptr, out_indptr + n_rows);
  for (int64_t k = 0; k < nnz; ++k) out_perm[next[rows[k]]++] = k;
  // Sort each row segment by column id (stable to keep insertion order of
  // duplicates deterministic).
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t lo = out_indptr[r], hi = out_indptr[r + 1];
    std::stable_sort(out_perm + lo, out_perm + hi,
                     [&](int64_t a, int64_t b) { return cols[a] < cols[b]; });
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Elimination tree of a symmetric matrix given its LOWER-triangular CSR
// pattern (diagonal entries ignored). Liu's algorithm with path compression
// via "ancestor". parent[i] = -1 for roots.
// ---------------------------------------------------------------------------
int64_t etree(int64_t n, const int64_t* indptr, const int64_t* indices,
              int64_t* parent) {
  std::vector<int64_t> ancestor(n);
  for (int64_t i = 0; i < n; ++i) {
    parent[i] = -1;
    ancestor[i] = -1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t k = indices[p];
      // walk from k up to i, compressing
      while (k != -1 && k < i) {
        int64_t next = ancestor[k];
        ancestor[k] = i;
        if (next == -1) parent[k] = i;
        k = next;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Symbolic Cholesky: row counts of L. Pass 1 of the two-pass symbolic
// factorization — for each row i, the nonzero columns of L(i,:) are the
// nodes on the etree paths from each A(i,j) (j<i) up to i. Uses a marker
// array; O(|L|) total.
// out_counts[i] = number of nonzeros in row i of L, INCLUDING the diagonal.
// ---------------------------------------------------------------------------
int64_t chol_row_counts(int64_t n, const int64_t* indptr,
                        const int64_t* indices, const int64_t* parent,
                        int64_t* out_counts) {
  std::vector<int64_t> mark(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    out_counts[i] = 1;  // diagonal
    mark[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      while (j != -1 && j < i && mark[j] != i) {
        mark[j] = i;
        out_counts[i]++;
        j = parent[j];
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Symbolic Cholesky pass 2: fill L's column indices row by row (sorted).
// l_indptr must already hold the exclusive prefix sum of row counts.
// ---------------------------------------------------------------------------
int64_t chol_pattern(int64_t n, const int64_t* indptr, const int64_t* indices,
                     const int64_t* parent, const int64_t* l_indptr,
                     int64_t* l_indices) {
  std::vector<int64_t> mark(n, -1);
  std::vector<int64_t> row;
  for (int64_t i = 0; i < n; ++i) {
    row.clear();
    mark[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      while (j != -1 && j < i && mark[j] != i) {
        mark[j] = i;
        row.push_back(j);
        j = parent[j];
      }
    }
    std::sort(row.begin(), row.end());
    int64_t base = l_indptr[i];
    for (size_t k = 0; k < row.size(); ++k) l_indices[base + k] = row[k];
    l_indices[base + static_cast<int64_t>(row.size())] = i;  // diagonal last
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Level sets for a lower-triangular solve: level[i] = 1 + max level of
// off-diagonal dependencies. Returns the number of levels. For an
// upper-triangular solve, pass the transposed pattern.
// ---------------------------------------------------------------------------
int64_t level_sets(int64_t n, const int64_t* indptr, const int64_t* indices,
                   int64_t* level) {
  int64_t max_level = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lv = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j < i && level[j] + 1 > lv) lv = level[j] + 1;
    }
    level[i] = lv;
    if (lv > max_level) max_level = lv;
  }
  return max_level + 1;
}

// ---------------------------------------------------------------------------
// Postorder of the elimination tree (for supernode detection / AMD-style
// reordering downstream). Iterative DFS over first-child/next-sibling.
// ---------------------------------------------------------------------------
int64_t postorder(int64_t n, const int64_t* parent, int64_t* post) {
  std::vector<int64_t> head(n, -1), next(n, -1), stack;
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t p = parent[i];
    if (p != -1) {
      next[i] = head[p];
      head[p] = i;
    }
  }
  int64_t k = 0;
  for (int64_t root = 0; root < n; ++root) {
    if (parent[root] != -1) continue;
    stack.push_back(root);
    while (!stack.empty()) {
      int64_t node = stack.back();
      int64_t child = head[node];
      if (child != -1) {
        head[node] = next[child];
        stack.push_back(child);
      } else {
        stack.pop_back();
        post[k++] = node;
      }
    }
  }
  return k;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Left-looking Cholesky update triples (numeric-phase scatter lists).
//
// Input: CSC pattern of L (col_ptr, row_idx; diagonal first per column) and
// the fan-in level of each column. For every column k and every ordered pair
// (j = row_idx[p], i = row_idx[q]) with p <= q over k's below-diagonal rows,
// the update L[i,j] -= L[i,k] * L[j,k] is emitted as the triple
//   (dst = pos(i,j), src_a = q, src_b = p)
// grouped by level[j]. Destination positions are found by merging k's row
// tail against column j's sorted row list (no hash lookups). Pairs whose
// (i,j) position is absent from the pattern (incomplete factorizations)
// are skipped.
//
// Two-phase API: pass count_only=1 to fill lvl_counts (size nlev) with the
// number of triples per level; then allocate per-level offsets and call with
// count_only=0 and lvl_offsets holding the running write cursor per level
// (exclusive prefix of counts; modified in place).
// Returns total number of triples emitted/counted.
// ---------------------------------------------------------------------------
int64_t chol_update_triples(int64_t n, const int64_t* col_ptr,
                            const int64_t* row_idx, const int64_t* level,
                            int64_t count_only, int64_t* lvl_counts_or_offsets,
                            int64_t* out_dst, int64_t* out_a,
                            int64_t* out_b) {
  int64_t total = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t lo = col_ptr[k] + 1;  // skip diagonal
    int64_t hi = col_ptr[k + 1];
    for (int64_t p = lo; p < hi; ++p) {
      int64_t j = row_idx[p];
      int64_t lvl = level[j];
      // Merge k's tail rows [p, hi) against column j's rows to locate
      // dst positions; both are sorted ascending.
      int64_t jp = col_ptr[j];
      int64_t jhi = col_ptr[j + 1];
      for (int64_t q = p; q < hi; ++q) {
        int64_t i = row_idx[q];
        while (jp < jhi && row_idx[jp] < i) ++jp;
        if (jp >= jhi) break;
        if (row_idx[jp] != i) continue;  // incomplete: outside pattern
        if (count_only) {
          lvl_counts_or_offsets[lvl]++;
        } else {
          int64_t w = lvl_counts_or_offsets[lvl]++;
          out_dst[w] = jp;
          out_a[w] = q;
          out_b[w] = p;
        }
        ++total;
      }
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering of a symmetric pattern (full adjacency CSR).
// Matches the Python fallback in runtime/symbolic.py exactly: BFS from
// minimum-degree start candidates (stable order), neighbours visited in
// stable degree order, whole sequence reversed at the end. O(nnz log d).
// ---------------------------------------------------------------------------
int64_t rcm_ordering(int64_t n, const int64_t* indptr, const int64_t* indices,
                     int64_t* out_perm) {
  std::vector<int64_t> degree(n), starts(n), order(n), queue, nbrs;
  for (int64_t i = 0; i < n; ++i) {
    degree[i] = indptr[i + 1] - indptr[i];
    starts[i] = i;
  }
  std::stable_sort(starts.begin(), starts.end(),
                   [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
  std::vector<char> visited(n, 0);
  int64_t pos = 0;
  queue.reserve(n);
  for (int64_t si = 0; si < n; ++si) {
    int64_t start = starts[si];
    if (visited[start]) continue;
    queue.clear();
    queue.push_back(start);
    visited[start] = 1;
    for (size_t head = 0; head < queue.size(); ++head) {
      int64_t node = queue[head];
      order[pos++] = node;
      nbrs.clear();
      for (int64_t p = indptr[node]; p < indptr[node + 1]; ++p) {
        int64_t x = indices[p];
        if (!visited[x] && x != node) nbrs.push_back(x);
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (int64_t x : nbrs) {
        visited[x] = 1;
        queue.push_back(x);
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) out_perm[i] = order[n - 1 - i];
  return 0;
}

// ---------------------------------------------------------------------------
// Relaxed fundamental-supernode partition of a Cholesky factor pattern
// (CSC, diagonal first per column, below-diagonal rows sorted ascending).
// Matches runtime/symbolic.supernodes: columns j-1 and j merge when j is
// j-1's etree parent and the symmetric difference of their below-diagonal
// structures (j excluded from j-1's) fits the remaining per-supernode
// `relax` budget. Returns the number of supernodes.
// ---------------------------------------------------------------------------
int64_t supernodes_relaxed(int64_t n, const int64_t* col_ptr,
                           const int64_t* row_idx, const int64_t* parent,
                           int64_t relax, int64_t* out_sid) {
  if (n == 0) return 0;
  int64_t sid = 0, budget = relax;
  out_sid[0] = 0;
  for (int64_t j = 1; j < n; ++j) {
    bool mergeable = parent[j - 1] == j;
    if (mergeable) {
      // two-pointer symmetric-difference count over the sorted row lists,
      // skipping j in the previous column's list
      const int64_t* pa = row_idx + col_ptr[j - 1] + 1;  // skip diagonal
      const int64_t* ea = row_idx + col_ptr[j];
      const int64_t* pb = row_idx + col_ptr[j] + 1;
      const int64_t* eb = row_idx + col_ptr[j + 1];
      int64_t diff = 0;
      while (pa < ea || pb < eb) {
        if (pa < ea && *pa == j) { ++pa; continue; }
        if (pa == ea) { ++diff; ++pb; }
        else if (pb == eb) { ++diff; ++pa; }
        else if (*pa == *pb) { ++pa; ++pb; }
        else if (*pa < *pb) { ++diff; ++pa; }
        else { ++diff; ++pb; }
      }
      if (diff > budget) mergeable = false;
      else budget -= diff;
    }
    if (!mergeable) {
      ++sid;
      budget = relax;
    }
    out_sid[j] = sid;
  }
  return sid + 1;
}

// ---------------------------------------------------------------------------
// Relaxed-amalgamation pattern expansion: every column of a supernode takes
// the union below-row structure of its panel (plus its in-panel tail), so
// the fundamental property holds by construction. Two-phase:
//   count_only=1: fill out_col_counts[j] with the expanded column lengths.
//   count_only=0: out_col_counts holds the exclusive prefix (new col_ptr);
//                 rows written sorted ascending per column into out_rows.
// Returns total expanded nnz.
// ---------------------------------------------------------------------------
int64_t expand_pattern(int64_t nsn, const int64_t* col_ptr,
                       const int64_t* row_idx, const int64_t* c0,
                       const int64_t* c1, int64_t count_only,
                       int64_t* out_col_counts, int64_t* out_rows) {
  int64_t total = 0;
  std::vector<int64_t> u;
  for (int64_t s = 0; s < nsn; ++s) {
    int64_t lo = c0[s], hi = c1[s];
    u.assign(row_idx + col_ptr[lo], row_idx + col_ptr[hi]);
    std::sort(u.begin(), u.end());
    u.erase(std::unique(u.begin(), u.end()), u.end());
    // below_u = union rows >= hi
    const int64_t* bu =
        std::lower_bound(u.data(), u.data() + u.size(), hi);
    int64_t m = (u.data() + u.size()) - bu;
    for (int64_t j = lo; j < hi; ++j) {
      int64_t len = (hi - j) + m;
      total += len;
      if (count_only) {
        out_col_counts[j] = len;
      } else {
        int64_t w = out_col_counts[j];
        for (int64_t t = j; t < hi; ++t) out_rows[w++] = t;
        for (int64_t t = 0; t < m; ++t) out_rows[w++] = bu[t];
      }
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Nested-dissection ordering by recursive BFS (level-structure) bisection.
// For each sub-component: find a pseudo-peripheral root (two BFS passes),
// split its BFS level structure at the median vertex, take that level as
// the separator, recurse on the two halves, and eliminate the separator
// LAST. Grid-like patterns get balanced separators and O(n log n)-ish fill,
// where profile orderings (RCM) stop helping. Deterministic; mirrored by
// the Python fallback in runtime/symbolic.py. `leaf` bounds recursion.
// ---------------------------------------------------------------------------
static void nd_bfs(const int64_t* indptr, const int64_t* indices,
                   const std::vector<int64_t>& verts,
                   const std::vector<int64_t>& stamp_in, int64_t stamp,
                   int64_t root, std::vector<int64_t>& level,
                   std::vector<int64_t>& bfs_order) {
  // level[] is indexed by global vertex id; -1 marks unreached this pass.
  bfs_order.clear();
  for (int64_t v : verts) level[v] = -1;
  level[root] = 0;
  bfs_order.push_back(root);
  for (size_t head = 0; head < bfs_order.size(); ++head) {
    int64_t u = bfs_order[head];
    for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
      int64_t x = indices[p];
      if (x == u || stamp_in[x] != stamp || level[x] != -1) continue;
      level[x] = level[u] + 1;
      bfs_order.push_back(x);
    }
  }
}

int64_t nd_ordering(int64_t n, const int64_t* indptr, const int64_t* indices,
                    int64_t leaf, int64_t* out_perm) {
  std::vector<int64_t> stamp(n, -1), level(n, -1);
  std::vector<int64_t> bfs_order;
  int64_t pos = 0;
  // Work stack of (vertex list, phase). phase 0 = split, phase 1 = emit
  // the separator stored alongside.
  struct Task {
    std::vector<int64_t> verts;
    bool emit;  // emit verts directly (separator / leaf)
  };
  std::vector<Task> stack;
  // Seed: connected components in ascending-vertex order.
  {
    std::vector<int64_t> comp_stamp(n, -1);
    std::vector<Task> comps;
    for (int64_t v0 = 0; v0 < n; ++v0) {
      if (comp_stamp[v0] != -1) continue;
      Task t;
      t.emit = false;
      t.verts.push_back(v0);
      comp_stamp[v0] = 0;
      for (size_t head = 0; head < t.verts.size(); ++head) {
        int64_t u = t.verts[head];
        for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
          int64_t x = indices[p];
          if (x != u && comp_stamp[x] == -1) {
            comp_stamp[x] = 0;
            t.verts.push_back(x);
          }
        }
      }
      std::sort(t.verts.begin(), t.verts.end());
      comps.push_back(std::move(t));
    }
    // Components processed in order ⇒ push reversed on the stack.
    for (auto it = comps.rbegin(); it != comps.rend(); ++it)
      stack.push_back(std::move(*it));
  }
  int64_t stamp_id = 0;
  while (!stack.empty()) {
    Task t = std::move(stack.back());
    stack.pop_back();
    if (t.emit || (int64_t)t.verts.size() <= leaf) {
      for (int64_t v : t.verts) out_perm[pos++] = v;
      continue;
    }
    ++stamp_id;
    for (int64_t v : t.verts) stamp[v] = stamp_id;
    // pseudo-peripheral root: BFS from the smallest vertex, re-root at the
    // last vertex reached, BFS again.
    nd_bfs(indptr, indices, t.verts, stamp, stamp_id, t.verts[0], level,
           bfs_order);
    int64_t root = bfs_order.back();
    nd_bfs(indptr, indices, t.verts, stamp, stamp_id, root, level, bfs_order);
    if (bfs_order.size() != t.verts.size() || level[bfs_order.back()] == 0) {
      // disconnected remainder (shouldn't happen) or single level: no split
      std::sort(t.verts.begin(), t.verts.end());
      for (int64_t v : t.verts) out_perm[pos++] = v;
      continue;
    }
    // median split level: the level containing the |V|/2-th BFS vertex
    int64_t mid_level = level[bfs_order[bfs_order.size() / 2]];
    int64_t max_level = level[bfs_order.back()];
    if (mid_level == 0) mid_level = 1;
    if (mid_level == max_level) mid_level = max_level - 1;
    Task a, b, s;
    a.emit = false;
    b.emit = false;
    s.emit = true;
    for (int64_t v : t.verts) {
      if (level[v] < mid_level) a.verts.push_back(v);
      else if (level[v] > mid_level) b.verts.push_back(v);
      else s.verts.push_back(v);
    }
    std::sort(a.verts.begin(), a.verts.end());
    std::sort(b.verts.begin(), b.verts.end());
    std::sort(s.verts.begin(), s.verts.end());
    // order: A, B, then separator — push in reverse
    stack.push_back(std::move(s));
    stack.push_back(std::move(b));
    stack.push_back(std::move(a));
  }
  return pos;
}

}  // extern "C"

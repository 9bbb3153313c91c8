"""GAP's ``kron`` graph (Beamer, Asanović, Patterson, arXiv:1508.03619) as the
operator of GAP's PageRank product, ``y = P·x`` with ``P = A·D⁻¹``.

The graph is the Graph500 Kronecker generator's (``kronecker_generator.m``
of the Graph500 reference code): ``edge_factor · 2^scale`` edges, each
placed by ``scale`` independent quadrant draws with the initiator A, B, C
(D = 1 - A - B - C), and the vertex ids permuted by one random permutation.
GAP makes it undirected: every edge is stored in both directions, and
self-loops and duplicate edges are dropped. Row ``i`` of ``P`` holds
``1 / deg(j)`` for each neighbour ``j`` of ``i`` (GAP's pull-direction
``pr.cc``: ``y_i = Σ_{j ∈ in(i)} x_j / out_degree(j)``; the two degrees
agree on an undirected graph), columns ascending; rows of isolated
vertices are empty.

This is the benchmark's input generator. It runs with torch on the device
it is given: the card at scale 25, the CPU at the tests' small scales, the
same code. The graph's seed is the configuration's ``graph_seed``, so every
run sees the same operator on a given device; only the operand comes from
a run's seed. The CSR triple comes back to the host, where the program
takes it through ``CSR.from_host`` and the reference
(:mod:`portbench.reference.graph`) takes the edge list, never the values.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import costs

# Edges drawn at once (the draws of one chunk are 2·scale float32 vectors
# of this length, in turn).
EDGE_CHUNK = 1 << 26
# Vertices placed at once when the values are gathered.
ENTRY_CHUNK = 1 << 27
# Largest scale generated on the CPU (≈ 33M arcs, a few GB): the card
# generates the benchmark's scale, the CPU the tests' small ones.
CPU_MAX_SCALE = 20


def _draw(gen, m: int, scale: int, a: float, b: float, c: float,
          device) -> tuple:
    """Source and target ids of ``m`` edges, by the Graph500 recursion
    (one quadrant a bit, the most significant bit last), int64."""
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(
            ii, c_norm, a_norm)
        src += ii.long() << bit
        dst += jj.long() << bit
    return src, dst


def arcs(config: dict, device) -> torch.Tensor:
    """The undirected graph's arcs as sorted distinct int64 keys
    ``row · 2^scale + col`` (both directions of each edge, no self-loop),
    on ``device``."""
    scale, ef = int(config["scale"]), int(config["edge_factor"])
    a, b, c = (float(v) for v in config["initiator"])
    n, m = 1 << scale, ef << scale
    device = torch.device(device)
    if device.type == "cpu" and scale > CPU_MAX_SCALE:
        raise ValueError(f"kron: scale {scale} is generated on a card; the "
                         f"CPU takes scale {CPU_MAX_SCALE} at most")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["graph_seed"]))
    perm = torch.randperm(n, generator=gen, device=device)
    keys = torch.empty(2 * m, dtype=torch.int64, device=device)
    used = 0
    for e0 in range(0, m, EDGE_CHUNK):
        src, dst = _draw(gen, min(EDGE_CHUNK, m - e0), scale, a, b, c,
                         device)
        src, dst = perm[src], perm[dst]
        keep = src != dst
        src, dst = src[keep], dst[keep]
        k = int(src.numel())
        keys[used: used + k] = (src << scale) | dst
        keys[used + k: used + 2 * k] = (dst << scale) | src
        used += 2 * k
        del src, dst, keep
    return torch.unique(keys[:used], sorted=True)


def csr(config: dict, device) -> tuple:
    """(indptr int32 (n+1,), indices int32 (nnz,), values float32 (nnz,))
    of ``P`` on the host, built on ``device``: ``values[e] = 1 / deg(col)``
    with the reciprocal taken in float64 and rounded once to float32."""
    scale = int(config["scale"])
    n = 1 << scale
    keys = arcs(config, device)
    nnz = int(keys.numel())
    if nnz >= 1 << 31:
        raise ValueError(f"kron scale {scale}: {nnz} arcs do not fit an "
                         f"int32 row pointer")
    starts = torch.arange(n + 1, dtype=torch.int64,
                          device=keys.device) << scale
    indptr = torch.searchsorted(keys, starts)
    deg = indptr[1:] - indptr[:-1]
    recip = (1.0 / deg.clamp(min=1).to(torch.float64)).to(torch.float32)
    indices = torch.empty(nnz, dtype=torch.int32, device=keys.device)
    values = torch.empty(nnz, dtype=torch.float32, device=keys.device)
    mask = n - 1
    for e0 in range(0, nnz, ENTRY_CHUNK):
        col = keys[e0: e0 + ENTRY_CHUNK] & mask
        indices[e0: e0 + ENTRY_CHUNK] = col.to(torch.int32)
        values[e0: e0 + ENTRY_CHUNK] = recip[col]
        del col
    del keys
    return (indptr.to(torch.int32).cpu().numpy(), indices.cpu().numpy(),
            values.cpu().numpy())


def spmv_cost(indptr: np.ndarray) -> dict:
    """``costs.spmm(n, indices, values, 1)`` of ``P`` from its row pointer
    alone, in O(n) in place of a pass over every entry: every value
    (1 / deg) is nonzero and the pattern is symmetric, so the distinct
    columns are the non-empty rows. ``costs.spmm`` of one entry in each of
    those columns, plus the cost of each further entry in a column already
    held (the difference one more such entry makes)."""
    deg = np.diff(indptr.astype(np.int64))
    n, nnz = deg.size, int(deg.sum())
    held = np.flatnonzero(deg).astype(np.int32)
    one = np.ones(held.size + 1, dtype=np.float32)
    base = costs.spmm(n, held, one[:-1], 1)
    more = costs.spmm(n, np.append(held, held[:1]), one, 1)
    extra = nnz - held.size
    return {k: base[k] + extra * (more[k] - base[k]) for k in base}


def stats(indptr: np.ndarray, width: int = 16) -> dict:
    """The skew of a graph's rows: count, stored entries, the largest
    degree, the share of empty rows, the median and 99th percentile degree,
    the ELL overhead (rows · longest row / entries) and the slots a cut
    into pieces of at most ``width`` needs per entry."""
    deg = np.diff(indptr.astype(np.int64))
    nnz = int(deg.sum())
    return {"rows": int(deg.size), "stored": nnz, "max_degree": int(deg.max()),
            "empty_share": float(np.mean(deg == 0)),
            "degree_p50": float(np.percentile(deg, 50)),
            "degree_p99": float(np.percentile(deg, 99)),
            "ell_overhead": deg.size * int(deg.max()) / max(nnz, 1),
            "slots_per_entry": width * int(((deg + width - 1)
                                            // width).sum()) / max(nnz, 1)}

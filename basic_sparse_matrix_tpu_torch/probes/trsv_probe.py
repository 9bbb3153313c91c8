"""K7 probe: what the triangular solve's level step costs on the card as
one launch a wide level and as one block walking a run of narrow levels,
beside its plain version (four operations a level) and its bound.

K7 (``csrc/trsv_level.cu``, through ``models/sparse_triangular.py``) runs
a level-scheduled solve as a plan of launches: a run of consecutive narrow
levels on one block, every other level a launch on many blocks.
:func:`sweep` times synthetic levels of r rows with m entries a row both
ways, per level, inside a CUDA graph (the way the solves run).
:func:`plan_sweep` (``--plans``) times the benchmark's whole solves under
candidate narrow limits: the measurement behind the plan's two limits
(``NARROW_ROWS``, ``NARROW_ENTRIES``), which decide by the whole solve and
not by a level alone (a run fragmented by wide levels pays its start-up
again each time).

:func:`hpcg_rows` times K7 where the benchmark's cells run it: the median
level of IC(0) at HPCG's 104³ grid (a wide launch), the dataflow chain of
its forward solve (one launch for ~710 wide levels) and the longest narrow
run of the nested-dissection supernodal factor at 32³, and each whole
forward solve, beside the plain version captured the same way and the
bound (every byte read or written once at 3.35 TB/s: the values, int32
columns and gathered unknowns of each entry; the row pointer, reciprocal
diagonal, read and written unknown of each row). Device times are CUDA
events around graph replays (median of ``ITERS``); a single level is
captured ``REPEAT`` times in its graph and the time divided.

``--dataflow`` times the dataflow chains (:func:`chain_rows`) of IC(0) at
104³, of D+L and D+U on each of HPCG's multigrid grids (104³ to 13³) and
of the 32³ nested-dissection factor against the same levels launched one a
level, µs a level, with the two results compared bit for bit;
(:func:`crossover`) the first m levels of a chain both ways, the
measurement behind ``DATAFLOW_MIN_LEVELS``; and (:func:`lookahead_sweep`)
a chain on more or fewer warps, the measurement behind
``DATAFLOW_LOOKAHEAD``.

Usage (a machine with a CUDA GPU and nvcc; ≈ 1 minute of host set-up at
104³ and 32³):
    python -m basic_sparse_matrix_tpu_torch.probes.trsv_probe [--plans]
    python -m basic_sparse_matrix_tpu_torch.probes.trsv_probe --sweep-only
    python -m basic_sparse_matrix_tpu_torch.probes.trsv_probe --dataflow
Every line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import time

import numpy as np
import torch

from ..models import sparse_triangular as st

ITERS = 20
REPEAT = 50
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def leveled(sizes, deps, seed, device="cpu"):
    """A lower-triangular CSR whose level sets have the given sizes, rows
    numbered level by level: each row of level l > 0 depends on one row of
    level l - 1 and on up to ``deps - 1`` more rows of earlier levels.
    Repeated picks are summed into one entry. Diagonally dominant
    (|diag| ≥ 1 + Σ|off|)."""
    from ..ops.csr import CSR

    rng = np.random.default_rng(seed)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows, cols = [], []
    for lv in range(1, len(sizes)):
        s0, s1 = starts[lv], starts[lv + 1]
        level = np.arange(s0, s1)
        more = min(deps - 1, s0)
        rows += [level, np.repeat(level, more)]
        cols += [rng.integers(starts[lv - 1], s0, s1 - s0),
                 rng.integers(0, s0, (s1 - s0) * more)]
    n = int(starts[-1])
    r = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    c = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    v = rng.standard_normal(r.size)
    diag = 1.0 + np.bincount(r, np.abs(v), minlength=n)
    diag *= rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return CSR.from_coo_arrays(
        (n, n), np.concatenate([r, np.arange(n)]),
        np.concatenate([c, np.arange(n)]),
        np.concatenate([v, diag]).astype(np.float32), device=device)


def hpcg27(k: int, device="cpu"):
    """HPCG's 27-point operator on a k³ grid (diagonal 26, every neighbour
    -1), rows x + k·(y + k·z), columns ascending, built as CSR arrays."""
    from ..ops.csr import CSR

    n = k ** 3
    z, y, x = np.unravel_index(np.arange(n), (k, k, k))
    cols, live = [], []
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        live.append((z + dz >= 0) & (z + dz < k) & (y + dy >= 0)
                    & (y + dy < k) & (x + dx >= 0) & (x + dx < k))
        cols.append(np.arange(n) + dx + k * (dy + k * dz))
    live, cols = np.stack(live, 1), np.stack(cols, 1)
    indptr = np.concatenate([[0], np.cumsum(live.sum(1))])
    indices = cols[live]
    rows = np.repeat(np.arange(n), live.sum(1))
    values = np.where(indices == rows, 26.0, -1.0).astype(np.float32)
    return CSR.from_host(indptr.astype(np.int32), indices.astype(np.int32),
                         values, (n, n), device=device)


def graph_ms(fn, repeat: int = 1) -> float:
    """Device milliseconds of one ``fn()``: ``repeat`` calls captured in
    one CUDA graph, the median of ``ITERS`` replays between CUDA events,
    divided by ``repeat``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeat):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / repeat


def with_plan(sched, plan):
    return dataclasses.replace(sched, plan=np.asarray(plan, np.int32))


def wide_blocks(sched, lv: int) -> int:
    """The blocks level ``lv`` takes as a wide launch."""
    return int(st.wide_blocks(np.diff(sched.row_ptr[lv:lv + 2]),
                              np.diff(sched.ent_ptr[lv:lv + 2]))[0])


def k7(sched, y):
    return lambda: st._levels_cuda(sched, y, sched.vals, sched.inv_diag)


def plain(sched, y):
    return lambda: st._levels_plain(sched, y, sched.vals, sched.inv_diag)


def level_bytes(sched, lv0: int, lv1: int) -> int:
    rows = sched.row_ptr[lv1] - sched.row_ptr[lv0]
    ents = sched.ent_ptr[lv1] - sched.ent_ptr[lv0]
    return 12 * ents + 16 * rows


def sub_schedule(sched, lv0: int, lv1: int):
    """Levels [lv0, lv1) alone: the plain loop over a schedule that keeps
    every table and sees only those levels."""
    return dataclasses.replace(
        sched, row_ptr=sched.row_ptr[lv0:lv1 + 1],
        ent_ptr=sched.ent_ptr[lv0:lv1 + 1])


# A first level this large makes the system too large for a run to hold
# in shared memory.
LARGE = 40000


def sweep(device, levels: int = 64) -> list:
    """Per-level device µs of a run and of wide launches, for levels of r
    rows with m entries a row, in a system that a run holds in shared
    memory and, ``large``, in one that it does not (the first level, which
    the others read, is not timed)."""
    out = []
    shapes = [(r, 13) for r in (1, 8, 32, 64, 128, 256, 384, 512, 1024,
                                2048)]
    shapes += [(1, m) for m in (1, 256, 1024, 4096, 8192, 12288)]
    shapes += [(8, 512), (32, 256), (64, 192)]
    shapes = [(r, m, False) for r, m in shapes] + [
        (r, m, True) for r, m in ((1, 1), (1, 13), (1, 4096), (64, 13),
                                  (128, 13), (256, 13), (512, 13))]
    for r, m, large in shapes:
        base = LARGE if large else max(2 * m, 4096)
        sched = st.build_schedule(leveled([base] + [r] * levels, m, seed=r,
                                          device=device))
        y = torch.ones(sched.n, device=device)
        run = with_plan(sched, [[1, levels + 1, 0]])
        wide = with_plan(sched, [[lv, lv + 1, wide_blocks(sched, lv)]
                                 for lv in range(1, levels + 1)])
        t_run = graph_ms(k7(run, y)) * 1e3 / levels
        t_wide = graph_ms(k7(wide, y)) * 1e3 / levels
        ents = (sched.ent_ptr[-1] - sched.ent_ptr[1]) / levels
        out.append({"metric": "trsv_level_us", "rows": r,
                    "entries": round(ents), "n": sched.n, "run_us": t_run,
                    "wide_us": t_wide, "narrow": t_run < t_wide})
        print(json.dumps(out[-1]), flush=True)
    return out


def _row(name, sched, lv0, lv1, kern_ms, plain_ms, **extra) -> dict:
    nbytes = level_bytes(sched, lv0, lv1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"metric": "trsv_kernel", "case": name, "levels": lv1 - lv0,
           "rows": sched.row_ptr[lv1] - sched.row_ptr[lv0],
           "entries": sched.ent_ptr[lv1] - sched.ent_ptr[lv0],
           "kernel_ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "bytes": nbytes, **extra}
    print(json.dumps(row), flush=True)
    return row


def _check(name, sched, device):
    """K7 against the plain loop on one seeded right-hand side."""
    b = torch.randn(sched.n, generator=torch.Generator(device=device)
                    .manual_seed(5), device=device)
    got, want = b.clone(), b.clone()
    k7(sched, got)()
    plain(sched, want)()
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name}: K7 vs plain {err:.3e} of max")
    return err


def hpcg_schedules(device) -> dict:
    """The forward and backward schedules of IC(0) of HPCG's operator at
    104³ and of its nested-dissection supernodal factor at 32³."""
    from ..models import pcg
    from ..models.solve import DirectSolver
    from ..utils import config

    t0 = time.perf_counter()
    setup = pcg.PCGSetup.build(hpcg27(104, device))
    out = {"104³ IC(0)": (setup.fwd, setup.bwd)}
    old = config.get_config()
    config.set_config(dataclasses.replace(old, ordering="nd"))
    try:
        solver = DirectSolver(hpcg27(32, device))
    finally:
        config.set_config(old)
    out["32³ ND factor"] = (solver._fwd, solver._bwd)
    print(json.dumps({"metric": "trsv_set_up_s",
                      "value": time.perf_counter() - t0}), flush=True)
    return out


def hpcg_rows(device, scheds=None) -> list:
    """K7 at the benchmark's shapes (module docstring)."""
    scheds = scheds or hpcg_schedules(device)
    rows = []
    ic0 = scheds["104³ IC(0)"][0]
    counts = np.diff(ic0.row_ptr)
    lv = int(np.argsort(counts, kind="stable")[counts.size // 2])
    one = with_plan(ic0, [[lv, lv + 1, wide_blocks(ic0, lv)]])
    y = torch.ones(ic0.n, device=device)
    rows.append(_row(
        "104³ IC(0), median level", ic0, lv, lv + 1,
        graph_ms(k7(one, y), REPEAT),
        graph_ms(plain(sub_schedule(ic0, lv, lv + 1), y), REPEAT)))
    lv0, lv1 = (int(v) for v in longest_chain(ic0)[:2])
    rows.append(_row(
        "104³ IC(0), forward chain", ic0, lv0, lv1,
        graph_ms(k7(with_plan(ic0, [[lv0, lv1, chain_blocks(ic0, lv0,
                                                             lv1)]]), y)),
        graph_ms(plain(sub_schedule(ic0, lv0, lv1), y))))
    fwd = scheds["32³ ND factor"][0]
    runs = [p for p in fwd.plan if p[2] == 0]
    lv0, lv1, _ = max(runs, key=lambda p: p[1] - p[0])
    y = torch.ones(fwd.n, device=device)
    rows.append(_row(
        "32³ ND factor, longest narrow run", fwd, int(lv0), int(lv1),
        graph_ms(k7(with_plan(fwd, [[lv0, lv1, 0]]), y)),
        graph_ms(plain(sub_schedule(fwd, int(lv0), int(lv1)), y))))
    for name, pair in scheds.items():
        for way, sched in zip(("forward", "backward"), pair):
            y = torch.ones(sched.n, device=device)
            plan = sched.plan
            rows.append(_row(
                f"{name}, {way} solve", sched, 0, sched.n_levels,
                graph_ms(k7(sched, y)), graph_ms(plain(sched, y)),
                launches=len(plan), runs=int((plan[:, 2] == 0).sum()),
                run_levels=int((plan[:, 1] - plan[:, 0])[plan[:, 2] == 0]
                               .sum()),
                max_abs_err_of_max=_check(name, sched, device)))
    return rows


# Candidate narrow limits of plan_sweep: (rows, entries).
RULES = [(r, 12288) for r in (1, 2, 3, 4, 6, 8, 32, 256)] + [
    (4, e) for e in (2048, 4096, 6016, 24576)]


def plan_sweep(device, scheds) -> list:
    """Each whole solve under each candidate pair of narrow limits, device
    ms: the measurement behind NARROW_ROWS and NARROW_ENTRIES."""
    out = []
    for r, e in RULES:
        row = {"metric": "trsv_plan_ms", "narrow_rows": r,
               "narrow_entries": e}
        for name, pair in scheds.items():
            for way, sched in zip(("fwd", "bwd"), pair):
                rows = np.diff(sched.row_ptr)
                ents = np.diff(sched.ent_ptr)
                narrow = (rows <= r) & (ents <= e)
                plan = st.plan_of(rows, ents, narrow)
                y = torch.ones(sched.n, device=device)
                row[f"{name} {way}"] = graph_ms(k7(with_plan(sched, plan),
                                                   y))
                row[f"{name} {way} launches"] = len(plan)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


# HPCG's multigrid grids (models/multigrid.py; portbench's hpcg-104-mg).
MG_GRIDS = (104, 52, 26, 13)


def mg_schedules(device) -> dict:
    """The schedules of D+L and D+U of HPCG's operator on each multigrid
    grid: the V-cycle's forward and backward sweeps."""
    out = {}
    for k in MG_GRIDS:
        a = hpcg27(k, device)
        out[f"{k}³ D+L, D+U"] = (
            st.build_schedule(a.triangle(lower=True)),
            st.build_schedule(a.triangle(lower=False), lower=False))
    return out


def longest_chain(sched):
    """The plan row of the schedule's longest dataflow chain, or None."""
    chains = [p for p in sched.plan if p[2] < 0]
    return max(chains, key=lambda p: p[1] - p[0]) if chains else None


def chain_blocks(sched, lv0: int, lv1: int, lookahead=None) -> int:
    """The plan's blocks entry (negative) of a chain of levels [lv0, lv1),
    with warps for ``lookahead`` mean levels (the plan's by default)."""
    units = sched.units.cpu().numpy()
    need, levels = units[lv1] - units[lv0], lv1 - lv0
    if lookahead is None:
        return -int(st.chain_blocks(need, levels))
    return -max(1, -(-int(-(-lookahead * need // levels)) // st.CHAIN_WARPS))


def each_level(sched):
    """The schedule with every chain launched one level at a time."""
    return with_plan(sched, st.level_by_level(sched))


def chain_rows(device, scheds) -> list:
    """Each schedule's dataflow chains against the same levels as wide
    launches: the whole solve both ways, the chains alone both ways (µs a
    chain level), and a seeded solve both ways compared bit for bit; where
    every level's rows fit a chain, also the whole solve as one chain (the
    narrow runs joined to it)."""
    out = []
    for name, pair in scheds.items():
        for way, sched in zip(("forward", "backward"), pair):
            plan = sched.plan
            chains = plan[plan[:, 2] < 0]
            row = {"metric": "trsv_chain", "case": f"{name}, {way}",
                   "levels": sched.n_levels, "launches": len(plan),
                   "chains": len(chains),
                   "chain_levels": int((chains[:, 1] - chains[:, 0]).sum())}
            if len(chains):
                b = torch.randn(sched.n, generator=torch.Generator(
                    device=device).manual_seed(5), device=device)
                got, want = b.clone(), b.clone()
                k7(sched, got)()
                k7(each_level(sched), want)()
                only = with_plan(sched, chains)
                y = torch.ones(sched.n, device=device)
                t_only = graph_ms(k7(only, y))
                t_each = graph_ms(k7(each_level(only), y))
                row.update(
                    bit_equal=bool(torch.equal(got, want)),
                    solve_ms=graph_ms(k7(sched, y)),
                    solve_each_ms=graph_ms(k7(each_level(sched), y)),
                    chain_ms=t_only, each_ms=t_each,
                    chain_us_a_level=t_only * 1e3 / row["chain_levels"],
                    each_us_a_level=t_each * 1e3 / row["chain_levels"])
                if (st.wide_team(np.diff(sched.row_ptr), np.diff(
                        sched.ent_ptr)) <= st.DATAFLOW_TEAM).all():
                    # the narrow runs joined to the chain: every level one
                    whole = with_plan(sched, [[0, sched.n_levels,
                                               chain_blocks(sched, 0,
                                                            sched.n_levels)]])
                    one = b.clone()
                    k7(whole, one)()
                    row.update(one_chain_ms=graph_ms(k7(whole, y)),
                               one_chain_bit_equal=bool(torch.equal(one,
                                                                    want)))
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


# Chain lengths of crossover.
LENGTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def crossover(device, scheds) -> list:
    """The first m levels of each forward solve's longest chain as one
    chain and as m wide launches, device µs a level (``256 // m`` copies
    captured in a graph): the least m at which the chain wins sets
    ``DATAFLOW_MIN_LEVELS``."""
    out = []
    for name, pair in scheds.items():
        sched = pair[0]
        best = longest_chain(sched)
        if best is None:
            continue
        lv0, lv1, _ = (int(v) for v in best)
        y = torch.ones(sched.n, device=device)
        for m in LENGTHS:
            if m > lv1 - lv0:
                break
            chain = with_plan(sched, [[lv0, lv0 + m,
                                       chain_blocks(sched, lv0, lv0 + m)]])
            reps = max(1, 256 // m)
            t_chain = graph_ms(k7(chain, y), reps) * 1e3 / m
            t_each = graph_ms(k7(each_level(chain), y), reps) * 1e3 / m
            row = {"metric": "trsv_chain_crossover", "case": name,
                   "levels": m, "rows": sched.row_ptr[lv0 + m]
                   - sched.row_ptr[lv0], "chain_us_a_level": t_chain,
                   "each_us_a_level": t_each, "chain_wins": t_chain < t_each}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


# Lookaheads of lookahead_sweep, in mean levels of warp-units.
LOOKAHEADS = (1, 2, 3, 4, 5, 6, 8, 12, 16)


def lookahead_sweep(device, scheds) -> list:
    """Each forward solve's longest chain on warps enough for ``L`` mean
    levels of its units (capped by what the card holds), device µs a
    level: the measurement behind ``DATAFLOW_LOOKAHEAD``."""
    out = []
    for name, pair in scheds.items():
        sched = pair[0]
        best = longest_chain(sched)
        if best is None:
            continue
        lv0, lv1, _ = (int(v) for v in best)
        y = torch.ones(sched.n, device=device)
        for look in LOOKAHEADS:
            blocks = chain_blocks(sched, lv0, lv1, look)
            t = graph_ms(k7(with_plan(sched, [[lv0, lv1, blocks]]), y))
            row = {"metric": "trsv_chain_lookahead", "case": name,
                   "lookahead": look, "blocks": -blocks,
                   "chain_us_a_level": t * 1e3 / (lv1 - lv0)}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main(argv=None) -> None:
    from ..runtime import cuda_kernels

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep-only", action="store_true")
    p.add_argument("--plans", action="store_true",
                   help="also time whole solves under candidate rules")
    p.add_argument("--dataflow", action="store_true",
                   help="only the dataflow chains and their crossover")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the K7 probe needs a CUDA device")
    device = torch.device("cuda")
    cuda_kernels.load()
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "narrow_rows": st.NARROW_ROWS,
                      "narrow_entries": st.NARROW_ENTRIES,
                      "dataflow_min_levels": st.DATAFLOW_MIN_LEVELS}),
          flush=True)
    if args.dataflow:
        scheds = {**hpcg_schedules(device), **mg_schedules(device)}
        chain_rows(device, scheds)
        crossover(device, scheds)
        lookahead_sweep(device, scheds)
        return
    sweep(device)
    if not args.sweep_only:
        scheds = hpcg_schedules(device)
        hpcg_rows(device, scheds)
        if args.plans:
            plan_sweep(device, scheds)


if __name__ == "__main__":
    main()

"""Add-back probe: what a level's add-back step costs on the card, as the
rect entry that reads the merged rects where they lie and as the one
PyTorch call for the same function.

The supernodal factorization (``models/supernodal.py``) ends every level's
update with ``lvals[tcp[s, w] + r - w] -= p[s, r, w]`` over the level's
merged rects ``p``. Two formulations of that step are timed on the same
operands, each held to the other:

* ``rects``: ``addback_rects``, one launch of the rect entry (what the
  ``"rects"`` route runs on a CUDA tensor);
* ``index_add``: the masked ``index_add_`` of ``supernodal_scatter="delta"``
  with its positions built, the one PyTorch call for the same function.

The operands are the real target tables of every level that the 33³
Laplacian's schedule (``ordering="nd"``) routes to the add-back
(``"rects"``), with seeded values on each panel's live trapezoid. Two times
per formulation, both CUDA events: ``call`` at the host's pace (what the
level loop pays: wrapper, launches and device work) and ``device`` with the
launches queued behind a spin kernel (device work only). The span entry
alone is timed at the sheared operands the JAX package would build for the
largest group it sends to K4 and the largest it sends to K5, and at the
three K4 class shapes with every slot live (``launch_floor_device_ms`` is
the same event pair around a one-element fill, the least any launch reads),
and beside the span entry of another build of ``addback.cu`` when
``--span-source`` names one (for example an earlier commit's file). ``--numeric N`` times
``factorize_supernodal`` (the solver's ``timings["numeric"]``) N more times
on the same schedule, synchronised; with ``--skip-levels`` nothing else
runs, and the file then works inside an earlier commit's package too (copy
it into that tree's ``probes/``), which is how two commits' numeric times
are taken on one card in turns.

Usage (a machine with a CUDA GPU and nvcc):
    python -m basic_sparse_matrix_tpu_torch.probes.addback_probe
    python -m basic_sparse_matrix_tpu_torch.probes.addback_probe \\
        --span-source /path/to/other/addback.cu --numeric 3

Every line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..models import supernodal as sn
from ..ops.pallas import addback_resident as k4
from ..runtime.timing import cuda_time_ms
from .entry_fma_probe import device_time_ms

GRID_K = 33
# |d| <= TOL * max(1, max|ref|): the atomics add in another order
TOL = 1e-5


def laplacian_3d(k: int):
    """The 7-point Laplacian on a k×k×k grid as COO arrays (n = k³)."""
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def analyze(k: int):
    """The k³ Laplacian, ND-ordered on the default device, and its
    supernodal schedule, as ``prepare_direct`` builds them under
    ``ordering="nd"``; returns (a, sched)."""
    from .. import CSR
    from ..ops import reorder
    from ..utils.config import get_config

    n, r, c, v = laplacian_3d(k)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    a = reorder.permute_symmetric(a, reorder.nd_permutation(a))
    return a, sn.analyze_supernodal(a, relax=get_config().supernodal_relax)


def numeric_seconds(sched, a) -> float:
    """Synchronised host-clock seconds of one ``factorize_supernodal``."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sn.factorize_supernodal(sched, a.values)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def seeded_rects(tcp, tnr, twd, rd: int, gen) -> torch.Tensor:
    """(St, Rd, Wt) standard-normal values on each panel's live trapezoid
    (``w < twd[s]``, ``w <= r < tnr[s]``), zero elsewhere, as a level's
    merged rects are."""
    st, wt = tcp.shape
    rr = torch.arange(rd, device=tcp.device)[None, :, None]
    ww = torch.arange(wt, device=tcp.device)[None, None, :]
    live = (ww < twd[:, None, None]) & (rr >= ww) & (rr < tnr[:, None, None])
    vals = torch.randn((st, rd, wt), generator=gen, device=tcp.device)
    return torch.where(live, vals, 0.0)


def index_add_tail(lvals, p, tcp, tnr, twd, scratch: int):
    """The ``mode="delta"`` tail of ``_delta_scatter``: positions built,
    masked elements parked on ``scratch``, one ``index_add_``."""
    _, rd, wt = p.shape
    rr = torch.arange(rd, device=p.device)[None, :, None]
    ww = torch.arange(wt, device=p.device)[None, None, :]
    mask = ((ww < twd[:, None, None]) & (rr >= ww)
            & (rr < tnr[:, None, None]))
    pos = torch.where(mask, tcp[:, None, :] + rr - ww, scratch)
    return lvals.index_add_(0, pos.reshape(-1), (-p).reshape(-1))


def routed_levels(sched):
    """(group, kind, level, tcp, tnr, twd) of every level the schedule
    routes to the add-back ("rects") under ``auto``; ``kind`` names the
    JAX package's kernel for the group, K4 ("vmem") or K5 ("pallas"), which
    sets the span entry's operand shapes."""
    tab = sn._TABLE_INDEX
    for gi in range(sched.n_groups):
        if sn._group_delta(sched, gi, "auto") != "rects":
            continue
        kind = "vmem" if sched.use_vmem[gi] else "pallas"
        tabs = [sched.tabs[gi][tab[name]].long()
                for name in ("tgt_cp", "tgt_nrows", "tgt_w")]
        for li in range(tabs[0].shape[0]):
            yield (gi, kind, li, *(t[li] for t in tabs))


def close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    err = float((out - ref).abs().max())
    if not err <= TOL * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"{name}: max abs err {err}")
    return err


def measure_levels(sched, lvals, iters: int) -> list:
    """Per routed level: the rect entry held to ``index_add`` and both
    timed at the host's pace; per group the sums and, at level 0, the
    device times."""
    gen = torch.Generator(device=lvals.device).manual_seed(0)
    scratch = sched.nnz_l
    groups = {}
    for gi, kind, li, tcp, tnr, twd in routed_levels(sched):
        rd = sched.delta_rmax[gi]
        p = seeded_rects(tcp, tnr, twd, rd, gen)
        runs = {
            "rects": lambda lv: k4.addback_rects(lv, p, tcp, tnr, twd),
            "index_add": lambda lv: index_add_tail(lv, p, tcp, tnr, twd,
                                                   scratch),
        }
        ref = runs["index_add"](lvals.clone())
        ref[scratch] = 0.0
        err = close(f"group {gi} level {li} rects",
                    runs["rects"](lvals.clone()), ref)
        work = lvals.clone()
        g = groups.setdefault(gi, {
            "group": gi, "kind": kind, "levels": 0,
            "rect_shape": [int(x) for x in p.shape],
            "live_elements": 0, "max_abs_err": 0.0,
            "call_ms": {name: 0.0 for name in runs}, "device_ms": {}})
        g["levels"] += 1
        g["live_elements"] += int((p != 0).sum())
        g["max_abs_err"] = max(g["max_abs_err"], err)
        for name, run in runs.items():
            g["call_ms"][name] += cuda_time_ms(lambda: run(work), warmup=1,
                                               iters=iters)
        if li == 0:
            g["device_ms"] = {name: device_time_ms(lambda: run(work), 20)
                              for name, run in runs.items()}
    return list(groups.values())


def build_span_entry(source: Path, out_dir: Path):
    """``bsm_addback`` of another build of the kernel's source."""
    from ..runtime import cuda_kernels

    so = out_dir / "libaddback_other.so"
    subprocess.run([cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-shared",
                    "-o", str(so), str(source)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).bsm_addback
    # lvals, n, rows, starts[, twd, wt], nslots, len, stream: a source from
    # before the span entry took the panel layout has no twd and wt
    has_twd = "twd" in source.read_text().split("bsm_addback(", 1)[1] \
        .split(")", 1)[0]
    fn.argtypes = cuda_kernels._SIGNATURES["bsm_addback"] if has_twd else [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def measure_spans(sched, lvals, other) -> list:
    """The span entry alone at the sheared operands of the largest group of
    each kind (level 0), beside ``other`` (another build's ``bsm_addback``)
    where given."""
    gen = torch.Generator(device=lvals.device).manual_seed(1)
    best = {}
    for gi, mode, li, tcp, tnr, twd in routed_levels(sched):
        if li == 0 and (mode not in best
                        or tcp.numel() > best[mode][1].numel()):
            best[mode] = (gi, tcp, tnr, twd)
    cases = []
    for mode, (gi, tcp, tnr, twd) in best.items():
        st, wt = tcp.shape
        p = seeded_rects(tcp, tnr, twd, sched.delta_rmax[gi], gen)
        wv = torch.arange(wt, device=tcp.device)[None, :]
        starts = torch.where(wv < twd[:, None], tcp, -1)
        if mode == "vmem":
            cq, col_pad = sched.vmem_shape[gi]
            rows = F.pad(k4.shear_reshape(-p, col_pad).reshape(st * wt, -1),
                         (0, 0, 0, cq - st * wt))
            starts = F.pad(starts.reshape(-1), (0, cq - st * wt), value=-1)
        else:
            col_len = sn._colq(sched.delta_rmax[gi])
            rows = F.pad(k4.shear_reshape(-p, col_len),
                         (0, 1024, 0, sn._pow2(wt) - wt, 0,
                          sn._pow2(st) - st))
            starts = F.pad(starts, (0, sn._pow2(wt) - wt, 0,
                                    sn._pow2(st) - st), value=-1)
            rows = rows.reshape(-1, rows.shape[-1])
            starts = starts.reshape(-1)
        cases.append((mode, gi, rows.contiguous(),
                      starts.to(torch.int32).contiguous()))
    # every slot of a K4 class shape live: runs of random length with at
    # least 128 trailing zeros, laid end to end at whatever alignment falls
    # (what runs past the end of lvals at a small --grid is dropped)
    for col_pad, cq in sn._VMEM_CQ_CAP.items():
        run = torch.randint(1, col_pad - 127, (cq,), generator=gen,
                            device=lvals.device)
        q = torch.arange(col_pad, device=lvals.device)
        rows = torch.where(q[None, :] < run[:, None], torch.randn(
            (cq, col_pad), generator=gen, device=lvals.device), 0.0)
        starts = (torch.cumsum(run, 0) - run).to(torch.int32)
        cases.append((f"all {cq} slots live", None, rows, starts))
    out = []
    for mode, gi, rows, starts in cases:
        ref = k4.addback_spans_reference(lvals.clone(), rows, starts)
        work = lvals.clone()
        rep = {"span_entry": mode, "group": gi,
               "rows_shape": [int(x) for x in rows.shape],
               "live_slots": int((starts >= 0).sum()),
               "nonzero_elements": int((rows != 0).sum()),
               "max_abs_err": close(f"span entry {mode}", k4.addback_spans(
                   lvals.clone(), rows, starts, "probe"), ref)}
        turns = [device_time_ms(lambda: k4.addback_spans(
            work, rows, starts, "probe"), 50) for _ in range(4)]
        rep["device_ms"] = {"median": statistics.median(turns),
                            "min": min(turns), "max": max(turns)}
        if other is not None:
            stream = torch.cuda.current_stream().cuda_stream
            other_tail = (None, 0) if len(other.argtypes) == 9 else ()

            def run_other(dst=work):
                status = other(dst.data_ptr(), dst.numel(), rows.data_ptr(),
                               starts.data_ptr(), *other_tail, rows.shape[0],
                               rows.shape[1], stream)
                if status:
                    raise RuntimeError(f"other build: CUDA error {status}")
            got = lvals.clone()
            run_other(got)
            rep["other_max_abs_err"] = close(f"other span entry {mode}", got,
                                             ref)
            turns = [device_time_ms(run_other, 50) for _ in range(4)]
            rep["other_device_ms"] = {"median": statistics.median(turns),
                                      "min": min(turns), "max": max(turns)}
        out.append(rep)
    return out


def padded_lvals(sched, device) -> torch.Tensor:
    """Seeded factor values with the padding ``factorize_supernodal`` gives
    them under the default configuration."""
    pad = 1 + sn._win_pad(sched)
    gen = torch.Generator(device=device).manual_seed(2)
    out = torch.zeros(sched.nnz_l + pad, device=device)
    out[: sched.nnz_l] = torch.randn(sched.nnz_l, generator=gen,
                                     device=device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=GRID_K,
                    help="k of the k³ Laplacian")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls per level and formulation")
    ap.add_argument("--span-source", type=Path, default=None,
                    help="another addback.cu whose span entry is timed "
                         "beside this tree's")
    ap.add_argument("--numeric", type=int, default=0,
                    help="factorizations to time after the first")
    ap.add_argument("--skip-levels", action="store_true",
                    help="only the factorization times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("addback_probe: no CUDA device; timing needs the "
                         "card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    a, sched = analyze(args.grid)
    print(json.dumps({"device": smi, "n": sched.n, "nnz_l": sched.nnz_l,
                      "groups": sched.n_groups,
                      "first_numeric_s": numeric_seconds(sched, a),
                      "numeric_s": [numeric_seconds(sched, a)
                                    for _ in range(args.numeric)]}),
          flush=True)
    if args.skip_levels:
        return
    lvals = padded_lvals(sched, device)
    one = torch.zeros(1, device=device)
    print(json.dumps({"launch_floor_device_ms": device_time_ms(
        lambda: one.zero_(), 50)}), flush=True)
    reports = measure_levels(sched, lvals, args.iters)
    for rep in reports:
        print(json.dumps(rep), flush=True)
    print(json.dumps({
        "routed_levels": sum(rep["levels"] for rep in reports),
        "sum_call_ms": {name: sum(rep["call_ms"][name] for rep in reports)
                        for name in ("rects", "index_add")}}),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        other = build_span_entry(args.span_source, Path(tmp)) \
            if args.span_source else None
        for rep in measure_spans(sched, lvals, other):
            print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()

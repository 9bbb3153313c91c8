"""Readings from which a cell's limits are set: the program's compared
numbers over many seeds, and the control's (the reference computed in TF32)
on the first few of them, in one process at the cell's own size and load.

    python3 portbench/calibrate.py --workload <cell> [--seeds 12] [--control 3]
        [--first-seed N] [--seconds S] [--out FILE]

The program is set up once; for each seed the inputs are made anew from it,
a window of ``--seconds`` (the benchmark's ``run_seconds`` by default) runs
as in a run, and the answers it keeps are compared with the float64
reference. On the first ``--control`` seeds the control's answers to the
same requests are compared too. Prints one JSON line a seed and a last line
with the lower reading (the largest of the program's) and the upper one (the
smallest of the control's) of each number. The benchmark's own runs never
run this. It needs a card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import manifest  # noqa: E402
from portbench.run import configured, window  # noqa: E402


def readings(bench: dict, cell: dict, seeds, control: int, seconds: float,
             device, *, config: dict = None, traffic: dict = None,
             emit=print) -> dict:
    """Per-seed maxima of the compared numbers, program and control, and
    their lower and upper readings."""
    import torch

    from portbench.entries.base import Context

    config = config or manifest.data("configs", cell["config"])
    traffic = traffic or manifest.data("traffic", cell["traffic"])
    device = torch.device(device)
    rows = []
    with configured(config):
        ctx = Context(config=config, traffic=traffic, seed=seeds[0],
                      device=device)
        entry = manifest.module("entries", traffic["entry"]).ENTRY(ctx)
        for k, seed in enumerate(seeds):
            ctx.reseed(seed)
            entry.inputs()
            latency, _, _ = window(entry, ctx, seconds)
            entry.close_window()
            row = {"seed": seed, "requests": len(latency),
                   "answers": len(entry.kept),
                   "program": {n: max(v.values())
                               for n, v in entry.errors().items()}}
            if k < control:
                row["control"] = {n: max(v.values()) for n, v in
                                  entry.errors(control=True).items()}
            emit(json.dumps(row))
            rows.append(row)
    names = rows[0]["program"]
    summary = {
        "cell": cell["name"], "seeds": len(rows),
        "lower": {n: max(r["program"][n] for r in rows) for n in names},
        "upper": {n: min(r["control"][n] for r in rows if "control" in r)
                  for n in names if control},
    }
    emit(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    seconds = args.seconds or float(bench["run_seconds"])
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    lines = []

    def emit(line):
        lines.append(line)
        print(line, flush=True)

    readings(bench, cell, seeds, args.control, seconds, "cuda", emit=emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

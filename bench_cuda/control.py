#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, at the
cell's own size, several seeds in one process:

- ``program``: the program's first steps against the reference (the
  lower readings), as every run of the cell reads them;
- ``control``: the reference computed with float8 convolutions and
  matrix products (``reference/pose_train.Precision("fp8")``, one
  precision below the configurations' bfloat16) put in the program's
  place (the upper readings);
- ``bf16``: the reference computed in bfloat16 where the configuration
  computes in it, a witness of what rounding alone does to each number;
- ``half``: the reference in the program's place with half of every
  batch left out, the mean taken over the rest;
- ``flip``: the reference in the program's place stepping along the
  gradient instead of against it;
- ``unexchanged``: the reference in the program's place on a group of
  ``chips`` ranks whose gradients are not exchanged (rank 0's rows
  alone in its loss); only for cells on more than one chip.

A step that leaves the state unchanged reads 1 on the change by
definition and is not run.

    python3 bench_cuda/control.py --workload <cell> --program-seeds 1,2 \\
        --control-seeds 3 [--out file.jsonl]

It runs on one card whatever the cell's chips: a group's program
readings come from the cell's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--root", default=str(ROOT),
                   help="directory holding BENCHMARK.json")
    args = p.parse_args(argv)
    import torch

    from bench_cuda.lib import data as bench_data
    from bench_cuda.lib import manifest, train_cell
    from bench_cuda.reference import pose_train as ref

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.Manifest(Path(args.root))
    workload = dict(bench.workload(args.workload), chips=1)
    config = bench.config(workload["config"])
    device = torch.device(args.device)
    lines = []

    def emit(kind, seed, got, want, seconds):
        numbers = ref.compare(got, want)
        line = {"cell": args.workload, "kind": kind, "seed": seed,
                "seconds": round(seconds, 3),
                **{k: v for k, (v, _) in numbers.items()},
                "at": {k: w for k, (_, w) in numbers.items()}}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for seed in sorted(set(args.program_seeds) | set(args.control_seeds)):
        seeds = bench_data.Seeds(seed)
        cfg = train_cell.cell_config(config, workload, seeds)
        t = time.perf_counter()
        cell = train_cell.Cell(cfg, workload, seeds, device)
        got = cell.first_steps()
        cell.free()
        t_ref = time.perf_counter()
        want = cell.reference()
        if seed in args.program_seeds:
            emit("program", seed, got, want, time.perf_counter() - t)
        if seed not in args.control_seeds:
            continue
        batch = cfg.data.batch_size
        runs = [("control", {"precision": "fp8"}),
                ("bf16", {"precision": "bf16"}),
                ("half", {"batch_rows": (0, batch // 2)}),
                ("flip", {"flip": True})]
        chips = bench.workload(args.workload)["chips"]
        if chips > 1:
            runs.append(("unexchanged", {"loss_rows": (0, batch // chips)}))
        print(f"reference {time.perf_counter() - t_ref:.1f} s",
              file=sys.stderr, flush=True)
        for kind, faults in runs:
            t = time.perf_counter()
            emit(kind, seed, cell.reference(faults), want,
                 time.perf_counter() - t)
        del cell
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

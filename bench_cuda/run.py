#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 bench_cuda/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's file
``bench_cuda/workloads/<cell>.json``, its configuration's
``bench_cuda/configs/<config>.json`` and each per-layer metric's reader
``bench_cuda/metrics/<metric>.py``. With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
The run needs as many CUDA cards as the cell asks for and exits with 2,
printing no result, where there are fewer. It exits with 3, printing no
result, where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rgb_proprioceptive_pose_estimator_tpu")


def process_start() -> float:
    """This process's start on the wall clock (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "bench_cuda" / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches()
    import torch

    from bench_cuda.lib import cells, manifest

    bench = manifest.Manifest(ROOT)
    workload = bench.workload(args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print(f"run.py: the cell needs {workload['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = cells.run(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", START)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    cells.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

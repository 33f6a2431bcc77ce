#!/usr/bin/env python3
"""Time the port's reduce-route training of pr5 (bf16, batch 1024) and
pr4 (bf16, batch 256) for two checkouts in one run on one CUDA card, in
the order A, B, B, A, through each checkout's own
``chip_smoke.run_training`` (16 steps in calls of 8, step p50/p90 and
the profiler's device time by kernel group).

    python3 scripts/torch_ab_training.py <checkout A> <checkout B>

Each pass is a fresh process that imports the port from its checkout.
Prints the lines whose first word is "train" or "profile"."""

import subprocess
import sys
from pathlib import Path

PASS = r'''
import sys, tempfile, torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import _build, fused
assert rppt.__file__.startswith(ROOT), rppt.__file__
_build.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
smi, dev = cs.nvidia_smi(), torch.device("cuda")
with tempfile.TemporaryDirectory() as root:
    cfg = cs.pr5_config(rppt).override(**{"model.bn_stats": "reduce"})
    data = cs.MemoryDemos(cfg, cs.PR5_SAMPLES, seed=9,
                          episode=cs.PR5_EPISODE)
    cs.run_training(fused, cs.train_cfg(cfg, root + "/pr5", eval_every=0),
                    LABEL + " pr5 reduce", data, dev, smi)
    del data
    torch.cuda.empty_cache()
    cfg = rppt.preset("pr4").override(**{"model.bn_stats": "reduce"})
    data = cs.MemoryDemos(cfg, cs.DATASET_BATCHES * cs.PR4_BATCH, seed=6)
    cs.run_training(fused, cs.train_cfg(cfg, root + "/pr4", eval_every=0),
                    LABEL + " pr4 reduce", data, dev, smi)
'''


def main() -> int:
    a, b = (str(Path(p).resolve()) for p in sys.argv[1:3])
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        code = f"ROOT = {root!r}\nLABEL = {label!r}\n" + PASS
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(("train", "profile")):
                print(line, flush=True)
        if out.returncode:
            print(f"{label} ({root}) failed:\n{out.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

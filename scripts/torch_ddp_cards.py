#!/usr/bin/env python3
"""The port's data parallelism with one rank per device: N ranks over
NCCL on N CUDA cards (or N processes over gloo on the CPU), against one
process.

    python3 scripts/torch_ddp_cards.py cuda 4     # four cards, NCCL
    python3 scripts/torch_ddp_cards.py cpu 4      # four CPU processes

pr3 in f32 on both BN statistics routes (at 32 px and batch 16 on the
CPU): chip_smoke.py's ``phase_ddp_pr3`` with one rank per device (three
SGD steps against one process: losses, the update, running statistics,
replicas bit for bit, launches per rank). Then the sharded device cache
(``data.cache_layout="sharded"``): chip_smoke.py's
``phase_sharded_cache`` with one rank per device, each holding its shard
of the frames alone, pr3 against one process fed the same global
batches. Then training across hosts
(``dist.multihost``): two host processes of N/2 ranks each, on the
cards CUDA_VISIBLE_DEVICES gives each (0..N/2-1 and N/2..N-1; on the CPU
N/2 processes each), over NCCL (gloo on the CPU): chip_smoke.py's
``phase_multihost``, pr3 against one process, global rank 0 writing and
every host restoring the final checkpoint. pr1: ``api.train`` and
``api.evaluate`` at dist.num_devices=N against N=1 (losses within 1e-4,
the evaluation within 1e-5), the state ``api.train`` returns equal to
its final checkpoint, on the device. Fails on the first disagreement."""

import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    kind, n = sys.argv[1], int(sys.argv[2])
    dev = torch.device(kind)
    smi = "CPU"
    if kind == "cpu":
        torch.set_num_threads(n)
        small = {"model.image_size": 32, "data.batch_size": 16}
    else:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        smi, small = cs.nvidia_smi(), {}
        print(f"{smi}; {torch.cuda.device_count()} cards; torch "
              f"{torch.__version__}", flush=True)
    for route in ("reduce", "matmul"):
        cfg = rppt.preset("pr3").override(**{"model.bn_stats": route,
                                             **small})
        data = cs.MemoryDemos(cfg, cs.DDP_STEPS * cfg.data.batch_size,
                              seed=4)
        cs.phase_ddp_pr3(cfg, dev, smi, data, dist.rank_devices(dev, n),
                         dist.default_backend(dev))
    with tempfile.TemporaryDirectory() as root:
        cs.phase_sharded_cache(rppt, dev, smi, root,
                               dist.rank_devices(dev, n),
                               dist.default_backend(dev), **small)
    half = n // 2
    hosts = [([str(d) for d in dist.rank_devices(dev, half)],
              None if kind == "cpu" else
              ",".join(str(p * half + i) for i in range(half)))
             for p in range(2)]
    cfg = rppt.preset("pr3").override(**small)
    with tempfile.TemporaryDirectory() as root:
        cs.phase_multihost(rppt, None, dev, smi, root, cs.MemoryDemos(
            cfg, cs.DATASET_BATCHES * cfg.data.batch_size, seed=4), hosts,
            dist.default_backend(dev), **small)
    with tempfile.TemporaryDirectory() as root:
        res = {}
        for k in (1, n):
            cfg = rppt.preset("pr1").override(**{
                "train.steps": 8, "train.eval_every": 8,
                "train.log_every": 4, "train.ckpt_every": 4,
                "train.ckpt_dir": f"{root}/pr1_{k}",
                "data.synthetic_size": 512, "data.num_workers": 2,
                "data.batch_size": 32, "dist.num_devices": k})
            t = time.perf_counter()
            out = rppt.train(cfg, device=dev)
            report = rppt.evaluate(cfg, device=dev)
            saved = checkpoint.load(out["ckpt_path"])[1]
            model = out["model"].state_dict()
            cs.check(out["state"].step == 8 and sorted(model) == sorted(saved)
                     and all(model[k].device.type == kind
                             and torch.equal(model[k].cpu(), v)
                             for k, v in saved.items()),
                     f"pr1 at {k}: the returned state is not the final "
                     "checkpoint's on the device")
            res[k] = (out["metrics"], report)
            print(f"pr1 api.train and api.evaluate at dist.num_devices={k} "
                  f"on {kind}: {time.perf_counter() - t:.2f} s; loss "
                  f"{out['metrics']['loss']!r} eval_loss "
                  f"{out['metrics']['eval_loss']!r}; evaluate loss "
                  f"{report['loss']!r} at step {report['step']}; returned "
                  f"state at step {out['state'].step} on "
                  f"{next(out['model'].parameters()).device} ({smi})",
                  flush=True)
        (m1, e1), (mn, en) = res[1], res[n]
        cs.check(all(abs(mn[k] - m1[k]) <= 1e-4 * abs(m1[k])
                     for k in ("loss", "eval_loss"))
                 and abs(en["loss"] - e1["loss"]) <= 1e-5 * abs(e1["loss"]),
                 f"pr1: {n} ranks disagree with one process")
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

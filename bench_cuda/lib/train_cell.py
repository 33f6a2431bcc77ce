"""A training cell: the program's training step on one card, or on each
rank of a data-parallel group, driven from the seed, timed, optionally
traced, and checked against the plain reference.

Set-up builds one training state and the program's own feed (the
in-memory demo store behind ``data/pipeline.HostPipeline``, with the
frames in the device cache when the cell says so), drives that state
through its first three steps with the window's own call, and keeps
what those steps did: each step's loss, the first gradient as AdamW
holds it (its first moment over 1 - beta1), and what the three steps
changed in each parameter and BatchNorm running statistic (its norm,
and the change itself on the host). The same
state then runs the window. After the window, with the program's state
freed, the reference follows the same three steps from the same inputs
and the two are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from bench_cuda.lib import data as bench_data
from bench_cuda.lib import trace as bench_trace
from bench_cuda.reference import pose_train as ref
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import train_step as ts
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import create_state
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    BatchNormAct,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

CHECK_STEPS = 3


def cell_config(config: Dict, workload: Dict, seeds: bench_data.Seeds
                ) -> Config:
    """The configuration a cell runs: the configuration file's, with the
    workload's data route and the run's seeds."""
    cfg = Config.from_dict(config["config"])
    return cfg.override(**workload["overrides"],
                        **{"train.seed": seeds.train,
                           "data.seed": seeds.data})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Mark:
    """A step boundary: a CUDA event recorded on the stream, or the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.event = None
        self.host = time.perf_counter()
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()

    def ms_to(self, later: "_Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.host - self.host) * 1e3


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack([torch.linalg.vector_norm(t.double())
                        for t in tensors]).cpu().tolist()


def _tracked(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters and BatchNorm running statistics, by state-dict
    name."""
    out = dict(model.named_parameters())
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNormAct):
            out[f"{name}.running_mean"] = mod.running_mean
            out[f"{name}.running_var"] = mod.running_var
    return out


class Cell:
    """One rank's part of a training cell."""

    def __init__(self, cfg: Config, workload: Dict, seeds: bench_data.Seeds,
                 device: torch.device):
        self.cfg, self.seeds = cfg, seeds
        self.device = device
        self.rank, self.world = dist.rank(), dist.world()
        model_cfg = cfg.to_dict()["model"]
        fixtures, self.demos = bench_data.make_demos(
            model_cfg, workload["demos"], workload["steps_per_demo"],
            seeds.frames, device)
        store = build_dataset(cfg, "all", fixtures={cfg.data.path: fixtures})
        weights = ref.make_weights(model_cfg, seeds.weights, device)
        self.state = create_state(cfg, device, state_dict=weights)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        mean, std = store.proprio_stats()
        with torch.no_grad():
            self.state.model.proprio.proprio_mean.copy_(torch.from_numpy(mean))
            self.state.model.proprio.proprio_std.copy_(torch.from_numpy(std))
        if self.world > 1:
            self.state.ddp = dist.data_parallel(self.state.model)
        self.pipe = HostPipeline(store, cfg.data, device=device, train=True,
                                 rank=self.rank, world=self.world)
        self.device_aug = ts.device_aug_of(cfg)
        hw = (cfg.model.image_size + 2 * cfg.data.crop_margin
              if self.device_aug is not None else cfg.model.image_size)
        self.cache = loop.upload_image_cache(store, hw, device)
        self.flag_group = (torch.distributed.new_group(backend="gloo")
                           if self.world > 1 else None)
        self.data_wait = 0.0
        self.spans: List = []

    def step(self) -> torch.Tensor:
        """One step of the window: the next batch of the feed, then the
        program's train step; returns the step's loss (on the device).
        Keeps the host spans of both calls."""
        t0 = time.time_ns()
        batch = next(self.pipe)
        t1 = time.time_ns()
        metrics = ts.train_step(self.state, batch, self.cfg.train,
                                self.cache, self.device_aug)
        t2 = time.time_ns()
        self.data_wait += (t1 - t0) * 1e-9
        self.spans += [("step", t0, t2), ("data_wait", t0, t1),
                       ("train_step", t1, t2)]
        return metrics["loss"]

    def first_steps(self) -> Dict:
        """The first CHECK_STEPS steps, through ``step``, and what they did
        to the state (on rank 0: every rank holds the same)."""
        model, opt = self.state.model, self.state.optimizer
        tracked = _tracked(model)
        start = {n: t.detach().clone() for n, t in tracked.items()}
        names = {id(p): n for n, p in model.named_parameters()}
        losses, first_grad = [], {}
        beta1 = opt.inner.param_groups[0]["betas"][0]
        for k in range(CHECK_STEPS):
            losses.append(self.step())
            if k == 0:
                moments = [(names[id(p)], opt.inner.state[p]["exp_avg"])
                           for p in opt.params if p in opt.inner.state]
                norms = _norms([m for _, m in moments])
                first_grad = {n: v / (1.0 - beta1)
                              for (n, _), v in zip(moments, norms)}
        keys = sorted(tracked)
        deltas = [tracked[n].detach() - start[n] for n in keys]
        change = dict(zip(keys, _norms(deltas)))
        return {"losses": [float(x) for x in losses],
                "first_grad": first_grad, "change": change,
                "change_t": {n: d.cpu() for n, d in zip(keys, deltas)}}

    def _stop(self, deadline: float) -> bool:
        flag = torch.tensor([int(time.perf_counter() >= deadline)])
        if self.flag_group is not None:
            torch.distributed.broadcast(flag, 0, group=self.flag_group)
        return bool(flag.item())

    def window(self, seconds: float) -> Dict:
        """Steps until ``seconds`` have passed on rank 0's clock (every
        rank runs as many), then a synchronise. Each step's time is the
        gap between CUDA events recorded at the step boundaries."""
        dist.barrier()
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.data_wait = 0.0
        self.spans = []
        marks: List[_Mark] = []
        losses: List[torch.Tensor] = []
        start_wall = time.time()
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            marks.append(_Mark(self.device))
            losses.append(self.step())
            if self._stop(deadline):
                break
        marks.append(_Mark(self.device))
        _sync(self.device)
        dist.barrier()
        elapsed = time.perf_counter() - start
        step_ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
        loss = torch.stack(losses).float()
        return {"steps": len(losses), "window_s": elapsed,
                "start_wall": start_wall, "step_ms": step_ms,
                "data_wait_s": self.data_wait,
                "failed": int((~torch.isfinite(loss)).sum()),
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if self.device.type == "cuda" else 0)}

    def traced(self, steps: int) -> Dict:
        """``steps`` more steps under the profiler, summarised."""
        dist.barrier()
        return bench_trace.summarise(bench_trace.profile(self.step, steps,
                                                         self.spans))

    def free(self) -> None:
        """Let go of the program's state, feed and cache."""
        self.pipe.close()
        self.state = self.pipe = self.cache = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, faults: Optional[Dict] = None) -> Dict:
        """The reference's first steps from this cell's inputs."""
        return ref.train_steps(self.cfg.to_dict(), self.demos, self.weights,
                               self.seeds.train, self.seeds.data,
                               self.device, steps=CHECK_STEPS,
                               **(faults or {}))


def run_rank(cfg: Config, device: torch.device, workload: Dict,
             seeds_value: int, seconds: float, trace: bool) -> Dict:
    """One rank of a cell (the whole cell on one card): set-up, the first
    steps, the window, the traced steps with ``trace``, then on rank 0
    the reference and the comparison's numbers."""
    seeds = bench_data.Seeds(seeds_value)
    cell = Cell(cfg, workload, seeds, device)
    got = cell.first_steps()
    timed = cell.window(seconds)
    out = {"timed": timed}
    if trace:
        out["trace"] = cell.traced(workload["trace_steps"])
    cell.free()
    if cell.rank == 0:
        numbers = ref.compare(got, cell.reference())
        out["numbers"] = {k: v for k, (v, _) in numbers.items()}
        out["where"] = {k: w for k, (_, w) in numbers.items()}
    return out

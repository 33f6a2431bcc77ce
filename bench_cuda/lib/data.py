"""Inputs of a training cell, made from the run's seed: the demos (frames,
proprioception, object poses) and the initial weights, the same for the
program and the reference.

The demos are made on the device in a few large calls and copied to the
host once, where the program's in-memory demo store
(``data/hdf5_store.MemoryDemoStore``) reads them as it reads a
robomimic-layout file: uint8 frames of uniform noise at the served size
per camera, a proprioceptive random walk, and a random walk of the
object's pose (position in [0.05, 0.95]^3, a unit quaternion).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_cuda.reference import pose_train as ref


class Seeds:
    """The run's seed split into independent streams."""

    def __init__(self, seed: int):
        s = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64)
        self.frames = int(s[0])
        self.weights = int(s[1])
        self.train = int(s[2] % (2 ** 31 - 1))
        self.data = int(s[3] % (2 ** 31 - 1))


def make_demos(model: Dict, demos: int, steps: int, seed: int,
               device) -> Tuple[List[Dict], ref.Demos]:
    """``demos`` demos of ``steps`` steps for model config ``model``:
    the fixture dicts the demo store serves, and the same arrays for the
    reference."""
    n = demos * steps
    hw = model["image_size"]
    dim = model["proprio_dim"]
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = {}
    for cam in model["cameras"]:
        f = torch.randint(0, 256, (n, hw, hw, 3), generator=gen,
                          device=device, dtype=torch.uint8)
        frames[cam] = f.cpu().numpy()
        del f

    def walk(first, stepsize, width):
        x = torch.randn((demos, steps, width), generator=gen,
                        device=device) * stepsize
        x[:, 0] = first
        return x.cumsum(1)

    proprio = walk(torch.randn((demos, dim), generator=gen, device=device)
                   * 0.3, 0.05, dim)
    pos = walk(0.25 + 0.5 * torch.rand((demos, 3), generator=gen,
                                       device=device), 0.03, 3)
    pos = pos.clamp(0.05, 0.95)
    quat = walk(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device), 0.1, 4)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    obj = torch.zeros((demos, steps, 14), device=device)
    obj[..., :3] = pos
    obj[..., 3:7] = quat
    proprio = proprio.reshape(n, dim).cpu().numpy()
    obj = obj.reshape(n, 14).cpu().numpy()
    fixtures = []
    for d in range(demos):
        lo, hi = d * steps, (d + 1) * steps
        datasets = {f"obs/{cam}_image": frames[cam][lo:hi]
                    for cam in model["cameras"]}
        datasets["obs/robot0_proprio-state"] = proprio[lo:hi]
        datasets["obs/object"] = obj[lo:hi]
        fixtures.append({"name": f"demo_{d}", "datasets": datasets,
                         "attrs": {"num_samples": steps}})
    offsets = np.arange(demos + 1, dtype=np.int64) * steps
    return fixtures, ref.Demos(frames, proprio, obj[:, :7], offsets)

"""Checkpoints of the port: one file, ``torch.save`` of
``{"config": cfg.to_dict(), "state_dict": ...}``.

The JAX package's orbax checkpoints need JAX to read; converting them is
a tool outside the port's runtime (``utils.convert.state_dict_from_jax``
takes the restored variables).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config


def save(path: str, cfg: Config, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write the checkpoint atomically (a temporary file renamed into
    place), with the tensors on the CPU."""
    payload = {"config": cfg.to_dict(),
               "state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()}}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """(config, state_dict on the CPU) from a checkpoint written by save."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return Config.from_dict(payload["config"]), payload["state_dict"]

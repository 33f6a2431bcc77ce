"""Checkpoints of the port: one file, ``torch.save`` of
``{"config": cfg.to_dict(), "state_dict": ...}``, and for a training
checkpoint also ``"training": {"step", "optimizer", "pipeline"}`` (the
step count, the optimizer's state with its update count and, mid-way
through a ``train.grad_accum`` update, the gradient sums and micro-step
count, and the sampler state of the train pipeline), with ``"ema"`` (the
parameters' EMA, ``train.ema_decay``) and ``"best_val"`` in a best
checkpoint.

``state_dict`` holds the raw parameters, which training resumes from;
``load`` gives the weights a checkpoint serves (the reference's
``eval_variables``): the EMA's parameters where there is one.

``fit`` writes ``<train.ckpt_dir>/step_<step>.pt`` and keeps the newest
``train.ckpt_keep``; with ``train.ckpt_best_metric`` it also keeps the
checkpoint of the best eval so far, alone, in ``<train.ckpt_dir>/best``.
``resolve`` turns (ckpt_dir, step) into a file for every reader.

Under data parallelism only rank 0 writes (every rank holds the same
model and optimizer state); the other ranks' writers return the path
rank 0 writes, and every rank reads the same file on resume.

The JAX package's orbax checkpoints need JAX to read; converting them is
a tool outside the port's runtime (``utils.convert.state_dict_from_jax``
takes the restored variables).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
BEST = "best"


def save(path: str, cfg: Config, state_dict: Dict[str, torch.Tensor],
         training: Optional[Dict[str, Any]] = None) -> None:
    """Write the checkpoint atomically (a temporary file renamed into
    place), with the tensors on the CPU; on rank 0 only."""
    if dist.rank() != 0:
        return
    payload = {"config": cfg.to_dict(),
               "state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()}}
    if training is not None:
        payload["training"] = training
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def served(state_dict: Dict[str, torch.Tensor],
           training: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """The state_dict a checkpoint serves: its parameters are the EMA's
    where its training state has one."""
    ema = (training or {}).get("ema")
    return state_dict if ema is None else {**state_dict, **ema}


def load(path: str) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """(config, the state_dict it serves, on the CPU) from a checkpoint
    written by save."""
    cfg, state_dict, training = load_training(path)
    return cfg, served(state_dict, training)


def load_training(path: str
                  ) -> Tuple[Config, Dict[str, torch.Tensor],
                             Optional[Dict[str, Any]]]:
    """(config, state_dict, training state or None), all on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (Config.from_dict(payload["config"]), payload["state_dict"],
            payload.get("training"))


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def steps(ckpt_dir: str) -> List[int]:
    """Steps of the training checkpoints in ckpt_dir, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = (_STEP_FILE.match(name) for name in os.listdir(ckpt_dir))
    return sorted(int(m.group(1)) for m in found if m)


def save_step(ckpt_dir: str, step: int, keep: int, cfg: Config,
              state_dict: Dict[str, torch.Tensor],
              training: Dict[str, Any]) -> str:
    """Write step_<step>.pt in ckpt_dir, then delete all but the newest
    ``keep`` (0 keeps all), on rank 0 only. Returns the new file's
    path."""
    path = step_path(ckpt_dir, step)
    if dist.rank() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    save(path, cfg, state_dict, training)
    if keep > 0:
        for old in steps(ckpt_dir)[:-keep]:
            os.remove(step_path(ckpt_dir, old))
    return path


def save_best(ckpt_dir: str, step: int, cfg: Config,
              state_dict: Dict[str, torch.Tensor],
              training: Dict[str, Any]) -> str:
    """Write step_<step>.pt in <ckpt_dir>/best and delete every other
    checkpoint there: the directory holds the best so far, and only it.
    ``training`` carries its ``best_val``. Returns the new file's path."""
    best = os.path.join(ckpt_dir, BEST)
    path = save_step(best, step, 0, cfg, state_dict, training)
    if dist.rank() != 0:
        return path
    for old in steps(best):
        if old != step:
            os.remove(step_path(best, old))
    return path


def resolve(ckpt_dir: str, step: Union[int, str, None] = None
            ) -> Tuple[str, int]:
    """(file, step) of the checkpoint that ``step`` names in ckpt_dir: the
    latest for None, that step for an int, and the one in
    <ckpt_dir>/best for "best" (which train.ckpt_best_metric keeps).
    Raises FileNotFoundError where there is none."""
    if step == BEST:
        ckpt_dir = os.path.join(ckpt_dir, BEST)
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"no best checkpoint at {ckpt_dir}: train with "
                "train.ckpt_best_metric set (and train.eval_every > 0)")
        step = None
    elif isinstance(step, str):
        raise ValueError(f"step must be an int, None, or 'best'; "
                         f"got {step!r}")
    found = steps(ckpt_dir)
    if step is None:
        if not found:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        step = found[-1]
    elif step not in found:
        raise FileNotFoundError(f"no checkpoint of step {step} in "
                                f"{ckpt_dir} (it has {found})")
    return step_path(ckpt_dir, step), step

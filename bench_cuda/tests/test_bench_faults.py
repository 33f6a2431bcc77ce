"""The comparison that decides ``correct`` fails what it must: a run
with the timed path broken underneath, or with the lower-precision
control in the program's place (the harness's look for a card skipped,
everything else as a run does it), on a tiny copy of the pr5 cell with
limits of its own."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from bench_cuda import control
from bench_cuda.lib import cells, manifest, train_cell
from bench_cuda.tests.tiny import CELL, TINY_LIMITS, make_root
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import train_step as ts

SEED = 2 ** 31 + 3


def unchanged(step):
    """A step that returns the state as it found it."""

    def broken(state, batch, cfg, *args, **kwargs):
        saved = copy.deepcopy(state.model.state_dict())
        out = step(state, batch, cfg, *args, **kwargs)
        state.model.load_state_dict(saved)
        return out

    return broken


def half_batch(step):
    """A step on the first half of its batch, the mean over those rows."""

    def broken(state, batch, cfg, *args, **kwargs):
        half = len(batch["target_pos"]) // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, cfg,
                    *args, **kwargs)

    return broken


def unexchanged(step):
    """A step on a rank of a group whose gradients are not exchanged."""

    def broken(state, batch, cfg, *args, **kwargs):
        ddp, state.ddp = state.ddp, None
        try:
            return step(state, batch, cfg, *args, **kwargs)
        finally:
            state.ddp = ddp

    return broken


def flipped(step):
    """A step along the gradient instead of against it."""

    def broken(state, batch, cfg, *args, **kwargs):
        hooks = [p.register_hook(torch.neg)
                 for p in state.model.parameters() if p.requires_grad]
        try:
            return step(state, batch, cfg, *args, **kwargs)
        finally:
            for h in hooks:
                h.remove()

    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "unexchanged": unexchanged, "flipped": flipped}


def faulty_rank(cfg, device, workload, seed, seconds, trace):
    """``train_cell.run_rank`` with the cell file's ``fault`` planted in
    the program's train step (in this process: a rank of a group is
    one)."""
    sound = ts.train_step
    ts.train_step = FAULTS[workload["fault"]](sound)
    try:
        return train_cell.run_rank(cfg, device, workload, seed, seconds,
                                   trace)
    finally:
        ts.train_step = sound


def control_rank(cfg, device, workload, seed, seconds, trace):
    """``train_cell.run_rank`` with the control, the reference in float8,
    in the program's place for the first steps."""
    sound = train_cell.Cell.first_steps
    train_cell.Cell.first_steps = lambda cell: cell.reference(
        {"precision": "fp8"})
    try:
        return train_cell.run_rank(cfg, device, workload, seed, seconds,
                                   trace)
    finally:
        train_cell.Cell.first_steps = sound


def _run(tmp_path, chips=1, fault=None):
    root = make_root(tmp_path, chips=chips,
                     extra={"fault": fault} if fault else None)
    rank_fn = {None: train_cell.run_rank,
               "control": control_rank}.get(fault, faulty_rank)
    return cells.run(manifest.Manifest(root), CELL, SEED, 0.5, False, "cpu",
                     time.time(), rank_fn=rank_fn)


def test_sound_run_is_correct(tmp_path):
    assert _run(tmp_path)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "flipped",
                                   "control"])
def test_broken_step_is_not_correct(tmp_path, fault):
    result = _run(tmp_path, fault=fault)
    assert result["correct"] is False, result["checks"]


def test_sound_group_is_correct(tmp_path):
    assert _run(tmp_path, chips=2)["correct"] is True


def test_group_without_exchange_is_not_correct(tmp_path):
    result = _run(tmp_path, chips=2, fault="unexchanged")
    assert result["correct"] is False, result["checks"]


def test_control_script_reads_every_fault(tmp_path, capsys):
    root = make_root(tmp_path)
    control.main(["--workload", CELL, "--control-seeds", str(SEED),
                  "--device", "cpu", "--root", str(root)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    kinds = {x["kind"]: x for x in lines}
    assert set(kinds) == {"control", "bf16", "half", "flip"}
    for kind in ("control", "half", "flip"):
        assert any(kinds[kind][k] > v for k, v in TINY_LIMITS.items()), kind

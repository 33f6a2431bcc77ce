"""Resume and best-eval checkpoints of the port on the CPU: the port's
counterparts of tests/test_checkpoint.py and the best-checkpoint tests of
tests/test_trainer_features.py, on pr1 (the proprio-only model on
synthetic data, as there). A resumed run must equal the uninterrupted run
bit for bit: model, optimizer (state and update count) and sampler
state, compared through the final checkpoint files."""

import json
import os

import pytest
import torch

import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def one_thread():
    """pr1's MLP ops take microseconds: one intra-op thread, so that the
    test workers running beside these do not make them wait on each
    other's threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SCHEDULES = {"constant": {},
             "cosine_warmup": {"train.optimizer": "adamw",
                               "train.lr_schedule": "cosine",
                               "train.warmup_steps": 30,
                               "train.weight_decay": 1e-4}}


def _base(tmp_path, name, steps, ckpt_every, **overrides):
    return rppt.preset("pr1").override(**{
        "train.steps": steps,
        "train.ckpt_every": ckpt_every,
        "train.eval_every": 0,
        "train.log_every": 1000,
        "train.ckpt_dir": str(tmp_path / name),
        "data.synthetic_size": 256,
        "data.num_workers": 2,
        **overrides,
    })


def _train(cfg):
    return rppt.train(cfg, device="cpu")


def _assert_equal(a, b, where=""):
    """Nested dicts and lists of tensors and numbers, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, (where, a, b)


def _same_run(path_a, path_b):
    _, sd_a, tr_a = checkpoint.load_training(path_a)
    _, sd_b, tr_b = checkpoint.load_training(path_b)
    _assert_equal(sd_a, sd_b, "state_dict")
    _assert_equal(tr_a, tr_b, "training")


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_resume_equals_uninterrupted_bitwise(tmp_path, schedule):
    kw = SCHEDULES[schedule]
    full = _train(_base(tmp_path, "full", 40, 40, **kw))
    _train(_base(tmp_path, "resumed", 20, 20, **kw))
    resumed = _train(_base(tmp_path, "resumed", 40, 40, **kw))
    # the optimizer's count (which the schedule reads), its moments, the
    # step and the sampler position all went on from the checkpoint
    _same_run(full["ckpt_path"], resumed["ckpt_path"])
    _, _, training = checkpoint.load_training(resumed["ckpt_path"])
    assert training["step"] == 40 and training["optimizer"]["count"] == 40
    assert training["pipeline"]["consumed"] == 40
    for k, v in full["model"].state_dict().items():
        assert torch.equal(v, resumed["model"].state_dict()[k]), k


def test_fault_injection_mid_epoch_resume(tmp_path):
    """11 steps = an epoch of 8 batches (256 / 32) and 3; stopped after 5,
    the resumed run takes the epoch up at its sixth batch."""
    ref = _train(_base(tmp_path, "fault", 11, 11))
    _train(_base(tmp_path, "fault2", 5, 5))
    out = _train(_base(tmp_path, "fault2", 11, 11))
    _same_run(ref["ckpt_path"], out["ckpt_path"])


def test_restore_rejects_missing_dir(tmp_path):
    cfg = _base(tmp_path, "nope", 10, 10)
    with pytest.raises(FileNotFoundError):
        rppt.evaluate(cfg, ckpt_dir=str(tmp_path / "empty"), device="cpu")


def test_rerun_completed_config_is_noop(tmp_path):
    cfg = _base(tmp_path, "done", 10, 10)
    first = _train(cfg)
    files = sorted(os.listdir(cfg.train.ckpt_dir))
    mtime = os.path.getmtime(first["ckpt_path"])
    again = _train(cfg)                 # resumes at 10, runs no step
    assert again["ckpt_path"] == first["ckpt_path"]
    assert sorted(os.listdir(cfg.train.ckpt_dir)) == files
    assert os.path.getmtime(first["ckpt_path"]) == mtime
    for k, v in first["model"].state_dict().items():
        assert torch.equal(v, again["model"].state_dict()[k]), k


def test_resume_explicit_step(tmp_path):
    """train.resume='<step>' restores that step, not the latest."""
    cfg = _base(tmp_path, "explicit", 30, 10)    # checkpoints 10, 20, 30
    _train(cfg)
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import fit

    out = fit(cfg.override(**{"train.steps": 20, "train.resume": "20"}),
              torch.device("cpu"))
    assert out["state"].step == 20 and out["state"].optimizer.count == 20
    assert out["ckpt_path"] == checkpoint.step_path(cfg.train.ckpt_dir, 20)


def test_resume_explicit_step_overwrites_later_ckpts(tmp_path):
    """An explicit-step resume re-walks steps an earlier run saved and
    writes them again; on the CPU the second walk is the first, bit for
    bit."""
    cfg = _base(tmp_path, "rewalk", 30, 10)      # checkpoints 10, 20, 30
    _train(cfg)
    saved = {s: checkpoint.load_training(
        checkpoint.step_path(cfg.train.ckpt_dir, s)) for s in (20, 30)}
    out = _train(cfg.override(**{"train.resume": "10"}))
    assert out["ckpt_path"] == checkpoint.step_path(cfg.train.ckpt_dir, 30)
    assert checkpoint.steps(cfg.train.ckpt_dir) == [10, 20, 30]
    for s, (_, sd, training) in saved.items():
        _, sd2, training2 = checkpoint.load_training(
            checkpoint.step_path(cfg.train.ckpt_dir, s))
        _assert_equal(sd, sd2, f"step {s}")
        _assert_equal(training, training2, f"step {s}")


def test_ckpt_keep_keeps_the_newest(tmp_path):
    cfg = _base(tmp_path, "keep", 40, 10, **{"train.ckpt_keep": 2})
    _train(cfg)
    assert checkpoint.steps(cfg.train.ckpt_dir) == [30, 40]


@pytest.mark.parametrize("resume,error", [("none", ValueError),
                                          ("7", FileNotFoundError)])
def test_resume_refusals(tmp_path, resume, error):
    cfg = _base(tmp_path, "refuse", 10, 10)
    _train(cfg)
    with pytest.raises(error):
        _train(cfg.override(**{"train.resume": resume, "train.steps": 20}))


def test_explicit_resume_without_checkpoint_raises(tmp_path):
    cfg = _base(tmp_path, "empty", 10, 10, **{"train.resume": "5"})
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _train(cfg)


def test_resume_checks_steps_per_call(tmp_path):
    cfg = _base(tmp_path, "spc", 3, 3)
    _train(cfg)
    with pytest.raises(ValueError, match="steps_per_call"):
        _train(cfg.override(**{"train.steps": 8, "train.ckpt_every": 0,
                               "train.steps_per_call": 2}))


def test_evaluate_val_requires_split(tmp_path):
    cfg = _base(tmp_path, "valguard", 10, 10)
    _train(cfg)
    with pytest.raises(ValueError, match="val_fraction"):
        rppt.evaluate(cfg, split="val", device="cpu")


def _best_cfg(tmp_path, steps=60, **overrides):
    return rppt.preset("pr1").override(**{
        "train.steps": steps, "train.eval_every": 20, "train.eval_steps": 2,
        "train.ckpt_every": 20, "train.log_every": 100,
        "train.ckpt_dir": str(tmp_path / "ckpt"),
        "train.ckpt_best_metric": "pos_mae_cm",
        "data.synthetic_size": 128, **overrides})


def _evals(cfg):
    with open(os.path.join(cfg.train.ckpt_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["eval/pos_mae_cm"] for r in rows
            if "eval/pos_mae_cm" in r}


def test_best_checkpoint_tracked(tmp_path):
    cfg = _best_cfg(tmp_path)
    _train(cfg)
    best_dir = os.path.join(cfg.train.ckpt_dir, "best")
    best_steps = checkpoint.steps(best_dir)
    assert len(best_steps) == 1 and best_steps[0] in (20, 40, 60)
    evals = _evals(cfg)
    assert best_steps[0] == min(evals, key=evals.get)
    _, _, training = checkpoint.load_training(
        checkpoint.step_path(best_dir, best_steps[0]))
    assert training["best_val"] == pytest.approx(evals[best_steps[0]],
                                                 rel=1e-12)
    # step="best" restores it through evaluate (and Predictor)
    out = rppt.evaluate(cfg, step="best", max_batches=1, device="cpu")
    assert out["step"] == best_steps[0]
    with pytest.raises(ValueError):
        rppt.evaluate(cfg, step="bogus", max_batches=1, device="cpu")


def test_best_value_is_restored_on_resume(tmp_path):
    """A resumed run compares its evals with the best so far: a best
    checkpoint whose best_val no eval can beat stays where it is."""
    cfg = _best_cfg(tmp_path, steps=40)
    _train(cfg)
    best_dir = os.path.join(cfg.train.ckpt_dir, "best")
    (step,) = checkpoint.steps(best_dir)
    path = checkpoint.step_path(best_dir, step)
    kept, sd, training = checkpoint.load_training(path)
    checkpoint.save(path, kept, sd, dict(training, best_val=-1.0))
    _train(cfg.override(**{"train.steps": 80}))
    assert checkpoint.steps(best_dir) == [step]
    assert sorted(_evals(cfg)) == [20, 40, 60, 80]


def test_best_restore_without_best_dir_fails_loudly(tmp_path):
    cfg = _best_cfg(tmp_path, steps=20, **{"train.eval_every": 0,
                                           "train.ckpt_best_metric": ""})
    _train(cfg)
    with pytest.raises(FileNotFoundError, match="ckpt_best_metric"):
        rppt.evaluate(cfg, step="best", max_batches=1, device="cpu")


def test_best_metric_typo_fails_loudly(tmp_path):
    cfg = _best_cfg(tmp_path, steps=20,
                    **{"train.ckpt_best_metric": "nope_mae"})
    with pytest.raises(KeyError):
        _train(cfg)


def test_best_metric_needs_evals(tmp_path):
    cfg = _best_cfg(tmp_path, steps=20, **{"train.eval_every": 0})
    with pytest.raises(ValueError, match="eval_every"):
        _train(cfg)

"""The port's public API takes the JAX package's arguments: ``train``,
``evaluate``, ``Predictor`` and ``predict`` have the reference's
parameters in its order and of its kinds, and may add keyword-only ones
(``device``, ``ckpt_path``, ``state_dict``), nothing else. A call written
against the reference, such as ``Predictor(cfg, "runs/pr3")`` or
``predict(cfg, obs, ckpt_dir, step)``, then means the same in the port."""

import inspect

import numpy as np
import pytest
import torch

import rgb_proprioceptive_pose_estimator_tpu.api as jax_api
import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch import api


@pytest.fixture(autouse=True)
def one_thread():
    """pr1's MLP ops take microseconds: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["train", "evaluate", "Predictor.__init__",
                                  "predict"])
def test_signature_is_the_references_plus_keyword_only(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    want, got = _params(get(jax_api)), _params(get(api))
    assert got[:len(want)] == want
    extra = got[len(want):]
    assert all(kind == inspect.Parameter.KEYWORD_ONLY for _, kind in extra), \
        extra


def test_train_returns_ckpt_dir_that_predictor_and_predict_restore(tmp_path):
    """pr1 (proprio-only, synthetic data) trained for 2 steps on the CPU:
    the ckpt_dir that train returns, passed as the reference passes it
    (positionally, with a step), serves the trained model's poses."""
    cfg = rppt.preset("pr1").override(**{
        "train.steps": 2, "train.eval_every": 0, "train.log_every": 1,
        "train.ckpt_every": 0, "train.ckpt_dir": str(tmp_path / "run"),
        "data.synthetic_size": 64, "data.num_workers": 1})
    out = rppt.train(cfg, device="cpu")
    assert out["ckpt_dir"] == cfg.train.ckpt_dir
    assert out["state"].model is out["model"] and out["state"].step == 2
    obs = {"proprio": np.random.RandomState(0).randn(
        5, cfg.model.proprio_dim).astype(np.float32)}
    want = rppt.Predictor(cfg, model=out["model"])(obs)
    for got in (rppt.Predictor(cfg, out["ckpt_dir"], 2, device="cpu")(obs),
                rppt.Predictor(cfg, state=out["state"])(obs),
                rppt.predict(cfg, obs, out["ckpt_dir"], None, device="cpu")):
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)
    with pytest.raises(ValueError):
        rppt.Predictor(cfg, out["ckpt_dir"], model=out["model"])

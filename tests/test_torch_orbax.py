"""``scripts/torch_from_orbax.py``: orbax checkpoints of the JAX package
into the port, on the CPU.

Tiny JAX runs write orbax checkpoints: pr3 (ResNet-18) at 32 px and the
ViT at the ModelConfig defaults (patch 16, dim 384, depth 6, 6 heads,
mean pooling; 4 tokens at 32 px), each with and without train.ema_decay,
2 SGD steps at batch 4. The tool, run in-process through its
``main(argv)``, converts each; the port's ``Predictor`` then serves the
same observations as the JAX package's ``Predictor`` from the orbax
directory, within rtol 1e-4, atol 1e-5 (f32 on the CPU). Torch runs on
one intra-op thread.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.api import Predictor as JaxPredictor
from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.loop import fit as jax_fit
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

RTOL, ATOL = 1e-4, 1e-5
STEPS, BATCH = 2, 4
SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                      "torch_from_orbax.py")
MODELS = {"resnet18": {},
          "vit": {"model.backbone": "vit"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("torch_from_orbax", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("orbax_demo") / "demo.hdf5"),
        n_demos=3, steps=12, image_hw=40, seed=0)


def _overrides(demo_h5, backbone, ema):
    return {"model.image_size": 32, "model.dtype": "float32",
            **MODELS[backbone],
            "data.path": demo_h5, "data.batch_size": BATCH,
            "data.num_workers": 0, "train.optimizer": "sgd",
            "train.lr": 1e-2, "train.steps": STEPS,
            "train.steps_per_call": 1, "train.log_every": STEPS,
            "train.eval_every": 0, "train.ckpt_every": 0,
            "train.ema_decay": 0.5 if ema else 0.0,
            "dist.num_devices": 1}


@pytest.fixture(scope="module")
def orbax_run(demo_h5, tmp_path_factory):
    """(JAX config, its overrides) of a finished JAX run, one per case."""
    runs = {}

    def run(backbone, ema):
        if (backbone, ema) not in runs:
            over = _overrides(demo_h5, backbone, ema)
            d = tmp_path_factory.mktemp(f"orbax_{backbone}_{ema}")
            jcfg = jax_preset("pr3").override(**{
                **over, "train.ckpt_dir": str(d)})
            jax_fit(jcfg)
            runs[backbone, ema] = jcfg, over
        return runs[backbone, ema]

    return run


def _observations(cfg, n=3, seed=0):
    rs = np.random.RandomState(seed)
    hw = cfg.model.image_size
    return {"images": {c: rs.randint(0, 256, (n, hw, hw, 3), np.uint8)
                       for c in cfg.model.cameras},
            "proprio": rs.randn(n, cfg.model.proprio_dim).astype(np.float32)}


def _set_args(overrides):
    args = []
    for k, v in overrides.items():
        args += ["--set", f"{k}={json.dumps(v)}"]
    return args


@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
@pytest.mark.parametrize("backbone", sorted(MODELS))
def test_converted_checkpoint_serves_the_jax_predictors_poses(
        tool, orbax_run, tmp_path, capsys, backbone, ema):
    jcfg, over = orbax_run(backbone, ema)
    out_dir = str(tmp_path / "port")
    path = tool.main([jcfg.train.ckpt_dir, "--out", out_dir, "--preset",
                      "pr3", *_set_args(over)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"src": os.path.abspath(jcfg.train.ckpt_dir),
                    "step": STEPS, "ema": ema, "out": path}
    assert path == checkpoint.step_path(out_dir, STEPS)
    cfg, state_dict, training = checkpoint.load_training(path)
    assert training["step"] == STEPS and ("ema" in training) == ema
    assert cfg.train.ckpt_dir == out_dir
    assert cfg.model == Config.from_dict(jcfg.to_dict()).model
    if ema:   # the EMA's parameters differ from the raw ones and serve
        served = checkpoint.load(path)[1]
        assert set(training["ema"]) < set(state_dict)
        assert any(not torch.equal(served[k], state_dict[k])
                   for k in training["ema"])

    obs = _observations(cfg)
    want = JaxPredictor(jcfg, jcfg.train.ckpt_dir)(obs)
    port = api.Predictor(cfg, out_dir, device="cpu")
    assert port.step == STEPS
    got = port(obs)
    for g, w, what in zip(got, want, ("pos", "quat")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    # the file warm-starts a port run at the weights it serves, and does
    # not resume one
    fresh = cfg.override(**{"train.init_from": out_dir,
                            "train.ckpt_dir": str(tmp_path / "warm")})
    state = create_state(fresh, torch.device("cpu"))
    loop.warm_start(fresh, state)
    served = checkpoint.load(path)[1]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, served[k]), k
    with pytest.raises(ValueError, match="no optimizer state"):
        api.train(cfg.override(**{"train.steps": STEPS + 1}), device="cpu")


def test_a_config_the_variables_do_not_fit_is_refused(tool, orbax_run,
                                                      tmp_path):
    jcfg, over = orbax_run("resnet18", False)
    wrong = {**over, "model.backbone": "resnet34"}
    with pytest.raises(ValueError, match=r"missing \[.*stage1_block2"):
        tool.main([jcfg.train.ckpt_dir, "--out", str(tmp_path / "port"),
                   "--preset", "pr3", *_set_args(wrong)])
    assert not os.path.exists(tmp_path / "port")
    with pytest.raises(FileNotFoundError):
        tool.main([str(tmp_path / "none"), "--out", str(tmp_path / "port"),
                   "--preset", "pr3", *_set_args(over)])

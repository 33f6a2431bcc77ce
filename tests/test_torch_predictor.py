"""The port's serving slice as a whole: its Predictor on the CPU against
the JAX package's Predictor (Pallas kernels in interpret mode, the
space-to-depth stem) for the pr3 model at image_size 64, with the same
seeded weights. Also the config copy, checkpoints, and that the port
never imports JAX."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.api import Predictor as JaxPredictor
from rgb_proprioceptive_pose_estimator_tpu.config import PRESETS as JAX_PRESETS
from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu_torch import Predictor, predict
from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    PRESETS,
    Config,
    preset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)

RTOL, ATOL = 1e-3, 1e-4
MAX_BATCH = 4


class _EvalState:
    """The one TrainState method the JAX Predictor calls."""

    def __init__(self, variables):
        self._variables = variables

    def eval_variables(self):
        return self._variables


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_preset("pr3").override(**{"model.image_size": 64,
                                         "model.use_pallas": True})
    cfg = Config.from_dict(jcfg.to_dict())
    variables = random_jax_variables(cfg.model, seed=0)
    state_dict = state_dict_from_jax(variables, cfg.model)
    jax_pred = JaxPredictor(jcfg, state=_EvalState(variables),
                            model=build_model(jcfg.model),
                            max_batch=MAX_BATCH, allow_missing_cameras=True)
    port_pred = Predictor(cfg, state_dict=state_dict, max_batch=MAX_BATCH,
                          device="cpu", allow_missing_cameras=True)
    return {"cfg": cfg, "state_dict": state_dict, "jax": jax_pred,
            "port": port_pred}


def _obs(n, seed, with_camera=True):
    rs = np.random.RandomState(seed)
    shape = (64, 64, 3) if n is None else (n, 64, 64, 3)
    pshape = (32,) if n is None else (n, 32)
    obs = {"images": {}, "proprio": rs.randn(*pshape).astype(np.float32)}
    if with_camera:
        obs["images"]["agentview"] = rs.randint(0, 256, shape, np.uint8)
    return obs


@pytest.mark.parametrize("case", ["unbatched", "batch", "more_than_max_batch",
                                  "camera_absent"])
def test_port_predictor_matches_jax_predictor(pair, case):
    n = {"unbatched": None, "batch": 3, "more_than_max_batch": 2 * MAX_BATCH + 1,
         "camera_absent": 3}[case]
    obs = _obs(n, seed=len(case), with_camera=case != "camera_absent")
    jpos, jquat = pair["jax"](obs)
    pos, quat = pair["port"](obs)
    assert pos.dtype == quat.dtype == np.float32
    assert pos.shape == jpos.shape and quat.shape == jquat.shape
    np.testing.assert_allclose(pos, jpos, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(quat, jquat, rtol=RTOL, atol=ATOL)


def test_missing_camera_raises_unless_allowed(pair):
    strict = Predictor(pair["cfg"], state_dict=pair["state_dict"],
                       device="cpu")
    with pytest.raises(KeyError, match="missing cameras"):
        strict(_obs(2, seed=0, with_camera=False))


def test_checkpoint_round_trip_serves_the_same_poses(pair, tmp_path):
    path = str(tmp_path / "pr3.pt")
    checkpoint.save(path, pair["cfg"], pair["state_dict"])
    cfg, state_dict = checkpoint.load(path)
    assert cfg == pair["cfg"]
    obs = _obs(2, seed=7)
    want = pair["port"](obs)
    got = Predictor(cfg, ckpt_path=path, device="cpu")(obs)
    one_shot = predict(cfg, obs, ckpt_path=path, device="cpu")
    for a, b, c in zip(want, got, one_shot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_predictor_warmup_runs_and_chains(pair):
    assert pair["port"].warmup() is pair["port"]


def test_predictor_without_device_raises_when_cuda_is_absent(pair,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(pair["cfg"], state_dict=pair["state_dict"])


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_config_copy_matches_jax_presets(name):
    cfg = preset(name)
    assert cfg.to_dict() == jax_preset(name).to_dict()
    assert Config.from_dict(cfg.to_dict()) == cfg
    dotted = {"model.head_hidden": "64,32", "train.lr": 3e-4}
    assert (cfg.override(**dotted).to_dict()
            == jax_preset(name).override(**dotted).to_dict())


def test_preset_names_match():
    assert sorted(PRESETS) == sorted(JAX_PRESETS)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.api\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.cli\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.models.cnn_small\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.models.lstm\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.ops.pose_math\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.checkpoint\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.prof\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.engine.state\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused_bn\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.parallel.dist\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.data.cache_shard\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.ops.image_augment_device\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.serve\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.models.vit\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.export\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.sweep\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.utils.viz\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.data.repack\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.data.playback\n"
        "ref = 'rgb_proprioceptive_pose_estimator_tpu'\n"
        "# the card's host has no h5py, matplotlib or mujoco and may have no\n"
        "# OpenCV (the server imports it to decode jpeg/png alone); optax is\n"
        "# the JAX package's optimizer\n"
        "banned = ('jax', 'flax', 'optax', 'h5py', 'cv2', 'matplotlib',\n"
        "          'mujoco')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in banned\n"
        "             or m == ref or m.startswith(ref + '.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout
    # the check itself must see the JAX package when it is imported
    out = subprocess.run(
        [sys.executable, "-c",
         code.replace("import sys\n", "import sys\nimport "
                      "rgb_proprioceptive_pose_estimator_tpu.config\n")],
        capture_output=True, text=True, timeout=120, check=True)
    assert "rgb_proprioceptive_pose_estimator_tpu" in out.stdout.split(",")

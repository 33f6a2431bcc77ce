"""The port's model modules against their JAX counterparts on the CPU, in
eval mode, f32, at image_size 64 with the real pr3 widths. The JAX side
runs as its own tests run it: Pallas kernels in interpret mode and the
space-to-depth stem (pr3's stem_s2d=True). Both sides get the same
weights, made from a seed by ``random_jax_variables`` and converted with
``state_dict_from_jax``. Tolerance: rtol 1e-3, atol 1e-4, as in
tests/parity/test_e2e_model_parity.py."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.models.blocks import (
    BatchNormAct as JaxBatchNormAct,
)
from rgb_proprioceptive_pose_estimator_tpu.models.blocks import (
    ConvBNReLU as JaxConvBNReLU,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import (
    build_model,
    example_batch,
)
from rgb_proprioceptive_pose_estimator_tpu.models.proprio_mlp import (
    ProprioMLP as JaxProprioMLP,
)
from rgb_proprioceptive_pose_estimator_tpu.models.resnet import (
    ResNet18 as JaxResNet18,
)
from rgb_proprioceptive_pose_estimator_tpu.ops.pose_math import (
    quat_normalize as jax_quat_normalize,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    BatchNormAct,
    ConvBNReLU,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.proprio_mlp import (
    ProprioMLP,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import ResNet18
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.pose_math import (
    quat_normalize,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)

RTOL, ATOL = 1e-3, 1e-4
ENC = "encoder_agentview"


def _cfgs(**overrides):
    """(JAX config, port config) of pr3 at 64 px, Pallas on, plus overrides."""
    dotted = {"model.image_size": 64, "model.use_pallas": True, **overrides}
    jcfg = jax_preset("pr3").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def pr3():
    jcfg, cfg = _cfgs()
    variables = random_jax_variables(cfg.model, seed=0)
    return {"jcfg": jcfg, "cfg": cfg, "variables": variables,
            "state_dict": state_dict_from_jax(variables, cfg.model)}


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


def _sub_sd(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", [True, False])
def test_batchnorm_act_matches_jax(pr3, act):
    path = ("stem", "bn") if act else ("stage1_block0", "conv2", "bn")
    x = np.random.RandomState(0).randn(2, 8, 8, 64).astype(np.float32)
    ref = JaxBatchNormAct(act=act, use_pallas=True).apply(
        _sub(pr3["variables"], ENC, *path), jnp.asarray(x), train=False)
    bn = BatchNormAct(64, act=act).eval()
    bn.load_state_dict(_sub_sd(pr3["state_dict"], f"{ENC}.{'.'.join(path)}."))
    with torch.no_grad():
        out = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1), ref)


def test_batchnorm_act_train_mode_raises():
    # train mode runs (tests/test_torch_train.py); what it raises on is an
    # activation whose channels are not innermost, on the two routes whose
    # kernels need them so (the matmul route takes any layout)
    x = torch.zeros(1, 4, 2, 2)                       # NCHW-contiguous
    for route in ("reduce", "pallas"):
        with pytest.raises(ValueError, match="channels_last"):
            BatchNormAct(4, stats_impl=route)(x)
    assert BatchNormAct(4, stats_impl="matmul")(x).shape == x.shape
    with pytest.raises(ValueError, match="stats_impl"):
        BatchNormAct(4, stats_impl="welford")


def test_conv_bn_relu_matches_jax(pr3):
    # stage 2's first conv: 64 -> 128, 3x3, stride 2, symmetric pad 1
    x = np.random.RandomState(1).randn(2, 16, 16, 64).astype(np.float32)
    ref = JaxConvBNReLU(128, (3, 3), (2, 2), padding=[(1, 1), (1, 1)],
                        use_pallas=True).apply(
        _sub(pr3["variables"], ENC, "stage2_block0", "conv1"),
        jnp.asarray(x), train=False)
    m = ConvBNReLU(64, 128, (3, 3), (2, 2), (1, 1)).eval()
    m.to(memory_format=torch.channels_last)
    m.load_state_dict(_sub_sd(pr3["state_dict"], f"{ENC}.stage2_block0.conv1."))
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.is_contiguous(memory_format=torch.channels_last)
    _close(out.permute(0, 2, 3, 1), ref)


def test_resnet18_encoder_matches_jax_s2d_stem(pr3):
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    ref = JaxResNet18(features=512, use_pallas=True, stem_s2d=True).apply(
        _sub(pr3["variables"], ENC), jnp.asarray(x), train=False)
    enc = ResNet18(features=512).eval()
    enc.load_state_dict(_sub_sd(pr3["state_dict"], f"{ENC}."))
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    assert out.shape == (2, 512)
    _close(out, ref)


def test_proprio_mlp_matches_jax(pr3):
    s = np.random.RandomState(3).randn(4, 32).astype(np.float32)
    ref = JaxProprioMLP(hidden=(256, 256), features=128, normalize=True).apply(
        _sub(pr3["variables"], "proprio"), jnp.asarray(s))
    m = ProprioMLP(32, hidden=(256, 256), features=128, normalize=True).eval()
    m.load_state_dict(_sub_sd(pr3["state_dict"], "proprio."))
    with torch.no_grad():
        out = m(torch.from_numpy(s))
    _close(out, ref)


def _batch(cfg, n, seed):
    b = example_batch(cfg.model, batch_size=n, rng=seed)
    return {k: b[k] for k in ("images", "proprio")}


def _to_torch(batch):
    out = {"images": {c: torch.from_numpy(v)
                      for c, v in batch["images"].items()},
           "proprio": torch.from_numpy(batch["proprio"])}
    if "camera_mask" in batch:
        out["camera_mask"] = torch.from_numpy(batch["camera_mask"])
    return out


def _pose_parity(jcfg, cfg, variables, state_dict, batch):
    jpos, jquat = jax.jit(
        lambda v, b: build_model(jcfg.model).apply(v, b, train=False)
    )(variables, batch)
    model = PoseEstimator(cfg.model).eval()
    model.load_state_dict(state_dict)
    with torch.no_grad():
        pos, quat = model(_to_torch(batch))
    assert pos.dtype == quat.dtype == torch.float32
    _close(pos, jpos)
    _close(quat, jquat)


@pytest.mark.parametrize("case", ["all_live", "camera_mask", "camera_absent"])
def test_pose_estimator_matches_jax(pr3, case):
    batch = _batch(pr3["cfg"], 3, seed=4)
    if case == "camera_mask":
        batch["camera_mask"] = np.array([[1.0], [0.0], [1.0]], np.float32)
    if case == "camera_absent":
        batch["images"] = {}
    _pose_parity(pr3["jcfg"], pr3["cfg"], pr3["variables"],
                 pr3["state_dict"], batch)


def test_pose_estimator_channel_stacked_frames_matches_jax():
    jcfg, cfg = _cfgs(**{"model.image_size": 32, "model.temporal_frames": 2,
                         "model.temporal_mode": "channel"})
    variables = random_jax_variables(cfg.model, seed=5)
    _pose_parity(jcfg, cfg, variables,
                 state_dict_from_jax(variables, cfg.model),
                 _batch(cfg, 2, seed=5))


@pytest.mark.parametrize("overrides", [
    {},
    {"model.temporal_frames": 2, "model.temporal_mode": "channel",
     "model.cameras": ("agentview", "robot0_eye_in_hand")},
])
def test_random_jax_variables_have_the_jax_tree(overrides):
    jcfg, cfg = _cfgs(**overrides)
    model = build_model(jcfg.model)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           example_batch(jcfg.model, 2), train=False))
    ref = jax.tree.map(lambda a: tuple(a.shape), shapes)
    ours = jax.tree.map(lambda a: tuple(a.shape),
                        random_jax_variables(cfg.model, seed=0))
    assert ours == ref


@pytest.mark.parametrize("fault", ["missing", "extra", "shape",
                                   "unknown_stat", "unknown_collection"])
def test_state_dict_from_jax_is_strict(pr3, fault):
    v = copy.deepcopy(pr3["variables"])
    if fault == "missing":
        del v["params"]["pose_out"]["bias"]
    elif fault == "extra":
        v["params"]["head9"] = {"kernel": np.zeros((4, 4), np.float32)}
    elif fault == "shape":
        v["params"]["pose_out"]["bias"] = np.zeros(9, np.float32)
    elif fault == "unknown_stat":
        v["batch_stats"]["proprio"]["count"] = np.zeros(1, np.float32)
    else:
        v["cache"] = {}
    with pytest.raises(ValueError):
        state_dict_from_jax(v, pr3["cfg"].model)


_SMALL_VIT = {"model.backbone": "vit", "model.image_size": 32,
              "model.vit_patch": 8, "model.vit_dim": 32, "model.vit_heads": 4}


@pytest.mark.parametrize("overrides", [
    {"model.proprio_dropout": 0.1},
    {**_SMALL_VIT, "model.vit_depth": 2},
    {**_SMALL_VIT, "model.vit_depth": 1, "model.vit_pool": "mean"},
    {**_SMALL_VIT, "model.vit_depth": 1, "model.vit_pool": "cls"},
])
def test_options_outside_the_slice_raise(overrides):
    """The ViT backbone (ROADMAP queue A, item 10) builds and
    serves the JAX package's poses from the same weights, in both pools.
    Proprio dropout, in the port since item 9, raises at a train-mode
    forward without the generator its mask is drawn from, draws one with
    it, and is the identity in eval mode."""
    jcfg, cfg = _cfgs(**overrides)
    if cfg.model.backbone == "vit":
        variables = random_jax_variables(cfg.model, seed=9)
        _pose_parity(jcfg, cfg, variables,
                     state_dict_from_jax(variables, cfg.model),
                     _batch(cfg, 2, seed=9))
        return
    batch = example_batch(jcfg.model, batch_size=2)
    batch = {"images": {k: torch.from_numpy(v)
                        for k, v in batch["images"].items()},
             "proprio": torch.from_numpy(batch["proprio"])}
    model = PoseEstimator(cfg.model)
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train()(batch)
    with torch.no_grad():
        drawn = model.train()(batch, generator=torch.Generator())
        served = model.eval()(batch)
        plain = PoseEstimator(cfg.model.__class__(**{
            **cfg.model.__dict__, "proprio_dropout": 0.0}))
        plain.load_state_dict(model.state_dict())
        want = plain.eval()(batch)
    assert all(torch.isfinite(t).all() for t in drawn)
    for got, w in zip(served, want):
        assert torch.equal(got, w)


def test_quat_normalize_matches_jax_including_zero():
    q = np.random.RandomState(6).randn(5, 4).astype(np.float32)
    q[2] = 0.0
    ref = jax_quat_normalize(jnp.asarray(q))
    out = quat_normalize(torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert np.all(np.isfinite(out.numpy()))

"""The port's ViT backbone (``models/vit.py``, ``model.backbone="vit"``) on
the CPU, held against the JAX package's ``models/vit.py``.

A small ViT (32 px, patch 8, dim 32, depth 2, 4 heads) in f32, weights
made from a numpy seed in the JAX layout and carried by
``utils/convert.py``. The port computes flax's LayerNorm (epsilon 1e-6,
the variance as E[x^2] - E[x]^2 in f32), so nothing but the order of f32
sums separates the two: the encoder and the pose within rtol 1e-5, atol
2e-6 of each other, losses of a fit within rtol 1e-5, its parameters
within rtol 2e-5, atol 2e-6 (the tolerances of tests/test_torch_extras.py).
Torch runs on one intra-op thread.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rgb_proprioceptive_pose_estimator_tpu.config import ModelConfig as JaxModelConfig
from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.loop import fit as jax_fit
from rgb_proprioceptive_pose_estimator_tpu.engine.state import (
    create_state as jax_create_state,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    frozen_prefixes_for as jax_frozen_prefixes_for,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_train_step as jax_make_train_step,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.models.vit import ViT as JaxViT
from rgb_proprioceptive_pose_estimator_tpu.utils.torch_import import (
    load_pretrained_backbone as jax_load_pretrained_backbone,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config, ModelConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    forward_backward,
    train_step,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.vit import ViT
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    jax_variables,
    port_arrays,
    random_jax_variables,
    random_variables_for,
    state_dict_from_jax,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import import (
    load_pretrained_backbone,
    load_state_dict_file,
)

RTOL, ATOL = 1e-5, 2e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
BATCH = 8
SMALL = {"model.backbone": "vit", "model.image_size": 32,
         "model.vit_patch": 8, "model.vit_dim": 32, "model.vit_depth": 2,
         "model.vit_heads": 4, "model.image_features": 32,
         "model.dtype": "float32"}
VIT = dict(patch=8, dim=32, depth=2, heads=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(name="pr3", **overrides):
    """(JAX config, port config): ``name`` with the small ViT."""
    jcfg = jax_preset(name).override(**{**SMALL, **overrides})
    return jcfg, Config.from_dict(jcfg.to_dict())


def _port_vit(pool, channels, seed):
    """The port's small ViT with seeded weights, and those weights as the
    JAX package's variables."""
    model = ViT(features=32, image_size=32, in_channels=channels, pool=pool,
                **VIT)
    variables = random_variables_for(
        {k: tuple(v.shape) for k, v in model.state_dict().items()}, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           port_arrays(variables).items()})
    return model, variables


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("frames", [1, 3], ids=["T1", "T3 stacked"])
@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_vit_matches_jax(pool, frames):
    model, variables = _port_vit(pool, 3 * frames, seed=frames)
    x = np.random.RandomState(7).randn(3, 32, 32, 3 * frames).astype(
        np.float32)
    want = JaxViT(features=32, pool=pool, **VIT).apply(variables, x)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (3, 32) and got.dtype == torch.float32
    _close(got, want)


def test_remat_equals_the_plain_model():
    """model.remat recomputes each block in the backward: the same loss and
    gradients, bit for bit."""
    model, _ = _port_vit("cls", 3, seed=2)
    remat = ViT(features=32, image_size=32, pool="cls", remat=True, **VIT)
    remat.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 32, 32, 3)
                         .astype(np.float32))
    grads = []
    for m in (model, remat):
        m.train().zero_grad()
        loss = m(x).square().sum()
        loss.backward()
        grads.append((loss.detach(), {k: p.grad.clone() for k, p in
                                      m.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for k, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][k]), k


def _batch(model_cfg, n, seed, cameras=None):
    rs = np.random.RandomState(seed)
    lead = (n, model_cfg.temporal_frames) if model_cfg.temporal_frames > 1 \
        else (n,)
    hw = model_cfg.image_size
    return {"images": {c: rs.randint(0, 256, lead + (hw, hw, 3), np.uint8)
                       for c in cameras or model_cfg.cameras},
            "proprio": rs.randn(*lead, model_cfg.proprio_dim).astype(
                np.float32)}


def _torch_batch(batch):
    return {k: ({c: torch.from_numpy(v) for c, v in val.items()}
                if isinstance(val, dict) else torch.from_numpy(val))
            for k, val in batch.items()}


@pytest.mark.parametrize("case", ["lstm", "camera_dropout", "cls_two_cams"])
def test_pose_estimator_with_vit_matches_jax(case):
    """The LSTM mode (each frame through the ViT, then the LSTM) and
    camera dropout (a train-mode forward with an injected keep mask, held
    against the JAX model fed camera_mask = keep) go through the ViT as
    they do through the ResNet."""
    cams = ("agentview", "robot0_eye_in_hand")
    over = {"lstm": {"model.temporal_frames": 2,
                     "model.temporal_mode": "lstm"},
            "camera_dropout": {"model.cameras": cams,
                               "model.camera_dropout": 0.5},
            "cls_two_cams": {"model.cameras": cams,
                             "model.vit_pool": "cls"}}[case]
    jcfg, cfg = _cfgs(**over)
    variables = random_jax_variables(cfg.model, seed=11)
    batch = _batch(cfg.model, 4, seed=12)
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict_from_jax(variables, cfg.model))
    tb = _torch_batch(batch)
    if case == "camera_dropout":
        keep = np.array([[1, 0], [0, 1], [1, 1], [0, 0]], np.float32)
        tb["camera_keep"] = torch.from_numpy(keep)
        model.train()
        jcfg = jcfg.override(**{"model.camera_dropout": 0.0})
        batch = {**batch, "camera_mask": keep}
    else:
        model.eval()
    jpos, jquat = build_model(jcfg.model).apply(variables, batch,
                                                train=False)
    with torch.no_grad():
        pos, quat = model(tb)
    _close(pos, jpos, what="pos")
    _close(quat, jquat, what="quat")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("vit_demo") / "demo.hdf5"),
        n_demos=3, steps=20, image_hw=40, seed=0)


def _fit_cfgs(path, ckpt_root, steps, **overrides):
    """(JAX config, port config): pr3 with the small ViT on the demo
    fixture, batch 8, SGD, numpy augmentation on both sides, an eval at
    the last step; each package in its own directory under ckpt_root."""
    dotted = {**SMALL, "data.path": path, "data.batch_size": BATCH,
              "data.num_workers": 2, "data.use_native": False,
              "data.val_fraction": 0.34, "train.optimizer": "sgd",
              "train.lr": 1e-2, "train.grad_clip": 0.0,
              "train.lr_schedule": "constant", "train.warmup_steps": 0,
              "train.steps": steps, "train.steps_per_call": 1,
              "train.log_every": 1, "train.eval_every": steps,
              "train.eval_steps": 1, "train.ckpt_every": 0,
              "dist.num_devices": 1, **overrides}
    jcfg = jax_preset("pr3").override(**{
        **dotted, "train.ckpt_dir": os.path.join(ckpt_root, "jax")})
    cfg = Config.from_dict(jcfg.to_dict()).override(**{
        "train.ckpt_dir": os.path.join(ckpt_root, "port")})
    return jcfg, cfg


def _rows(d, key):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _jax_to_port(cfg, params, batch_stats):
    return state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, batch_stats)}, cfg.model)


def test_fit_with_ema_and_recalibration_matches_jax(demo_h5, tmp_path):
    """A 3-step fit of pr3 with the ViT in both packages from the JAX
    package's initial weights, the EMA and recalibration on: a BN-free
    model with proprio statistics recalibrates (consuming its batches)
    as the reference does, the losses and the final parameters and EMA
    agree."""
    jcfg, cfg = _fit_cfgs(demo_h5, str(tmp_path), 3, **{
        "train.ema_decay": 0.5, "train.ema_bn_recal_batches": 1})
    want = jax_fit(jcfg)["state"]
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    state = create_state(cfg, torch.device("cpu"), state_dict_from_jax(
        jax.tree.map(np.asarray, init), cfg.model))
    out = loop.train_on(cfg, state, build_dataset(cfg, "train"),
                        build_dataset(cfg, "val"))
    for key in ("train/loss", "eval/loss"):
        np.testing.assert_allclose(_rows(cfg.train.ckpt_dir, key),
                                   _rows(jcfg.train.ckpt_dir, key),
                                   rtol=LOSS_RTOL, err_msg=key)
    params = _jax_to_port(cfg, want.params, want.batch_stats)
    ema = _jax_to_port(cfg, want.ema_params, want.batch_stats)
    for k, p in out["state"].model.named_parameters():
        _close(p.detach(), params[k], PARAM_RTOL, PARAM_ATOL, k)
        _close(out["state"].ema[k], ema[k], PARAM_RTOL, PARAM_ATOL, k)
    training = checkpoint.load_training(out["ckpt_path"])[2]
    # one eval and the final save, one recalibration batch each
    assert training["pipeline"]["consumed"] == 3 + 2


def test_freeze_backbone_steps_match_jax():
    """model.freeze_backbone with the ViT: the encoder's parameters stay,
    the rest follow the JAX package's three SGD steps."""
    jcfg, cfg = _cfgs(**{"model.freeze_backbone": True,
                         "data.batch_size": BATCH, "train.optimizer": "sgd",
                         "train.lr": 1e-2, "train.grad_clip": 0.0,
                         "train.weight_decay": 0.0,
                         "train.lr_schedule": "constant",
                         "train.warmup_steps": 0, "dist.num_devices": 1})
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model,
                                                              seed=21))
    rs = np.random.RandomState(22)
    batches = []
    for _ in range(3):
        b = _batch(cfg.model, BATCH, rs.randint(1 << 30))
        q = rs.randn(BATCH, 4)
        b["target_pos"] = rs.uniform(-0.3, 0.3, (BATCH, 3)).astype(np.float32)
        b["target_quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)
                            ).astype(np.float32)
        batches.append(b)
    tx = jax_make_optimizer(jcfg.train, jax_frozen_prefixes_for(jcfg))
    jstate = jax_create_state(jcfg, tx, seed=0)
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(build_model(jcfg.model), tx, jcfg.train)
    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(variables, cfg.model))
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    for b in batches:
        jstate, jm = jstep(jstate, b)
        m = train_step(state, _torch_batch(b), cfg.train)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    want = _jax_to_port(cfg, jstate.params, jstate.batch_stats)
    moved = 0
    for k, p in state.model.named_parameters():
        if k.startswith("encoder_"):
            assert torch.equal(p.detach(), init[k]), k
        else:
            moved += not torch.equal(p.detach(), init[k])
        _close(p.detach(), want[k], PARAM_RTOL, PARAM_ATOL, k)
    assert moved > 0


def test_train_gradients_match_jax():
    """One train-mode forward and backward: every parameter's gradient
    within 1e-5 of that tensor's largest (GELU and LayerNorm have no
    ReLU's ties). The key's bias adds one term to all scores of a query,
    which the softmax removes: its gradient is 0 in exact arithmetic and
    rounding noise in both packages, held below 1e-6 of the largest
    gradient of the model instead."""
    from rgb_proprioceptive_pose_estimator_tpu.losses.pose import (
        pose_loss as jax_pose_loss,
    )

    jcfg, cfg = _cfgs(**{"model.vit_pool": "cls"})
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model,
                                                              seed=31))
    batch = _batch(cfg.model, 6, seed=32)
    rs = np.random.RandomState(33)
    q = rs.randn(6, 4)
    batch["target_pos"] = rs.uniform(-0.3, 0.3, (6, 3)).astype(np.float32)
    batch["target_quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)
                            ).astype(np.float32)
    model, t = build_model(jcfg.model), jcfg.train

    def loss_fn(params):
        (pos, quat), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return jax_pose_loss(pos, quat, batch["target_pos"],
                             batch["target_quat"], pos_weight=t.pos_weight,
                             rot_weight=t.rot_weight, rot_loss=t.rot_loss,
                             pos_loss=t.pos_loss,
                             huber_delta=t.huber_delta)[0]

    jgrads = jax.grad(loss_fn)(variables["params"])
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]}, cfg.model)
    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(variables, cfg.model))
    forward_backward(state.model, _torch_batch(batch), cfg.train)
    largest = max(float(v.abs().max()) for v in want.values())
    for k, p in state.model.named_parameters():
        w = want[k].numpy()
        if k.endswith("attn.key.bias"):
            assert max(np.abs(w).max(), p.grad.abs().max()) <= 1e-6 * largest
            continue
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (k, err, np.abs(w).max())


# ---------------------------------------------------------------------------
# torchvision weights, the converter, validation
# ---------------------------------------------------------------------------


def test_init_from_torch_vit_matches_the_reference_and_resumes(demo_h5,
                                                               tmp_path):
    """train.init_from_torch with a torchvision VisionTransformer
    state_dict: the port's import equals the JAX package's (packed
    in_proj split per head), the classifier is dropped, and a BN-free
    import leaves a checkpoint that a fresh state restores, so the run
    resumes (the reference's ADVICE r3 guard)."""
    over = {"model.vit_pool": "cls",
            "model.cameras": ("agentview", "robot0_eye_in_hand")}
    _, cfg = _cfgs(**over)
    sd = chip_smoke.torchvision_vit(5, 32, 8, 32, 2, 4)
    path = str(tmp_path / "vit.npz")
    np.savez(path, **sd)
    variables = random_jax_variables(cfg.model, seed=6)
    for cam in cfg.model.cameras:
        variables = jax_load_pretrained_backbone(
            variables, cam, sd, "vit", depth=2, heads=4)
    assert "batch_stats" not in variables or not any(
        k.startswith("encoder_") for k in variables["batch_stats"])
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables),
                               cfg.model)
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict_from_jax(
        random_jax_variables(cfg.model, seed=6), cfg.model))
    for cam in cfg.model.cameras:
        load_pretrained_backbone(model, cam, load_state_dict_file(path),
                                 "vit")
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # a shallower import than the encoder, and another image size
    with pytest.raises(ValueError, match="blocks left uninitialized"):
        load_pretrained_backbone(model, "agentview", sd, "vit", depth=1)
    _, big = _cfgs(**{**over, "model.image_size": 64})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_backbone(PoseEstimator(big.model), "agentview", sd,
                                 "vit")

    jcfg, fcfg = _fit_cfgs(demo_h5, str(tmp_path), 2, **{
        **over, "train.init_from_torch": path, "train.ckpt_every": 2,
        "train.eval_every": 0})
    warm = create_state(fcfg, torch.device("cpu"))
    loop.warm_start(fcfg, warm)
    assert torch.equal(warm.model.encoder_agentview.cls_token.detach(),
                       torch.from_numpy(sd["class_token"]))
    out = api.train(fcfg, device="cpu")
    fresh = create_state(fcfg, torch.device("cpu"))
    loop.restore_training(fresh, out["ckpt_path"], False)
    assert fresh.step == 2
    out = api.train(fcfg.override(**{"train.steps": 4}), device="cpu")
    assert out["state"].step == 4
    with pytest.raises(ValueError, match="vit_pool='cls'"):
        loop.warm_start(fcfg.override(**{"model.vit_pool": "mean"}),
                        create_state(fcfg.override(**{
                            "model.vit_pool": "mean"}), torch.device("cpu")))


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_convert_round_trip_for_vit_trees(pool):
    """random_jax_variables makes the JAX ViT's tree (shapes of its init);
    state_dict_from_jax and jax_variables carry it there and back bit
    for bit."""
    jcfg, cfg = _cfgs(**{"model.vit_pool": pool,
                         "model.temporal_frames": 3,
                         "model.temporal_mode": "channel"})
    from rgb_proprioceptive_pose_estimator_tpu.models.fusion import (
        example_batch,
    )

    model = build_model(jcfg.model)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), example_batch(jcfg.model, 2), train=False))
    variables = random_jax_variables(cfg.model, seed=41)
    assert (jax.tree.map(lambda a: tuple(a.shape), variables)
            == jax.tree.map(lambda a: tuple(a.shape), shapes))
    back = jax_variables(state_dict_from_jax(variables, cfg.model))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_pos_embed_fixes_the_image_size():
    """A checkpoint taken at one image_size does not load at another
    (pos_embed holds the token count), in either package."""
    _, cfg32 = _cfgs()
    jcfg64, cfg64 = _cfgs(**{"model.image_size": 64})
    variables = random_jax_variables(cfg32.model, seed=1)
    sd = state_dict_from_jax(variables, cfg32.model)
    with pytest.raises(RuntimeError, match="pos_embed"):
        PoseEstimator(cfg64.model).load_state_dict(sd)
    with pytest.raises(ValueError, match="pos_embed"):
        state_dict_from_jax(variables, cfg64.model)
    with pytest.raises(Exception, match="pos_embed"):
        build_model(jcfg64.model).apply(variables,
                                        _batch(cfg64.model, 1, 0),
                                        train=False)


@pytest.mark.parametrize("bad", ["pool", "patch", "heads"])
def test_validation_errors_as_the_reference(bad):
    """pool, patch and heads: the model configs of both packages raise
    ValueError, and so does the port's ViT module (the JAX ViT for pool
    and patch when it is called)."""
    field, value = {"pool": ("vit_pool", "max"),
                    "patch": ("vit_patch", 7),
                    "heads": ("vit_heads", 5)}[bad]
    kw = {"backbone": "vit", "image_size": 32, "vit_patch": 8,
          "vit_dim": 32, "vit_heads": 4, field: value}
    for config in (JaxModelConfig, ModelConfig):
        with pytest.raises(ValueError):
            config(**kw)
    module_kw = {**VIT, "pool": "mean",
                 {"pool": "pool", "patch": "patch",
                  "heads": "heads"}[bad]: value}
    with pytest.raises(ValueError):
        ViT(features=8, image_size=32, **module_kw)
    if bad != "heads":
        x = np.zeros((1, 32, 32, 3), np.float32)
        with pytest.raises(ValueError):
            JaxViT(features=8, **module_kw).init(jax.random.PRNGKey(0), x)

"""The port's training extras on the CPU, held against the JAX package:
``train.grad_accum`` (optax.MultiSteps), the EMA of the parameters with
BatchNorm recalibration, ``model.freeze_backbone``,
``train.flat_optimizer``, warm starts (``train.init_from``,
``train.init_from_torch``), early stopping, ``train.debug_nans``, a
profiler trace window and ``model.proprio_dropout``.

The steps run a tiny pr3 (ResNet-18 at 32 px, global batch 8, f32, SGD at
lr 1e-3) from ``random_jax_variables`` weights on seeded numpy batches in
both packages, at a seed where no ReLU input lies within rounding of 0 in
any case here (the pattern of tests/test_torch_ddp.py: at 10 of 16 seeds
tried, four micro-steps of grad_accum meet such a tie, and the JAX
package's own one- and two-device steps then differ too). Tolerances are that file's: loss
rtol 1e-5, parameters rtol 2e-5 atol 2e-6, running statistics 1e-5 of
their largest magnitude. The fits run pr1 (the proprio-only model on
synthetic data) or pr3 at 32 px on a demo fixture, one intra-op thread."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    make_bn_recal_step as jax_make_bn_recal_step,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_lr_schedule as jax_make_lr_schedule,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_train_step as jax_make_train_step,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    recalibrate_batch_stats as jax_recalibrate_batch_stats,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.utils.torch_import import (
    load_pretrained_backbone as jax_load_pretrained_backbone,
)
from rgb_proprioceptive_pose_estimator_tpu.utils.torch_import import (
    load_state_dict_file as jax_load_state_dict_file,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    create_state,
    serving,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    make_lr_schedule,
    recalibrate_batch_stats,
    train_step,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import import (
    load_pretrained_backbone,
    load_state_dict_file,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
STATS_REL = 1e-5
BATCH = 8
SEED = 72


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(name="pr3", **overrides):
    """(JAX config, port config): ``name`` at 32 px, f32, batch 8, SGD at
    lr 1e-3 without clipping."""
    dotted = {"model.image_size": 32, "model.dtype": "float32",
              "data.batch_size": BATCH, "train.optimizer": "sgd",
              "train.lr": 1e-3, "train.grad_clip": 0.0,
              "train.weight_decay": 0.0, "train.lr_schedule": "constant",
              "train.warmup_steps": 0, "dist.num_devices": 1, **overrides}
    jcfg = jax_preset(name).override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _batches(model_cfg, seed, n):
    rs = np.random.RandomState(seed)
    hw = model_cfg.image_size
    out = []
    for _ in range(n):
        q = rs.randn(BATCH, 4)
        out.append({
            "images": {c: rs.randint(0, 256, (BATCH, hw, hw, 3), np.uint8)
                       for c in model_cfg.cameras},
            "proprio": rs.randn(BATCH, model_cfg.proprio_dim).astype(
                np.float32),
            "target_pos": rs.uniform(-0.3, 0.3, (BATCH, 3)).astype(
                np.float32),
            "target_quat": (q / np.linalg.norm(q, axis=1, keepdims=True)
                            ).astype(np.float32)})
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _jax_state(jcfg, variables):
    tx = jax_make_optimizer(jcfg.train, jax_frozen_prefixes_for(jcfg))
    state = jax_create_state(jcfg, tx, seed=0)
    ema = (jax.tree.map(jnp.copy, variables["params"])
           if jcfg.train.ema_decay > 0 else None)
    return tx, state.replace(params=variables["params"],
                             batch_stats=variables.get("batch_stats", {}),
                             opt_state=tx.init(variables["params"]),
                             ema_params=ema)


def _jax_tree_to_port(cfg, params, batch_stats):
    return state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, batch_stats)}, cfg.model)


_RUNS = {}


def _steps(n, **overrides):
    """``n`` train-step calls of both packages from the same weights on
    the same batches; cached per case."""
    key = (n, tuple(sorted(overrides.items())))
    if key in _RUNS:
        return _RUNS[key]
    jcfg, cfg = _cfgs(**overrides)
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model,
                                                              seed=SEED))
    batches = _batches(cfg.model, SEED + 1, n)
    tx, jstate = _jax_state(jcfg, variables)
    jstep = jax_make_train_step(build_model(jcfg.model), tx, jcfg.train)
    jlosses, jnorms = [], []
    for b in batches:
        jstate, m = jstep(jstate, b)
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m.get("grad_norm", np.nan)))
    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(variables, cfg.model))
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    params_after, losses, norms = [], [], []
    for b in batches:
        m = train_step(state, _tensors(b), cfg.train)
        losses.append(float(m["loss"]))
        norms.append(float(m.get("grad_norm", np.nan)))
        params_after.append({k: v.detach().clone() for k, v in
                             state.model.named_parameters()})
    want = _jax_tree_to_port(cfg, jstate.params, jstate.batch_stats)
    want_ema = None
    if jstate.ema_params is not None:
        want_ema = _jax_tree_to_port(cfg, jstate.ema_params,
                                     jstate.batch_stats)
    out = {"cfg": cfg, "jcfg": jcfg, "variables": variables,
           "batches": batches, "state": state, "init": init,
           "losses": losses, "jax_losses": jlosses, "want": want,
           "grad_norms": norms, "jax_grad_norms": jnorms,
           "want_ema": want_ema, "params_after": params_after,
           "jstate": jstate}
    _RUNS[key] = out
    return out


def _assert_params_close(got, want, what, keys=None):
    for k in keys or got:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {k}")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _assert_stats_close(got, want, what):
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        assert _rel_err(got[k], want[k]) <= STATS_REL, (what, k)


# ---------------------------------------------------------------------------
# grad_accum and the EMA against optax.MultiSteps
# ---------------------------------------------------------------------------

ACCUM = {"train.grad_accum": 2, "train.ema_decay": 0.9,
         "train.log_grad_norm": True}


def test_grad_accum_matches_optax_multisteps():
    run = _steps(4, **ACCUM)
    np.testing.assert_allclose(run["losses"], run["jax_losses"],
                               rtol=LOSS_RTOL)
    params = dict(run["state"].model.named_parameters())
    _assert_params_close(params, run["want"], "grad_accum", list(params))
    # the first micro-step of each update leaves the weights as they were
    init, after = run["init"], run["params_after"]
    for k in params:
        assert torch.equal(after[0][k], init[k]), k
        assert torch.equal(after[2][k], after[1][k]), k
    assert sum(not torch.equal(after[1][k], init[k]) for k in params) > 0.9 * len(params)
    assert run["state"].optimizer.count == 2
    assert run["state"].step == 4


def test_grad_norm_is_each_micro_steps_as_the_reference():
    """train.log_grad_norm under grad_accum: the norm of the gradient
    each call computed (optax.MultiSteps' input), not of the sum so
    far."""
    run = _steps(4, **ACCUM)
    np.testing.assert_allclose(run["grad_norms"], run["jax_grad_norms"],
                               rtol=LOSS_RTOL)


def test_grad_accum_updates_running_stats_every_micro_step():
    run = _steps(4, **ACCUM)
    _assert_stats_close(run["state"].model.state_dict(), run["want"],
                        "grad_accum")


def test_ema_holds_between_micro_steps_as_the_reference():
    """d * ema + (1 - d) * params after each update, held on the
    micro-steps between (the reference's ``mini_step == 0`` rule)."""
    run = _steps(4, **ACCUM)
    ema = run["state"].ema
    _assert_params_close(ema, run["want_ema"], "ema", list(ema))
    # the formula, from the weights after each update
    d, e = 0.9, {k: v.clone() for k, v in run["init"].items()}
    for i in (1, 3):
        for k in ema:
            e[k] = d * e[k] + (1 - d) * run["params_after"][i][k]
    for k in ema:
        torch.testing.assert_close(ema[k], e[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", [
    {"train.warmup_steps": 3},
    {"train.lr_schedule": "cosine", "train.warmup_steps": 5},
    {"train.lr_schedule": "multistep", "train.lr_decay_steps": (5, 9)},
])
def test_lr_schedule_counts_updates_under_grad_accum(case):
    over = {"train.grad_accum": 4, "train.steps": 40, "train.lr": 0.1,
            **case}
    jcfg, cfg = _cfgs("pr1", **over)
    ours, ref = make_lr_schedule(cfg.train), jax_make_lr_schedule(jcfg.train)
    for count in range(12):
        # optax evaluates the cosine in f32: a few of its ulps
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=2e-6, atol=1e-12,
                                   err_msg=f"count {count}")


# ---------------------------------------------------------------------------
# fits: resume mid-accumulation, the EMA across runs, recalibration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("extras_demo") / "demo.hdf5"),
        n_demos=3, steps=20, image_hw=40, seed=0)


def _fit_cfg(path, ckpt_dir, steps, **overrides):
    """pr3 at 32 px on the demo fixture, batch 8, SGD, an eval every 2
    steps on a held-out demo."""
    return Config.from_dict(jax_preset("pr3").override(**{
        "model.image_size": 32, "model.dtype": "float32",
        "data.path": path, "data.batch_size": BATCH, "data.num_workers": 2,
        "data.val_fraction": 0.34, "train.optimizer": "sgd",
        "train.lr": 1e-2, "train.steps": steps, "train.steps_per_call": 1,
        "train.log_every": 1,
        "train.eval_every": 2, "train.eval_steps": 1, "train.ckpt_every": 3,
        "train.ckpt_dir": ckpt_dir, "dist.num_devices": 1,
        **overrides}).to_dict())


def _assert_equal(a, b, where=""):
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


RESUME = {"train.grad_accum": 2, "train.ema_decay": 0.9,
          "train.ema_bn_recal_batches": 2, "model.proprio_dropout": 0.1}


def test_resume_mid_accumulation_equals_the_straight_run(demo_h5, tmp_path):
    """The cadence checkpoint at micro-step 3 of k=2 holds the gradient
    sum and the micro-step count; a run resumed from it ends where the
    straight one does, bit for bit (weights, EMA, recalibrated
    statistics, optimizer, sampler; proprio dropout's masks are drawn per
    step). The checkpoint is the straight run's own: a run that ends at
    step 3 would ship recalibrated statistics and have consumed the
    recalibration's batches, as in the reference."""
    straight = api.train(_fit_cfg(demo_h5, str(tmp_path / "s"), 6, **RESUME),
                         device="cpu")
    mid = str(tmp_path / "s" / "step_00000003.pt")
    opt = checkpoint.load_training(mid)[2]["optimizer"]
    assert opt["mini_step"] == 1 and opt["count"] == 1
    assert any(g is not None and torch.any(g != 0)
               for g in opt["accumulated"])
    os.makedirs(tmp_path / "r")
    shutil.copy(mid, tmp_path / "r")
    resumed = api.train(_fit_cfg(demo_h5, str(tmp_path / "r"), 6, **RESUME),
                        device="cpu")
    a = checkpoint.load_training(straight["ckpt_path"])
    b = checkpoint.load_training(resumed["ckpt_path"])
    _assert_equal(a[1], b[1], "state_dict")
    _assert_equal(a[2], b[2], "training")
    assert a[2]["step"] == 6 and a[2]["optimizer"]["count"] == 3


def test_ema_toggled_between_runs_follows_the_reference(demo_h5, tmp_path):
    """Switched on at a resume, the EMA starts at the restored parameters;
    switched off, the checkpoint's is dropped and the raw weights serve."""
    off = {"train.ema_decay": 0.0}
    d = str(tmp_path / "on")
    api.train(_fit_cfg(demo_h5, d, 3, **off), device="cpu")
    _, raw3, _ = checkpoint.load_training(
        os.path.join(d, "step_00000003.pt"))
    out = api.train(_fit_cfg(demo_h5, d, 4, **{"train.ema_decay": 0.5}),
                    device="cpu")
    _, raw4, tr = checkpoint.load_training(out["ckpt_path"])
    for k, e in tr["ema"].items():
        torch.testing.assert_close(e, 0.5 * raw3[k] + 0.5 * raw4[k],
                                   rtol=1e-6, atol=1e-7)
    # served: the EMA's parameters, the raw buffers
    _, served = checkpoint.load(out["ckpt_path"])
    for k, v in served.items():
        assert torch.equal(v, tr["ema"].get(k, raw4[k])), k
    out = api.train(_fit_cfg(demo_h5, d, 5, **off), device="cpu")
    _, raw5, tr5 = checkpoint.load_training(out["ckpt_path"])
    assert "ema" not in tr5 and out["state"].ema is None
    _assert_equal(checkpoint.load(out["ckpt_path"])[1], raw5)


def test_ema_serves_in_predictor_and_evaluate(demo_h5, tmp_path):
    cfg = _fit_cfg(demo_h5, str(tmp_path / "e"), 2,
                   **{"train.ema_decay": 0.5})
    out = api.train(cfg, device="cpu")
    state = out["state"]
    assert state.ema is not None
    served = api.Predictor(cfg, state=state, device="cpu").model
    for k, e in state.ema.items():
        assert torch.equal(served.state_dict()[k], e), k
    got = api.evaluate(cfg, device="cpu")
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state.serving_state_dict())
    want = api.evaluate_on(cfg, model.eval(), build_dataset(cfg, "val"),
                           step=2)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)


def test_bn_recalibration_matches_the_reference():
    """Recalibrated statistics for the EMA weights equal the JAX
    package's recalibrate_batch_stats on the same batches; the model's
    own statistics are left as they were."""
    run = _steps(4, **ACCUM)
    jcfg, cfg = run["jcfg"], run["cfg"]
    jstate = run["jstate"]
    recal = _batches(cfg.model, SEED + 7, 3)
    want = jax_recalibrate_batch_stats(
        jax_make_bn_recal_step(build_model(jcfg.model), jcfg.train),
        jstate, iter(recal), 3, momentum=jcfg.model.bn_momentum)
    want = _jax_tree_to_port(cfg, jstate.ema_params, want)
    model = run["state"].model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with serving(model, run["state"].ema):
        got = recalibrate_batch_stats(model, (_tensors(b) for b in recal),
                                      seed=0)
    assert len(got) == 2 * 20
    _assert_stats_close(got, want, "recal")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_recalibrated_stats_ship_in_the_final_checkpoint(demo_h5, tmp_path):
    """The final checkpoint's statistics are the cumulative average of
    the per-batch statistics of the served weights on the next train
    batches; the cadence checkpoint before keeps the raw ones."""
    cfg = _fit_cfg(demo_h5, str(tmp_path / "b"), 4, **{
        "train.ema_decay": 0.5, "train.ema_bn_recal_batches": 2,
        "train.ckpt_every": 2, "train.eval_every": 0})
    out = api.train(cfg, device="cpu")
    _, final, tr = checkpoint.load_training(out["ckpt_path"])
    assert tr["pipeline"]["consumed"] == 4 + 2
    # the same recalibration by hand, from the step-4 weights
    cut = cfg.override(**{"train.ema_bn_recal_batches": 0,
                          "train.ckpt_dir": str(tmp_path / "raw")})
    raw = api.train(cut, device="cpu")
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )

    pipe = HostPipeline(build_dataset(cfg, "train"), cfg.data, train=True)
    pipe.load_state_dict({**tr["pipeline"], "consumed": 4})
    model = raw["state"].model
    with serving(model, raw["state"].ema):
        want = recalibrate_batch_stats(model, (next(pipe) for _ in range(2)),
                                       cfg.train.seed)
    pipe.close()
    for k, v in want.items():
        assert torch.equal(final[k], v), k
        assert not torch.equal(final[k], model.state_dict()[k]), k
    # the cadence checkpoint keeps the raw statistics
    _assert_equal(checkpoint.load_training(os.path.join(
        cfg.train.ckpt_dir, "step_00000002.pt"))[1],
        checkpoint.load_training(os.path.join(
            cut.train.ckpt_dir, "step_00000002.pt"))[1])


# ---------------------------------------------------------------------------
# freeze_backbone and flat_optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["no clip", "clip"])
def test_freeze_backbone_matches_the_reference(clip, monkeypatch):
    """Encoders frozen bit for bit, their running statistics updated, the
    rest as optax's multi_transform with set_to_zero (a clip's norm over
    the trainable leaves only), and no gradient into the encoders: K2's
    backward never runs."""
    calls = []
    backward = fused.scale_bias_relu_backward
    monkeypatch.setattr(fused, "scale_bias_relu_backward",
                        lambda *a, **k: calls.append(1) or backward(*a, **k))
    run = _steps(3, **{"model.freeze_backbone": True,
                       "train.grad_clip": clip})
    assert calls == []
    np.testing.assert_allclose(run["losses"], run["jax_losses"],
                               rtol=LOSS_RTOL)
    params = dict(run["state"].model.named_parameters())
    frozen = [k for k in params if k.startswith("encoder_")]
    assert frozen
    for k in frozen:
        assert torch.equal(params[k], run["init"][k]), k
        assert not params[k].requires_grad
    _assert_params_close(params, run["want"], "freeze", list(params))
    got = run["state"].model.state_dict()
    _assert_stats_close(got, run["want"], "freeze")
    assert not torch.equal(got["encoder_agentview.stem.bn.running_mean"],
                           run["init"]["encoder_agentview.stem.bn.running_mean"])


def test_grad_norm_under_freeze_covers_the_frozen_leaves():
    """The reference logs the norm of every gradient, the frozen leaves'
    included; the update still leaves the encoders as they were."""
    run = _steps(2, **{"model.freeze_backbone": True,
                       "train.log_grad_norm": True})
    np.testing.assert_allclose(run["grad_norms"], run["jax_grad_norms"],
                               rtol=LOSS_RTOL)
    params = dict(run["state"].model.named_parameters())
    for k in params:
        if k.startswith("encoder_"):
            assert torch.equal(params[k], run["init"][k]), k
    _assert_params_close(params, run["want"], "freeze", list(params))


def test_flat_optimizer_matches_the_reference_and_refuses_freeze():
    run = _steps(3, **{"train.flat_optimizer": True,
                       "train.grad_clip": 0.05})
    assert run["state"].optimizer.foreach
    np.testing.assert_allclose(run["losses"], run["jax_losses"],
                               rtol=LOSS_RTOL)
    params = dict(run["state"].model.named_parameters())
    _assert_params_close(params, run["want"], "flat", list(params))
    _, cfg = _cfgs(**{"train.flat_optimizer": True,
                      "model.freeze_backbone": True})
    with pytest.raises(ValueError, match="incompatible with "
                                         "train.flat_optimizer"):
        create_state(cfg, torch.device("cpu"))


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def _torchvision_resnet(arch, seed):
    """A torchvision-layout ResNet state_dict of seeded numpy arrays (fc
    included, which the import drops)."""
    stages = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}[arch]
    bottleneck = arch == "resnet50"
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, o, i, k):
        sd[f"{key}.weight"] = rng.normal(0, 0.1, (o, i, k, k)).astype(
            np.float32)

    def bn(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{key}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{key}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[f"{key}.num_batches_tracked"] = np.array(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate(stages, start=1):
        w = 64 * 2 ** (s - 1)
        out = w * (4 if bottleneck else 1)
        for b in range(n):
            t = f"layer{s}.{b}"
            if bottleneck:
                shapes = [(w, cin, 1), (w, w, 3), (out, w, 1)]
            else:
                shapes = [(w, cin, 3), (w, w, 3)]
            for k, (o, i, ks) in enumerate(shapes, start=1):
                conv(f"{t}.conv{k}", o, i, ks)
                bn(f"{t}.bn{k}", o)
            if b == 0 and (s > 1 or cin != out):
                conv(f"{t}.downsample.0", out, cin, 1)
                bn(f"{t}.downsample.1", out)
            cin = out
    sd["fc.weight"] = rng.normal(0, 0.1, (1000, cin)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


@pytest.mark.parametrize("arch,fmt", [("resnet18", "npz"),
                                      ("resnet50", "pt")])
def test_init_from_torch_matches_the_references_import(arch, fmt, tmp_path):
    sd = _torchvision_resnet(arch, 3)
    path = str(tmp_path / f"backbone.{fmt}")
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in sd.items()}}, path)
    _, cfg = _cfgs(**{"model.backbone": arch,
                      "model.cameras": ("agentview", "robot0_eye_in_hand")})
    variables = random_jax_variables(cfg.model, seed=1)
    loaded = jax_load_state_dict_file(path)
    for cam in cfg.model.cameras:
        variables = jax_load_pretrained_backbone(variables, cam, loaded, arch)
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables),
                               cfg.model)
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict_from_jax(
        random_jax_variables(cfg.model, seed=1), cfg.model))
    got_sd = load_state_dict_file(path)
    for cam in cfg.model.cameras:
        load_pretrained_backbone(model, cam, got_sd, arch)
    got = model.state_dict()
    changed = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        changed += k.startswith("encoder_") and ".proj." not in k
    assert changed > 0
    # T frames stacked on channels: the stem takes 6 channels, not 3
    _, stacked = _cfgs(**{"model.backbone": arch,
                          "model.temporal_frames": 2,
                          "model.temporal_mode": "channel"})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_backbone(PoseEstimator(stacked.model), "agentview",
                                 got_sd, arch)


def test_init_from_torch_composes_with_freeze_and_is_ignored_on_resume(
        demo_h5, tmp_path):
    sd = _torchvision_resnet("resnet18", 4)
    path = str(tmp_path / "r18.npz")
    np.savez(path, **sd)
    over = {"train.init_from_torch": path, "model.freeze_backbone": True,
            "train.ema_decay": 0.5}
    d = str(tmp_path / "t")
    out = api.train(_fit_cfg(demo_h5, d, 2, **over), device="cpu")
    params = dict(out["state"].model.named_parameters())
    assert torch.equal(params["encoder_agentview.stem.conv.weight"],
                       torch.from_numpy(sd["conv1.weight"]))
    assert torch.equal(out["state"].ema["encoder_agentview.stem.conv.weight"],
                       torch.from_numpy(sd["conv1.weight"]))
    # a second run in the same directory resumes; the import would
    # otherwise reset the running statistics
    _, sd2, _ = checkpoint.load_training(out["ckpt_path"])
    out = api.train(_fit_cfg(demo_h5, d, 3, **over), device="cpu")
    assert out["state"].step == 3
    assert not torch.equal(
        sd2["encoder_agentview.stem.bn.running_mean"],
        torch.from_numpy(sd["bn1.running_mean"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.train(_fit_cfg(demo_h5, str(tmp_path / "x"), 1, **{
            **over, "train.init_from": d}), device="cpu")


def test_init_from_starts_at_the_sources_served_weights(demo_h5, tmp_path):
    """The source's EMA parameters and all its buffers; a fresh optimizer
    and step; the EMA restarts at them; ignored once the run has a
    checkpoint of its own."""
    src = api.train(_fit_cfg(demo_h5, str(tmp_path / "src"), 2, **{
        "train.ema_decay": 0.5}), device="cpu")
    _, served = checkpoint.load(src["ckpt_path"])
    cfg = _fit_cfg(demo_h5, str(tmp_path / "dst"), 0, **{
        "train.init_from": str(tmp_path / "src"), "train.ema_decay": 0.9})
    state = create_state(cfg, torch.device("cpu"))
    loop.warm_start(cfg, state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, served[k]), k
    for k, e in state.ema.items():
        assert torch.equal(e, served[k]), k
    out = api.train(cfg.override(**{"train.steps": 2}), device="cpu")
    assert out["state"].optimizer.count == 2
    bad = cfg.override(**{"model.head_hidden": (64,),
                          "train.ckpt_dir": str(tmp_path / "bad")})
    with pytest.raises(ValueError, match="train.init_from"):
        loop.warm_start(bad, create_state(bad, torch.device("cpu")))


# ---------------------------------------------------------------------------
# early stopping, debug_nans, the profile window
# ---------------------------------------------------------------------------

EARLY = {"data.synthetic_size": 256, "data.val_fraction": 0.25,
         "data.batch_size": 32, "data.num_workers": 0,
         "dist.num_devices": 1, "train.steps": 200, "train.log_every": 10,
         "train.eval_every": 10, "train.eval_steps": 4, "train.ckpt_every": 0,
         "train.early_stop_patience": 2, "train.early_stop_min_delta": 0.02,
         "train.lr": 3e-3}


def test_early_stopping_stops_where_the_reference_does(tmp_path):
    """pr1 from the JAX package's initial weights in both packages: the
    same stop step, reported as early_stopped_at, with its checkpoint."""
    jcfg = jax_preset("pr1").override(**{
        **EARLY, "train.ckpt_dir": str(tmp_path / "jax")})
    cfg = Config.from_dict(jcfg.to_dict()).override(**{
        "train.ckpt_dir": str(tmp_path / "port")})
    want = jax_fit(jcfg)["metrics"]
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    state = create_state(cfg, torch.device("cpu"), state_dict_from_jax(
        jax.tree.map(np.asarray, init), cfg.model))
    got = loop.train_on(cfg, state, build_dataset(cfg, "train"),
                        build_dataset(cfg, "val"))
    stop = want["early_stopped_at"]
    assert 0 < stop < EARLY["train.steps"]
    assert got["metrics"]["early_stopped_at"] == stop
    assert got["ckpt_path"].endswith(f"step_{int(stop):08d}.pt")
    assert state.step == stop


def test_pr1_ema_and_recalibration_fit_as_the_reference(tmp_path):
    """pr1 (no BatchNorm, proprio statistics) with the EMA and
    recalibration in both packages from the JAX package's initial
    weights: the reference recalibrates whenever the model has
    statistics, so each eval and the final save consume
    ema_bn_recal_batches train batches; the same losses follow, and the
    final checkpoint serves the EMA."""
    from rgb_proprioceptive_pose_estimator_tpu.utils.checkpoint import (
        CheckpointManager,
    )

    over = {**EARLY, "train.early_stop_patience": 0, "train.steps": 6,
            "train.log_every": 1, "train.eval_every": 2,
            "train.ema_decay": 0.5, "train.ema_bn_recal_batches": 2,
            "model.proprio_normalize": True}
    jcfg = jax_preset("pr1").override(**{
        **over, "train.ckpt_dir": str(tmp_path / "jax")})
    cfg = Config.from_dict(jcfg.to_dict()).override(**{
        "train.ckpt_dir": str(tmp_path / "port")})
    jax_fit(jcfg)
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    state = create_state(cfg, torch.device("cpu"), state_dict_from_jax(
        jax.tree.map(np.asarray, init), cfg.model))
    out = loop.train_on(cfg, state, build_dataset(cfg, "train"),
                        build_dataset(cfg, "val"))
    mngr = CheckpointManager(str(tmp_path / "jax"))
    try:
        want_consumed = mngr.restore_data()["consumed"]
    finally:
        mngr.close()
    training = checkpoint.load_training(out["ckpt_path"])[2]
    # evals at steps 2, 4 and 6, and the final save
    assert training["pipeline"]["consumed"] == want_consumed == 6 + 4 * 2

    def rows(d, key):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [r[key] for r in map(json.loads, f) if key in r]

    for key in ("train/loss", "eval/loss"):
        np.testing.assert_allclose(rows(tmp_path / "port", key),
                                   rows(tmp_path / "jax", key), rtol=1e-3,
                                   err_msg=key)
    assert "ema" in training


def test_early_stopping_requires_evals():
    _, cfg = _cfgs("pr1", **{"train.early_stop_patience": 2,
                             "train.eval_every": 0})
    with pytest.raises(ValueError, match="requires train.eval_every"):
        loop.check_fit_supported(cfg)


def test_debug_nans_raises_at_the_first_nan_step_as_the_reference():
    jcfg, cfg = _cfgs("pr1", **{"train.debug_nans": True})
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model, 2))
    rs = np.random.RandomState(3)
    batch = {"proprio": rs.randn(BATCH, cfg.model.proprio_dim).astype(
        np.float32),
        "target_pos": rs.randn(BATCH, 3).astype(np.float32),
        "target_quat": np.tile(np.float32([1, 0, 0, 0]), (BATCH, 1))}
    bad = dict(batch, proprio=batch["proprio"].copy())
    bad["proprio"][2, 1] = np.nan
    tx, jstate = _jax_state(jcfg, variables)
    jstep = jax_make_train_step(build_model(jcfg.model), tx, jcfg.train)
    with jax.debug_nans(True):
        jstate, _ = jstep(jstate, batch)
        with pytest.raises(FloatingPointError):
            jstep(jstate, bad)
    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(variables, cfg.model))
    train_step(state, _tensors(batch), cfg.train)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(FloatingPointError, match="step 1 holds a NaN"):
        train_step(state, _tensors(bad), cfg.train)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_profile_window_writes_a_trace(tmp_path):
    cfg = Config.from_dict(jax_preset("pr1").override(**{
        "data.synthetic_size": 64, "data.num_workers": 0,
        "train.steps": 6, "train.eval_every": 0, "train.ckpt_every": 0,
        "train.ckpt_dir": str(tmp_path / "run"),
        "train.profile_dir": str(tmp_path / "trace"),
        "train.profile_start": 2, "train.profile_steps": 2}).to_dict())
    api.train(cfg, device="cpu")
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# proprio dropout
# ---------------------------------------------------------------------------


def test_proprio_dropout_is_the_identity_in_eval_as_the_reference():
    jcfg, cfg = _cfgs(**{"model.proprio_dropout": 0.3})
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model, 5))
    batch = _batches(cfg.model, 6, 1)[0]
    jpos, jquat = build_model(jcfg.model).apply(variables, batch,
                                                train=False)
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict_from_jax(variables, cfg.model))
    with torch.no_grad():
        pos, quat = model.eval()(_tensors(batch))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(quat.numpy(), np.asarray(jquat), rtol=1e-5,
                               atol=1e-6)


def test_proprio_dropout_rate_and_scale_in_training():
    """flax nn.Dropout: a share p of zeros (within 3 sigma) and the rest
    scaled by 1/(1-p); the same generator state draws the same mask."""
    p, shape = 0.1, (512, 128)
    x = torch.ones(shape)
    y = fusion.proprio_dropout(x, p, torch.Generator().manual_seed(0))
    zeros = float((y == 0).float().mean())
    n = shape[0] * shape[1]
    assert abs(zeros - p) <= 3 * np.sqrt(p * (1 - p) / n), zeros
    assert torch.all((y == 0) | (y == 1 / (1 - p)))
    assert torch.equal(
        y, fusion.proprio_dropout(x, p, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="torch.Generator"):
        fusion.proprio_dropout(x, p, None)


def test_only_the_device_data_options_are_refused_naming_item_9b():
    """Item 9b is ported: both device data options pass
    check_fit_supported, and the config's own refusals still raise."""
    for over in ({"data.device_cache": True, "data.augment": False},
                 {"data.augment_device": True},
                 {"data.device_cache": True, "data.augment_device": True},
                 {"data.device_cache": True, "data.augment": False,
                  "data.cache_layout": "sharded"}):
        _, cfg = _cfgs(**{"data.source": "hdf5", "data.path": "x.hdf5",
                          **over})
        loop.check_fit_supported(cfg)
    for over, match in (
            ({"data.device_cache": True, "data.augment": True},
             "augmentation must run on device"),
            ({"data.device_cache": True, "data.augment": False,
              "data.source": "synthetic"}, "hdf5 image source only"),
            ({"data.cache_layout": "sharded"},
             "requires data.device_cache")):
        with pytest.raises(ValueError, match=match):
            _cfgs(**{"data.source": "hdf5", "data.path": "x.hdf5", **over})
    _, cfg = _cfgs(**{"train.grad_accum": 2, "train.ema_decay": 0.9,
                      "train.ema_bn_recal_batches": 1,
                      "train.flat_optimizer": True, "train.debug_nans": True,
                      "train.profile_dir": "x", "train.init_from": "y",
                      "train.early_stop_patience": 2,
                      "model.proprio_dropout": 0.1})
    loop.check_fit_supported(cfg)

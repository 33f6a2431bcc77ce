"""The port's pr5 pieces against the JAX package on the CPU: the rot6d
pose math and head, the LSTM temporal mode (flax OptimizedLSTMCell over
the frames' features), camera dropout in training, the dropout stream
across a resume, and pr5la's dual-camera temporal batches with lookahead
labels.

Sizes are cut, widths kept where it costs little: ResNet-18 at 32 px
with 32 image features, T = 3, both pr5 cameras, batch 4. Both sides get
the same numpy-seeded inputs and ``random_jax_variables`` weights,
carried across by ``state_dict_from_jax``. Tolerances: the rot6d
functions 1e-6 (the same f32 formulas; the gradients, which reach 1e8 at
a zero input, 1e-5 of their largest); forwards atol 1e-5, rtol 1e-4, and
parameter gradients within 1e-4 of their tensor's largest, running
statistics rtol 1e-5 (the same f32 math summed in other orders, as in
tests/test_torch_backbones.py). Torch cannot draw jax.random's bits, so
camera dropout is held with an injected keep mask: the JAX model, built
without dropout, is fed ``camera_mask`` = keep x live, which gives the
same features."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.data.pipeline import (
    HostPipeline as JaxHostPipeline,
)
from rgb_proprioceptive_pose_estimator_tpu.data.pipeline import (
    build_dataset as jax_build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu.losses.pose import (
    pose_loss as jax_pose_loss,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.ops import pose_math as jpm
from rgb_proprioceptive_pose_estimator_tpu.runtime import native as jax_native
from rgb_proprioceptive_pose_estimator_tpu_torch.api import Predictor
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import train_on
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import create_state
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    dropout_generator,
    forward_backward,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
    draw_forced_camera,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.lstm import LSTM
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import pose_math as pm
from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import native
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    port_arrays,
    random_jax_variables,
    random_variables_for,
    state_dict_from_jax,
)

ROT_TOL, ROT_GRAD_REL = 1e-6, 1e-5
RTOL, ATOL = 1e-4, 1e-5
GRAD_REL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
CAMS = ("agentview", "robot0_eye_in_hand")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes are small, and the suite's test
    workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# rot6d pose math
# ---------------------------------------------------------------------------


def _rot_inputs(fn):
    """Seeded inputs of ``fn``: rotation matrices of random quaternions and
    of the identity and the half turns (where matrix_to_quat's candidates
    not taken divide by about 0), or raw 6-vectors with a zero row, a1
    parallel to a2 and a1 = 0."""
    rs = np.random.RandomState(31)
    q = rs.randn(32, 4)
    q = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                        np.eye(4)]).astype(np.float32)
    if fn == "quat_to_matrix":
        return q
    m = np.array(jpm.quat_to_matrix(jnp.asarray(q)))
    if fn in ("matrix_to_quat", "matrix_to_rot6d"):
        return m
    x = (rs.randn(32, 6) * 3.0).astype(np.float32)
    edge = np.asarray([[0, 0, 0, 0, 0, 0], [1, 0, 0, 2, 0, 0],
                       [0, 0, 0, 1, 0, 0]], np.float32)
    six = np.asarray(jpm.matrix_to_rot6d(jnp.asarray(m)))
    return np.concatenate([x, edge, six])


@pytest.mark.parametrize("fn", ["quat_to_matrix", "matrix_to_quat",
                                "rot6d_to_matrix", "matrix_to_rot6d",
                                "rot6d_to_quat"])
def test_rot6d_functions_match_jax(fn):
    x = _rot_inputs(fn)
    jf, tf = getattr(jpm, fn), getattr(pm, fn)
    want = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    w = np.random.RandomState(32).randn(*want.shape).astype(np.float32)
    want_grad = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(jf(a) * w)))(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = tf(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=ROT_TOL)
    grad = xt.grad.numpy()
    assert np.isfinite(grad).all()
    assert np.abs(grad - want_grad).max() <= (
        ROT_GRAD_REL * np.abs(want_grad).max())


def test_rot6d_to_quat_gradient_finite_at_zero_and_degenerate_inputs():
    """tests/test_pose_math.py's zero and degenerate inputs of the head
    path: a finite gradient, the JAX package's."""
    grad = jax.jit(jax.grad(lambda x: jnp.sum(jpm.rot6d_to_quat(x))))
    for x0 in ([0.0] * 6, [1.0, 0.0, 0.0, 2.0, 0.0, 0.0],
               [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]):
        x0 = np.asarray(x0, np.float32)
        want = np.asarray(grad(jnp.asarray(x0)))
        xt = torch.from_numpy(x0).requires_grad_(True)
        pm.rot6d_to_quat(xt).sum().backward()
        got = xt.grad.numpy()
        assert np.isfinite(got).all(), (x0, got)
        np.testing.assert_allclose(got, want, rtol=ROT_GRAD_REL,
                                   atol=ROT_GRAD_REL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the LSTM cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_matches_flax_optimized_lstm_cell(dtype):
    """nn.RNN(nn.OptimizedLSTMCell(H, dtype, param_dtype=f32)) over (B, T,
    in), last step: f32 out in both dtypes; in f32 the values and every
    gradient (weights and inputs) agree, in bf16 within bf16's rounding
    of the gates (2e-2)."""
    import flax.linen as nn

    b, t, f_in, h = 4, 3, 24, 16
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # standalone, nn.RNN keeps the cell's parameters under "cell"; inside
    # the pose model they sit under lstm_<camera>
    cell = nn.RNN(nn.OptimizedLSTMCell(h, dtype=jdt, param_dtype=jnp.float32))
    x = np.random.RandomState(33).randn(b, t, f_in).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    init = jax.eval_shape(lambda: cell.init(jax.random.PRNGKey(0), xj))
    port = LSTM(f_in, h, getattr(torch, dtype))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    variables = random_variables_for(shapes, seed=34)
    assert (jax.tree.map(lambda a: tuple(a.shape), variables)
            == jax.tree.map(lambda a: tuple(a.shape),
                            {"params": init["params"]["cell"]}))
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in port_arrays(variables).items()})
    g = np.random.RandomState(35).randn(b, h).astype(np.float32)

    def loss(params, xx):
        out = cell.apply({"params": {"cell": params}}, xx)[:, -1]
        return jnp.sum(out * g), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], xj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = port(xt)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    if dtype == "bfloat16":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=2e-2)
        return
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    want_grads = port_arrays({"params": jax.tree.map(np.asarray, gp)})
    for k, p in port.named_parameters():
        w = want_grads[k]
        assert np.abs(p.grad.numpy() - w).max() <= GRAD_REL * np.abs(w).max(), k
    gx = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= GRAD_REL * np.abs(gx).max()


# ---------------------------------------------------------------------------
# the pr5 model: LSTM mode, rot6d head, camera dropout
# ---------------------------------------------------------------------------


def _pr5_cfgs(**overrides):
    """(JAX config, port config) of pr5 at 32 px, 32 image features, f32,
    one device, plus overrides."""
    dotted = {"model.image_size": 32, "model.image_features": 32,
              "model.dtype": "float32", "dist.num_devices": 1, **overrides}
    jcfg = jax_preset("pr5").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _batch(model_cfg, n, seed):
    """Seeded numpy batch: (n, T, H, W, 3) frames of both cameras, (n, T,
    D) proprio, target poses."""
    rs = np.random.RandomState(seed)
    t, hw = model_cfg.temporal_frames, model_cfg.image_size
    lead = (n, t) if t > 1 else (n,)
    q = rs.randn(n, 4)
    batch = {"images": {c: rs.randint(0, 256, lead + (hw, hw, 3), np.uint8)
                        for c in model_cfg.cameras},
             "target_pos": rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
             "target_quat": (q / np.linalg.norm(q, axis=1, keepdims=True)
                             ).astype(np.float32)}
    if model_cfg.use_proprio:
        batch["proprio"] = rs.randn(*lead, model_cfg.proprio_dim).astype(
            np.float32)
    return batch


def _torch_batch(batch):
    return {k: ({c: torch.from_numpy(a) for c, a in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in batch.items()}


def _port_model(cfg, variables):
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict_from_jax(variables, cfg.model))
    return model


def _jax_eval(jm, variables, batch):
    return jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)


@pytest.mark.parametrize("rot_rep", ["quat", "rot6d"])
def test_pr5_lstm_model_eval_matches_jax(rot_rep):
    jcfg, cfg = _pr5_cfgs(**{"model.rot_rep": rot_rep})
    variables = random_jax_variables(cfg.model, seed=36)
    batch = _batch(cfg.model, 4, seed=37)
    jm = build_model(jcfg.model)
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch,
                                          train=False))
    assert (jax.tree.map(lambda a: tuple(a.shape), variables)
            == jax.tree.map(lambda a: tuple(a.shape), init))
    want = _jax_eval(jm, variables, batch)
    port = _port_model(cfg, variables).eval()
    assert port.lstm_agentview.ii.weight.shape == (32, 32)
    assert port.pose_out.weight.shape[0] == (9 if rot_rep == "rot6d" else 7)
    with torch.no_grad():
        got = port(_torch_batch(batch))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL)


def _live_keep(keep, present, camera_mask, forced, use_proprio):
    """camera dropout's combined mask, by its rules, in numpy."""
    live = np.asarray([float(c in present) for c in CAMS], np.float32)
    live = np.broadcast_to(live, keep.shape).copy()
    if camera_mask is not None:
        live *= camera_mask
    combined = keep * live
    if not use_proprio:
        dead = (combined.sum(1, keepdims=True) == 0) & (
            live.sum(1, keepdims=True) > 0)
        combined = combined + dead * forced
    return combined


def _jax_train_grads(jcfg, variables, batch):
    """The JAX model's train-mode loss, outputs, parameter gradients and
    new batch statistics."""
    jm = build_model(jcfg.model)
    tc = jcfg.train

    def f(params):
        (pos, quat), mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        loss, _ = jax_pose_loss(pos, quat, batch["target_pos"],
                                batch["target_quat"],
                                pos_weight=tc.pos_weight,
                                rot_weight=tc.rot_weight,
                                rot_loss=tc.rot_loss, pos_loss=tc.pos_loss,
                                huber_delta=tc.huber_delta)
        return loss, (pos, quat, mut["batch_stats"])

    (loss, (pos, quat, stats)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])
    return (float(loss), (np.asarray(pos), np.asarray(quat)),
            port_arrays({"params": jax.tree.map(np.asarray, grads)}),
            port_arrays({"batch_stats": jax.tree.map(np.asarray, stats)}))


def test_pr5_train_step_with_camera_dropout_matches_jax_camera_mask():
    """pr5's train-mode step (LSTM, both cameras, proprio, bn_stats
    reduce) with an injected keep mask against the JAX model without
    dropout fed camera_mask = keep x live: outputs, loss, every gradient
    (the LSTMs' included) and the running statistics. The keep mask drops
    one camera in two rows and both in one (with proprio that row stays
    dead)."""
    jcfg, cfg = _pr5_cfgs(**{"model.rot_rep": "rot6d"})
    jcfg = jcfg.override(**{"model.camera_dropout": 0.0})
    variables = random_jax_variables(cfg.model, seed=38)
    batch = _batch(cfg.model, 4, seed=39)
    keep = np.asarray([[1, 1], [0, 1], [1, 0], [0, 0]], np.float32)
    mask = _live_keep(keep, CAMS, None, None, True)
    jax_out = _jax_train_grads(jcfg, variables, {**batch,
                                                  "camera_mask": mask})
    port = _port_model(cfg, variables)
    tbatch = _torch_batch({**batch, "camera_keep": keep})
    port.train()
    m = forward_backward(port, tbatch, cfg.train)
    loss_want, outs_want, grads_want, stats_want = jax_out
    np.testing.assert_allclose(float(m["loss"]), loss_want, rtol=RTOL)
    named = dict(port.named_parameters())
    assert set(named) == set(grads_want)
    assert any(k.startswith("lstm_") for k in named)
    for k, p in named.items():
        w = grads_want[k]
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (k, err, np.abs(w).max())
    buffers = dict(port.named_buffers())
    assert set(buffers) == set(stats_want)
    for k, w in stats_want.items():
        np.testing.assert_allclose(buffers[k].numpy(), w, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)
    with torch.no_grad():
        pos, quat = port(tbatch)
    for g_, w_ in zip((pos, quat), outs_want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=RTOL, atol=ATOL)


def _two_camera_cfgs(p, use_proprio=False):
    """(JAX config, port config): two cameras through CNNSmall at 32 px,
    32 features, one frame, camera dropout ``p``."""
    dotted = {"model.backbone": "cnn_small", "model.image_size": 32,
              "model.cameras": CAMS, "model.use_proprio": use_proprio,
              "model.image_features": 32, "model.head_hidden": (32,),
              "model.camera_dropout": p, "model.dtype": "float32"}
    jcfg = jax_preset("pr2").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("external", [False, True])
def test_camera_dropout_force_one_camera_matches_jax_camera_mask(external):
    """Without proprio, a row whose live cameras all dropped gets the
    forced camera back; with an incoming camera_mask that kills camera 0
    in rows 0-3, only a camera live before dropout comes back (row 3 of
    that mask has none, and stays dead). The port's mask from injected
    keep and forced draws, fed to the JAX model as camera_mask, gives the
    same outputs."""
    jcfg, cfg = _two_camera_cfgs(0.5)
    variables = random_jax_variables(cfg.model, seed=40)
    batch = _batch(cfg.model, 6, seed=41)
    keep = np.asarray([[0, 0], [0, 0], [1, 0], [0, 1], [1, 1], [0, 0]],
                      np.float32)
    forced = np.eye(2, dtype=np.float32)[[0, 1, 0, 1, 0, 0]]
    camera_mask = None
    if external:
        camera_mask = np.ones((6, 2), np.float32)
        camera_mask[:4, 0] = 0.0
        camera_mask[3, 1] = 0.0
    combined = _live_keep(keep, CAMS, camera_mask, forced, False)
    port = _port_model(cfg, variables)
    mask = fusion.PoseEstimator._dropout_mask(
        port, {"camera_keep": torch.from_numpy(keep),
               "camera_forced": torch.from_numpy(forced),
               "camera_mask": (None if camera_mask is None
                               else torch.from_numpy(camera_mask))},
        dict.fromkeys(CAMS), 6, None)
    np.testing.assert_array_equal(mask.numpy(), combined)
    assert (combined.sum(1) >= 1).sum() == (5 if external else 6)

    jax_out = _jax_train_grads(
        jcfg.override(**{"model.camera_dropout": 0.0}), variables,
        {**batch, "camera_mask": combined})
    tb = {**batch, "camera_keep": keep, "camera_forced": forced}
    if external:
        tb["camera_mask"] = camera_mask
    port.train()
    with torch.no_grad():
        got = port(_torch_batch(tb))
    for g_, w_ in zip(got, jax_out[1]):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=RTOL, atol=ATOL)


def _train_forward(model, batch, seed):
    model.train()
    with torch.no_grad():
        return model(_torch_batch(batch),
                     generator=torch.Generator().manual_seed(seed))


def test_camera_dropout_respects_external_mask():
    """tests/test_models.py's rule, with the port's own draws at p = 0.9:
    with camera 0 dead in the incoming mask no train-mode output depends
    on its pixels, while the live camera still matters."""
    _, cfg = _two_camera_cfgs(0.9)
    model = _port_model(cfg, random_jax_variables(cfg.model, seed=42))
    batch = _batch(cfg.model, 16, seed=43)
    batch["camera_mask"] = np.ones((16, 2), np.float32)
    batch["camera_mask"][:, 0] = 0.0
    p0, q0 = _train_forward(model, batch, 7)
    for cam, changes in (("agentview", False), ("robot0_eye_in_hand", True)):
        other = dict(batch, images=dict(batch["images"]))
        other["images"][cam] = 255 - batch["images"][cam]
        p1, q1 = _train_forward(model, other, 7)
        assert torch.equal(p0, p1) is not changes, cam
        if not changes:
            assert torch.equal(q0, q1)


def test_camera_dropout_train_mode_only():
    """p = 0.5 over 8 samples x 2 cameras drops some camera in training
    (with probability 1 - 2^-16); eval mode is the identity."""
    _, cfg = _two_camera_cfgs(0.5, use_proprio=True)
    _, cfg0 = _two_camera_cfgs(0.0, use_proprio=True)
    variables = random_jax_variables(cfg.model, seed=44)
    model, model0 = _port_model(cfg, variables), _port_model(cfg0, variables)
    batch = _batch(cfg.model, 8, seed=45)
    assert not torch.equal(_train_forward(model, batch, 3)[0],
                           _train_forward(model0, batch, 3)[0])
    with torch.no_grad():
        pe = model.eval()(_torch_batch(batch))
        pe0 = model0.eval()(_torch_batch(batch))
    assert torch.equal(pe[0], pe0[0]) and torch.equal(pe[1], pe0[1])
    with pytest.raises(ValueError, match="generator"):
        model.train()(_torch_batch(batch))


def test_forced_camera_is_drawn_among_the_live_ones():
    live = torch.tensor([[1.0, 1.0, 0.0]] * 3000 + [[0.0, 0.0, 1.0]] * 10)
    forced = draw_forced_camera(torch.Generator().manual_seed(0), live)
    assert torch.equal(forced.sum(1), torch.ones(3010))
    assert bool((forced * (1 - live)).sum() == 0)
    share = forced[:3000, 0].mean().item()
    assert 0.45 < share < 0.55, share


def test_dropout_generator_is_a_function_of_seed_and_step():
    draw = [torch.rand(8, generator=dropout_generator(s, k, "cpu"))
            for s, k in ((0, 5), (0, 5), (0, 6), (1, 5))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


def test_predictor_serves_pr5_with_a_dead_camera():
    """pr5 served by the port's Predictor from (T, H, W, 3) frames and (T,
    D) proprio: a batch with robot0_eye_in_hand left out (allowed, since
    pr5 trains with camera dropout) and one unbatched observation, against
    the JAX model on the same inputs."""
    jcfg, cfg = _pr5_cfgs()
    variables = random_jax_variables(cfg.model, seed=46)
    batch = _batch(cfg.model, 4, seed=47)
    obs = {"images": {"agentview": batch["images"]["agentview"]},
           "proprio": batch["proprio"]}
    jm = build_model(jcfg.model)
    want = _jax_eval(jm, variables, obs)
    pred = Predictor(cfg, state_dict=state_dict_from_jax(variables, cfg.model),
                     max_batch=4, device="cpu")
    got = pred(obs)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, np.asarray(w_), rtol=RTOL, atol=ATOL)
    one = pred({"images": {c: v[0] for c, v in batch["images"].items()},
                "proprio": batch["proprio"][0]})
    assert one[0].shape == (3,) and one[1].shape == (4,)
    want_one = _jax_eval(jm, variables, {
        "images": {c: v[:1] for c, v in batch["images"].items()},
        "proprio": batch["proprio"][:1]})
    for g_, w_ in zip(one, want_one):
        np.testing.assert_allclose(g_, np.asarray(w_)[0], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# pr5la's data and the dropout stream across a resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    """A two-camera demo fixture: three demos of 20 steps, 40 px frames."""
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("demo") / "dualcam.hdf5"), n_demos=3,
        steps=20, cameras=CAMS, image_hw=40, seed=0)


def _pr5la_cfgs(path, **overrides):
    dotted = {"model.image_size": 32, "data.path": path,
              "data.batch_size": 8, "data.num_workers": 2,
              "dist.num_devices": 1, **overrides}
    jcfg = jax_preset("pr5la").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


NATIVE_LOAD_ATTEMPTS = 8


@pytest.fixture(scope="module")
def native_backends():
    """Both packages' native augment libraries, loaded, as
    tests/test_torch_train.py loads them: a load that failed while another
    test worker was writing the JAX package's library is forgotten and
    tried again once the library and its .buildinfo are complete."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("JAX package", jax_native), ("port", native)):
            for attempt in range(NATIVE_LOAD_ATTEMPTS):
                if mod.available():
                    break
                time.sleep(0.5 * (attempt + 1))
                if os.path.exists(mod._LIB) and os.path.exists(mod._INFO):
                    mp.setattr(mod, "_tried", False)
                    mp.setattr(mod, "_lib", None)
            else:
                pytest.fail(f"the {name}'s native augment library "
                            f"{mod._LIB} could not be built or loaded")
        yield


def _backend(use_native, request):
    if use_native:
        request.getfixturevalue("native_backends")
        assert jax_native.available() and native.available()


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    assert sorted(got["images"]) == sorted(want["images"]) == sorted(CAMS)
    for cam in CAMS:
        g_, w_ = np.asarray(got["images"][cam]), np.asarray(
            want["images"][cam])
        assert g_.shape == w_.shape and g_.dtype == w_.dtype == np.uint8
        np.testing.assert_array_equal(g_, w_)
    for k in ("proprio", "target_pos", "target_quat"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_pr5la_store_batches_match_jax_bit_for_bit(demo_h5, backend, request):
    """HDF5DemoStore.get_batch for pr5la (two cameras, T = 3, labels 6
    steps ahead), augmented and not, at the samples whose window is
    clamped at an episode's start and elsewhere."""
    use_native = backend == "native"
    _backend(use_native, request)
    jcfg, cfg = _pr5la_cfgs(demo_h5, **{"data.use_native": use_native})
    jstore, store = jax_build_dataset(jcfg), build_dataset(cfg)
    assert len(store) == len(jstore) == 3 * (20 - 6)
    starts = np.nonzero(store._index[:, 1] <= 1)[0]
    idx = np.concatenate([starts, [5, 17, len(store) - 1]])
    for augment in (True, False):
        got = store.get_batch(idx, augment=augment, seed=3)
        want = jstore.get_batch(idx, augment=augment, seed=3)
        assert got["images"]["agentview"].shape == (len(idx), 3, 32, 32, 3)
        _assert_batches_equal(got, want)
    # the label is the pose 6 steps after the window's last frame
    demo, t = store._index[idx[0]]
    off = store._demo_off[demo]
    np.testing.assert_array_equal(got["target_pos"][0],
                                  store._pos_flat[off + t + 6])


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_pr5la_host_pipeline_batches_match_jax_bit_for_bit(demo_h5, backend,
                                                           request):
    use_native = backend == "native"
    _backend(use_native, request)
    jcfg, cfg = _pr5la_cfgs(demo_h5, **{"data.use_native": use_native})
    jpipe = JaxHostPipeline(jax_build_dataset(jcfg), jcfg.data, train=True)
    pipe = HostPipeline(build_dataset(cfg), cfg.data, device="cpu",
                        train=True)
    try:
        for _ in range(6):                       # over an epoch boundary
            got, want = next(pipe), next(jpipe)
            _assert_batches_equal(
                {k: ({c: a.numpy() for c, a in v.items()}
                     if isinstance(v, dict) else v.numpy())
                 for k, v in got.items()}, want)
        assert pipe.state_dict() == jpipe.state_dict()
    finally:
        jpipe.close()
        pipe.close()


def test_resume_draws_the_straight_runs_dropout_masks(demo_h5, tmp_path,
                                                      monkeypatch):
    """A pr5-shaped run (two cameras, T = 3, LSTM, camera dropout 0.5,
    CNNSmall at 32 px for speed) cut after 2 of 4 steps and resumed ends
    with the straight run's model, optimizer and sampler state bit for
    bit, having drawn the straight run's keep masks in steps 3 and 4."""
    draws = []
    real = fusion.draw_camera_keep

    def record(*args, **kwargs):
        draws.append(real(*args, **kwargs))
        return draws[-1]

    monkeypatch.setattr(fusion, "draw_camera_keep", record)

    def run(name, steps):
        _, cfg = _pr5la_cfgs(demo_h5, **{
            "model.backbone": "cnn_small", "model.image_features": 32,
            "model.dtype": "float32", "model.camera_dropout": 0.5,
            "data.batch_size": 4, "train.steps": steps,
            "train.steps_per_call": 1, "train.log_every": 1,
            "train.eval_every": 0, "train.ckpt_every": 2,
            "train.warmup_steps": 2, "train.ckpt_dir": str(tmp_path / name)})
        del draws[:]
        out = train_on(cfg, create_state(cfg, torch.device("cpu")),
                       build_dataset(cfg), build_dataset(cfg))
        return out, list(draws)

    straight, masks = run("straight", 4)
    run("resumed", 2)
    resumed, masks_b = run("resumed", 4)
    assert len(masks) == 4 and len(masks_b) == 2
    assert any(bool((m == 0).any()) for m in masks)
    for a, b in zip(masks[2:], masks_b):
        assert torch.equal(a, b)
    _, sd_a, tr_a = checkpoint.load_training(straight["ckpt_path"])
    _, sd_b, tr_b = checkpoint.load_training(resumed["ckpt_path"])
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    opt_a, opt_b = tr_a["optimizer"], tr_b["optimizer"]
    assert opt_a["count"] == opt_b["count"] == 4
    for i, st in opt_a["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_b["inner"]["state"][i][k]), (i, k)
    assert tr_a["pipeline"] == tr_b["pipeline"]

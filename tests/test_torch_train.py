"""The port's training slice against the JAX package on the CPU: each module
that holds a kernel (channel_stats, the scale-bias-ReLU gradient, bn_train,
BatchNormAct in train mode), the loss, the optimizer chain, the host
pipeline, and pr3-shaped training as a whole. Both sides get the same
numpy inputs made from a seed; the JAX side runs its Pallas kernels in
interpret mode, as its own tests do. The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py).

Tolerances, each with its reason, stand beside the tests."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from rgb_proprioceptive_pose_estimator_tpu.engine.loop import fit as jax_fit
from rgb_proprioceptive_pose_estimator_tpu.engine.state import (
    create_state as jax_create_state,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_lr_schedule as jax_make_lr_schedule,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.losses.pose import (
    pose_loss as jax_pose_loss,
)
from rgb_proprioceptive_pose_estimator_tpu.losses.pose import (
    pose_metrics as jax_pose_metrics,
)
from rgb_proprioceptive_pose_estimator_tpu.models.blocks import (
    BatchNormAct as JaxBatchNormAct,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.ops.fused_bn import (
    bn_train as jax_bn_train,
)
from rgb_proprioceptive_pose_estimator_tpu.ops.pallas_fused import (
    channel_stats as jax_channel_stats,
)
from rgb_proprioceptive_pose_estimator_tpu.ops.pallas_fused import (
    scale_bias_relu as jax_scale_bias_relu,
)
from rgb_proprioceptive_pose_estimator_tpu.runtime import native as jax_native
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config, TrainConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import train_on
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import create_state
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    Optimizer,
    forward_backward,
    make_lr_schedule,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
    pose_loss,
    pose_metrics,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import BatchNormAct
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.bn_stats import (
    channel_sum_sumsq_matmul,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused_bn import bn_train
from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import native
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    state_dict_from_jax,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _nchw(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (a view)."""
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# K3 channel_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8, 8, 64), (8, 4, 4, 128),
                                   (8, 4, 4, 256), (8, 2, 2, 512)])
def test_channel_stats_reference_matches_pallas(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) + 0.5
    xj = jnp.asarray(x).astype(jdt)
    js, jss = jax_channel_stats(xj)
    s, ss = fused.channel_stats(_nchw(x, tdt))
    assert s.dtype == ss.dtype == torch.float32 and s.shape == (shape[-1],)
    # two f32 sums of the same values in other orders: 1e-5 of the sum of
    # magnitudes per channel (the bound of f32 summation at these counts)
    xf = _f32(xj).reshape(-1, shape[-1])
    tol_s = 1e-5 * np.abs(xf).sum(0)
    tol_ss = 1e-5 * (xf * xf).sum(0)
    assert np.all(np.abs(s.numpy() - _f32(js)) <= tol_s)
    assert np.all(np.abs(ss.numpy() - _f32(jss)) <= tol_ss)


@pytest.mark.parametrize("shape", [(1001, 24), (3, 3, 5, 7), (50, 3)])
def test_channel_stats_takes_shapes_the_pallas_kernel_refuses(shape):
    # the JAX kernel needs prod(shape) % (lcm(C, 128) * 8) == 0; the port
    # takes any C and any row count. Oracle: float64 sums in numpy.
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    if len(shape) == 4:
        t, c = _nchw(x), shape[-1]
    else:
        t, c = torch.from_numpy(x), shape[1]
    s, ss = fused.channel_stats(t)
    x64 = x.reshape(-1, c).astype(np.float64)
    np.testing.assert_allclose(s.numpy(), x64.sum(0),
                               atol=1e-5 * np.abs(x64).sum(0).max())
    np.testing.assert_allclose(ss.numpy(), (x64 ** 2).sum(0), rtol=1e-5)


def test_channel_stats_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="channels_last"):
        fused.channel_stats(torch.zeros(2, 8, 4, 4))      # NCHW-contiguous
    with pytest.raises(TypeError):
        fused.channel_stats(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="2-D"):
        fused.channel_stats(torch.zeros(4, 8, 2))


# ---------------------------------------------------------------------------
# K2 scale_bias_relu with its backward
# ---------------------------------------------------------------------------


def _sbr_inputs(shape, seed):
    """x, scale, bias, g with no x*scale + bias within 1e-3 of 0, so that
    the ReLU mask cannot depend on how the two sides round."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = rs.randn(*shape).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    pre = x * scale + bias
    x = np.where(np.abs(pre) < 1e-2, x + 0.05, x).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nchw_channels_last", "rows_ragged"])
def test_scale_bias_relu_function_matches_jax_vjp(layout, dtype):
    jdt, tdt = DTYPES[dtype]
    shape = (2, 8, 8, 64) if layout == "nchw_channels_last" else (1500, 24)
    x, scale, bias, g = _sbr_inputs(shape, seed=2)
    y_j, vjp = jax.vjp(jax_scale_bias_relu, jnp.asarray(x).astype(jdt),
                       jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = vjp(jnp.asarray(g).astype(jdt))

    to_t = _nchw if len(shape) == 4 else (lambda a, d=torch.float32:
                                          torch.from_numpy(a).to(d))
    xt = to_t(x, tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = fused.scale_bias_relu(xt, st, bt)
    y.backward(to_t(g, tdt))
    back = _nhwc if len(shape) == 4 else (lambda t: t.detach().float().numpy())
    assert xt.grad.dtype == tdt and xt.grad.stride() == xt.stride()
    # f32: the same f32 arithmetic, mask decided away from ties: 1e-5 (the
    # oracle of tests/test_pallas.py). bf16: one bf16 ulp of dx = g*s
    # (|dx| < 7); dscale, dbias are f32 sums of the same bf16 products.
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(back(y), _f32(y_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(back(xt.grad), _f32(dx_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(st.grad.numpy(), _f32(ds_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), _f32(db_j), rtol=1e-4,
                               atol=1e-4)


def test_scale_bias_relu_backward_copies_and_counts_a_gradient_in_another_layout():
    x, scale, bias, g = _sbr_inputs((2, 4, 4, 16), seed=3)
    xt = _nchw(x).requires_grad_()
    y = fused.scale_bias_relu(xt, torch.from_numpy(scale),
                              torch.from_numpy(bias))
    before = fused.scale_bias_relu.grad_layout_copies
    g_nchw = _nchw(g).contiguous()                     # NCHW-contiguous
    y.backward(g_nchw)
    assert fused.scale_bias_relu.grad_layout_copies == before + 1
    want, _, _ = fused.scale_bias_relu_backward_reference(
        xt.detach(), g_nchw.contiguous(memory_format=torch.channels_last),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(xt.grad, want)


def test_reductions_route_cpu_tensors_to_plain_versions_without_counting():
    x, scale, bias, g = _sbr_inputs((2, 4, 4, 16), seed=4)
    xt, gt = _nchw(x), _nchw(g)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    def counts():
        return tuple(getattr(w, k) for w in (fused.channel_stats,
                                              fused.scale_bias_relu_backward)
                     for k in ("launches", "scalar_launches"))

    before = counts()
    for got, want in zip(fused.channel_stats(xt),
                         fused.channel_stats_reference(xt)):
        assert torch.equal(got, want)
    for got, want in zip(fused.scale_bias_relu_backward(xt, gt, s, b),
                         fused.scale_bias_relu_backward_reference(xt, gt, s, b)):
        assert torch.equal(got, want)
    assert counts() == before


# ---------------------------------------------------------------------------
# bn_train and BatchNormAct in train mode
# ---------------------------------------------------------------------------


def _bn_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (np.abs(rs.randn(c)) + 0.5).astype(np.float32)
    beta = rs.randn(c).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_bn_train_matches_jax(impl, dtype):
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta, g = _bn_inputs((8, 6, 6, 64), seed=5)
    (y_j, m_j, v_j), vjp = jax.vjp(
        lambda a, b, c: jax_bn_train(a, b, c, 1e-5, impl),
        jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp((jnp.asarray(g).astype(jdt),
                            jnp.zeros_like(m_j), jnp.zeros_like(v_j)))

    xt = _nchw(x, tdt).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y, mean, var = bn_train(xt, gt, bt, 1e-5, impl)
    assert not mean.requires_grad and not var.requires_grad
    y.backward(_nchw(g, tdt))
    # the tolerances of tests/test_fused_bn.py: f32 1e-5; bf16 2e-2 (y and
    # dx are rounded to bf16, about one ulp at |y| < 4)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_nhwc(y), _f32(y_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(_nhwc(xt.grad), _f32(dx_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(gt.grad.numpy(), _f32(dg_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), _f32(db_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), _f32(m_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), _f32(v_j), rtol=1e-5, atol=1e-6)


def _bn_train_run(impl, tdt, act, x, gamma, beta, g):
    """(y, dx, dgamma, dbeta) of bn_train, with the ReLU inside (``act``
    True) or as torch.relu after it (``act`` None)."""
    xt = _nchw(x, tdt).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y, _, _ = bn_train(xt, gt, bt, 1e-5, impl, act=bool(act))
    if act is None:
        y = torch.relu(y)
    y.backward(_nchw(g, tdt))
    return y.detach(), xt.grad, gt.grad, bt.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_bn_train_with_act_is_relu_of_bn_train(impl, dtype):
    # the ReLU inside bn_train decides on the f32 pre-activation, rounded
    # as the forward rounds it; torch.relu after it on y, its rounding to
    # x's dtype, which keeps the sign: the same values and gradients, bit
    # for bit (no pre-activation here is a subnormal that rounds to 0)
    _, tdt = DTYPES[dtype]
    x, gamma, beta, g = _bn_inputs((8, 6, 6, 64), seed=15)
    fused_act = _bn_train_run(impl, tdt, True, x, gamma, beta, g)
    after = _bn_train_run(impl, tdt, None, x, gamma, beta, g)
    assert (fused_act[0] == 0).any() and (fused_act[0] > 0).any()
    for got, want in zip(fused_act, after):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _closed_form_before_kernels(x, g, gamma, beta, eps=1e-5):
    """The plain-torch training BatchNorm that ops/fused_bn ran before its
    epilogue became kernels (matmul statistics, no ReLU), line by line."""
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1]
    xf = x.float()
    s, ss = channel_sum_sumsq_matmul(x)
    mean = s / n
    var = torch.clamp_min(ss / n - torch.square(mean), 0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    bias = beta - mean * scale
    view = (1, -1, 1, 1)
    y = (xf * scale.view(view) + bias.view(view)).to(x.dtype)
    gf = g.float()
    sum_g = torch.sum(gf, dim=dims)
    cross = torch.sum(gf * xf, dim=dims)
    sum_g_xhat = (cross - mean * sum_g) * inv
    a = gamma * inv
    b = -gamma * torch.square(inv) * sum_g_xhat / n
    c = -(a * sum_g / n) - b * mean
    dx = (gf * a.view(view) + xf * b.view(view) + c.view(view)).to(x.dtype)
    return y, dx, sum_g_xhat, sum_g, (scale, bias, mean, inv, sum_g, cross)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_epilogue_plain_versions_are_the_closed_form_before_kernels(dtype):
    """The plain versions that stand in for the kernels on the CPU compute
    what the plain-torch epilogue computed, bit for bit, sums and all."""
    _, tdt = DTYPES[dtype]
    x, gamma, beta, g = _bn_inputs((8, 6, 6, 64), seed=16)
    xt, gt = _nchw(x, tdt), _nchw(g, tdt)
    gamma_t, beta_t = torch.from_numpy(gamma), torch.from_numpy(beta)
    y0, dx0, dgamma0, dbeta0, (scale, bias, mean, inv, sum_g, cross) = (
        _closed_form_before_kernels(xt, gt, gamma_t, beta_t))
    assert torch.equal(fused.bn_affine_act(xt, scale, bias, False), y0)
    assert torch.equal(fused.bn_affine_act(xt, scale, bias, True),
                       torch.relu(y0))
    got_g, got_gx = fused.bn_act_sums(xt, gt, scale, bias, False)
    assert torch.equal(got_g, sum_g) and torch.equal(got_gx, cross)
    n = xt.numel() // xt.shape[1]
    assert torch.equal(fused.bn_act_dx(xt, gt, scale, bias, False, sum_g,
                                       cross, gamma_t, mean, inv, n), dx0)
    y, _, _ = bn_train(xt.requires_grad_(), gamma_t.requires_grad_(),
                       beta_t.requires_grad_(), 1e-5, "matmul")
    y.backward(gt)
    assert torch.equal(y, y0) and torch.equal(xt.grad, dx0)
    assert torch.equal(gamma_t.grad, dgamma0)
    assert torch.equal(beta_t.grad, dbeta0)


def test_bn_train_copies_and_counts_a_gradient_in_another_layout():
    x, gamma, beta, g = _bn_inputs((2, 4, 4, 16), seed=17)
    xt = _nchw(x).requires_grad_()
    y, _, _ = bn_train(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                       1e-5, "pallas", act=True)
    before = bn_train.grad_layout_copies
    g_nchw = _nchw(g).contiguous()                     # NCHW-contiguous
    y.backward(g_nchw)
    assert bn_train.grad_layout_copies == before + 1
    xt2 = _nchw(x).requires_grad_()
    y2, _, _ = bn_train(xt2, torch.from_numpy(gamma), torch.from_numpy(beta),
                        1e-5, "pallas", act=True)
    y2.backward(_nchw(g))
    assert bn_train.grad_layout_copies == before + 1
    assert torch.equal(xt.grad, xt2.grad)


@pytest.mark.parametrize("route", ["reduce", "matmul", "pallas"])
def test_batchnorm_act_train_mode_matches_jax(route):
    x, gamma, beta, g = _bn_inputs((8, 4, 4, 64), seed=6)
    rs = np.random.RandomState(7)
    ra_mean = (rs.randn(64) * 0.1).astype(np.float32)
    ra_var = (rs.rand(64) + 0.5).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(gamma),
                            "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}
    jbn = JaxBatchNormAct(stats_impl=route, use_pallas=True)

    def f(x_, params):
        return jbn.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         x_, train=True, mutable=["batch_stats"])

    y_j, vjp, mut = jax.vjp(f, jnp.asarray(x), variables["params"],
                            has_aux=True)
    dx_j, dp_j = vjp(jnp.asarray(g))

    bn = BatchNormAct(64, stats_impl=route).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    xt = _nchw(x).requires_grad_()
    y = bn(xt)
    y.backward(_nchw(g))
    # f32 throughout; statistics summed in other orders: 1e-5
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(dp_j["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(dp_j["bias"]), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# pose loss and metrics
# ---------------------------------------------------------------------------


def _pose_inputs(case):
    rs = np.random.RandomState(8)
    pp = rs.randn(6, 3).astype(np.float32)
    tp = rs.randn(6, 3).astype(np.float32)
    pq = rs.randn(6, 4).astype(np.float32)
    tq = rs.randn(6, 4).astype(np.float32)
    if case == "edges":
        pq[0] = 0.0                        # q = 0 (dropped camera's head)
        tq[1] = pq[1]                      # <q, q_hat> = 1
        tq[2] = -2.0 * pq[2]               # <q, q_hat> = -1 after normalizing
        tp[3] = pp[3] + 0.01               # inside the Huber delta
    return pp, pq, tp, tq


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("rot_loss,pos_loss", [("chordal", "mse"),
                                               ("geodesic", "huber")])
def test_pose_loss_and_metrics_match_jax(rot_loss, pos_loss, case):
    pp, pq, tp, tq = _pose_inputs(case)
    kw = dict(pos_weight=1.0, rot_weight=0.5, rot_loss=rot_loss,
              pos_loss=pos_loss, huber_delta=0.05)

    def jloss(a, b):
        return jax_pose_loss(a, b, jnp.asarray(tp), jnp.asarray(tq), **kw)

    (l_j, aux_j), (dpp_j, dpq_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(pp), jnp.asarray(pq))
    ppt = torch.from_numpy(pp).requires_grad_()
    pqt = torch.from_numpy(pq).requires_grad_()
    loss, aux = pose_loss(ppt, pqt, torch.from_numpy(tp),
                          torch.from_numpy(tq), **kw)
    loss.backward()
    # f32 elementwise math and small means: 1e-5 relative; the gradients
    # also pass arccos' derivative near the clip, 1e-4
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5)
    for k in ("pos_loss", "rot_loss"):
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-7)
    for got, want in ((ppt.grad, dpp_j), (pqt.grad, dpq_j)):
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    m_j = jax_pose_metrics(jnp.asarray(pp), jnp.asarray(pq), jnp.asarray(tp),
                           jnp.asarray(tq))
    m = pose_metrics(torch.from_numpy(pp), torch.from_numpy(pq),
                     torch.from_numpy(tp), torch.from_numpy(tq))
    for k in ("pos_mae_cm", "rot_mae_deg"):
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# optimizer chain and learning-rate schedules
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw_constant": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-2),
    "adam_cosine_warmup": dict(optimizer="adam", lr=1e-2,
                               lr_schedule="cosine", warmup_steps=2, steps=5),
    "adamw_multistep_boundary": dict(optimizer="adamw", lr=1e-2,
                                     weight_decay=1e-3,
                                     lr_schedule="multistep",
                                     lr_decay_steps=(3,), lr_decay_rate=0.1),
    "sgd_momentum": dict(optimizer="sgd", lr=5e-2),
    "adamw_grad_clip": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-2,
                            grad_clip=0.05),
}


def _mlp_params(seed):
    rs = np.random.RandomState(seed)
    return {"w1": (rs.randn(4, 8) * 0.5).astype(np.float32),
            "b1": (rs.randn(8) * 0.1).astype(np.float32),
            "w2": (rs.randn(8, 2) * 0.5).astype(np.float32),
            "b2": (rs.randn(2) * 0.1).astype(np.float32)}


def _mlp_loss(p, x, y, lib):
    h = lib.tanh(x @ p["w1"] + p["b1"])
    return lib.mean(lib.square(h @ p["w2"] + p["b2"] - y))


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_trajectory_matches_optax(case):
    tcfg = TrainConfig(**OPT_CASES[case])
    rs = np.random.RandomState(9)
    data = [(rs.randn(16, 4).astype(np.float32),
             rs.randn(16, 2).astype(np.float32)) for _ in range(5)]

    jcfg = jax_preset("pr1").override(
        **{f"train.{k}": v for k, v in OPT_CASES[case].items()}).train
    tx = jax_make_optimizer(jcfg)
    pj = {k: jnp.asarray(v) for k, v in _mlp_params(10).items()}
    opt_state = tx.init(pj)
    grad = jax.jit(jax.grad(lambda p, x, y: _mlp_loss(p, x, y, jnp)))

    pt = {k: torch.nn.Parameter(torch.from_numpy(v))
          for k, v in _mlp_params(10).items()}
    opt = Optimizer(tcfg, pt.values())
    for x, y in data:
        updates, opt_state = tx.update(grad(pj, x, y), opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.zero_grad()
        _mlp_loss(pt, torch.from_numpy(x), torch.from_numpy(y),
                  torch).backward()
        opt.step()
        # the same algebra in another order (torch's AdamW decays before
        # it steps, optax adds the decay to the update): 1e-5 relative
        for k in pt:
            np.testing.assert_allclose(pt[k].detach().numpy(),
                                       np.asarray(pj[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{case} {k}")
    assert opt.count == 5


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_lr_schedule_matches_jax(case):
    kw = dict(OPT_CASES[case], steps=8)
    if "warmup_steps" not in kw:
        kw["warmup_steps"] = 0
    cfg = TrainConfig(**kw)
    jcfg = jax_preset("pr1").override(
        **{f"train.{k}": v for k, v in kw.items()}).train
    ours, ref = make_lr_schedule(cfg), jax_make_lr_schedule(jcfg)
    for count in range(10):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"count {count}")


# ---------------------------------------------------------------------------
# host pipeline and pr3-shaped training as a whole
# ---------------------------------------------------------------------------

FIT_STEPS = 3


@pytest.fixture(scope="module")
def fixture_h5(tmp_path_factory):
    """The demo fixture with its frames replaced by seeded uniform noise.

    A ReLU whose input lies within rounding of 0 takes one side or the
    other depending on the order of some sum, and one such element moves
    every gradient of its BatchNorm channel, and the layers before it, by
    percents; most seeds of noise frames, and the fixture's own renders,
    have such an element somewhere in the network. At this seed none of
    the first step's ReLU inputs lies that close to 0 (the worst gradient
    then agrees to 3e-5 of its tensor's largest, whatever the CPU thread
    count), so the comparison measures the port and not a tie."""
    import h5py

    path = write_demo_fixture(
        str(tmp_path_factory.mktemp("demo") / "demo64.hdf5"), n_demos=2,
        steps=16, cameras=("agentview",), image_hw=72, seed=0)
    rs = np.random.RandomState(14)
    with h5py.File(path, "r+") as f:
        for demo in sorted(f["data"]):
            ds = f[f"data/{demo}/obs/agentview_image"]
            ds[...] = rs.randint(0, 256, ds.shape).astype(np.uint8)
    return path


def _pr3_64(path, ckpt_dir="", **overrides):
    """pr3 at 64 px, batch 8, augmentation on, as (JAX config, port
    config)."""
    dotted = {"model.image_size": 64, "data.path": path,
              "data.batch_size": 8, "data.num_workers": 2,
              "data.crop_scale": (0.8, 1.0), "data.jitter_prob": 0.8,
              "train.steps": FIT_STEPS, "train.steps_per_call": 1,
              "train.log_every": 1, "train.eval_every": FIT_STEPS,
              "train.eval_steps": 1, "train.ckpt_every": 0,
              "train.ckpt_dir": ckpt_dir, **overrides}
    jcfg = jax_preset("pr3").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


NATIVE_LOAD_ATTEMPTS = 8


@pytest.fixture(scope="module")
def native_backends():
    """Both packages' native augment libraries, loaded; fails, naming the
    package, where one is missing.

    The two pixel backends give other pixels (12.6% of an augmented batch
    differs), so a comparison of augmented images holds only when both
    sides use the same one. Each package builds its library at first use;
    the JAX package's build writes it in place, so a process that loads it
    while another pytest worker is rewriting it fails once and stays on
    numpy for good (its ``_tried``). Here that first failure is forgotten
    and the load tried again once the library and its .buildinfo are
    complete. Neither package is changed: the reset is undone after the
    module."""
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


def _pixel_backend(source, native_mod) -> str:
    """The pixel backend that augmentation takes for ``source``, a store
    or the data config a run builds its store from (both carry
    ``use_native``)."""
    return ("native" if source.use_native and native_mod.available()
            else "numpy")


def _assert_backends(want, jax_source, port_source):
    for side, got in (("JAX", _pixel_backend(jax_source, jax_native)),
                      ("port", _pixel_backend(port_source, native))):
        assert got == want, (f"{side} side augments with {got}, expected "
                             f"{want}")


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_host_pipeline_batches_match_jax_bit_for_bit(fixture_h5, backend,
                                                     request):
    use_native = backend == "native"
    if use_native:
        request.getfixturevalue("native_backends")
    jcfg, cfg = _pr3_64(fixture_h5, **{"data.use_native": use_native})
    assert cfg.data.augment
    jstore, store = jax_build_dataset(jcfg), build_dataset(cfg)
    _assert_backends(backend, jstore, store)
    jpipe = JaxHostPipeline(jstore, jcfg.data, train=True)
    pipe = HostPipeline(store, cfg.data, device="cpu", train=True)
    try:
        for _ in range(5):                       # over an epoch boundary
            want, got = next(jpipe), next(pipe)
            assert sorted(got) == sorted(want)
            for k in ("proprio", "target_pos", "target_quat"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            np.testing.assert_array_equal(
                got["images"]["agentview"].numpy(),
                np.asarray(want["images"]["agentview"]))
        assert pipe.state_dict() == jpipe.state_dict()
    finally:
        jpipe.close()
        pipe.close()


def _metrics(path, prefix):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r for r in rows if f"{prefix}loss" in r}


@pytest.fixture(scope="module")
def jax_init(fixture_h5):
    """The JAX package's initial variables for the pr3-shaped config's
    train.seed, as numpy: what its fit starts from."""
    jcfg, _ = _pr3_64(fixture_h5)
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    return jax.tree.map(np.asarray, init)


@pytest.fixture(scope="module")
def fits(fixture_h5, jax_init, native_backends, tmp_path_factory):
    """pr3-shaped fit of FIT_STEPS steps in both packages from the JAX
    package's initial weights for train.seed, on the same fixture, both
    augmenting with the native engine."""
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    pdir = str(tmp_path_factory.mktemp("port_ckpt"))
    jcfg, _ = _pr3_64(fixture_h5, jdir)
    _, cfg = _pr3_64(fixture_h5, pdir)
    _assert_backends("native", jcfg.data, cfg.data)
    jax_fit(jcfg)
    dataset = build_dataset(cfg)
    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(jax_init, cfg.model))
    out = train_on(cfg, state, dataset, dataset)
    return {"jcfg": jcfg, "cfg": cfg, "port": out,
            "jax_metrics": os.path.join(jdir, "metrics.jsonl"),
            "port_metrics": os.path.join(pdir, "metrics.jsonl")}


def test_pr3_fit_matches_jax_step_by_step(fits):
    _assert_backends("native", fits["jcfg"].data, fits["cfg"].data)
    want = _metrics(fits["jax_metrics"], "train/")
    got = _metrics(fits["port_metrics"], "train/")
    assert sorted(got) == sorted(want) == list(range(1, FIT_STEPS + 1))
    # the same math from the same weights and batches, in f32, summed in
    # other orders; Adam's first steps magnify that: rtol 1e-3
    for step in want:
        for k in ("train/loss", "train/pos_loss", "train/rot_loss"):
            np.testing.assert_allclose(got[step][k], want[step][k],
                                       rtol=1e-3, err_msg=f"step {step} {k}")
    jeval = _metrics(fits["jax_metrics"], "eval/")[FIT_STEPS]
    peval = _metrics(fits["port_metrics"], "eval/")[FIT_STEPS]
    for k in ("eval/loss", "eval/pos_mae_cm", "eval/rot_mae_deg"):
        np.testing.assert_allclose(peval[k], jeval[k], rtol=1e-3, err_msg=k)
    # the final checkpoint holds what the run ended with
    path = fits["port"]["ckpt_path"]
    assert path.endswith(f"step_{FIT_STEPS:08d}.pt")
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    cfg, sd, training = checkpoint.load_training(path)
    assert cfg == fits["cfg"] and training["step"] == FIT_STEPS
    assert training["pipeline"]["consumed"] == FIT_STEPS
    for k, v in fits["port"]["model"].state_dict().items():
        assert torch.equal(sd[k], v)


def test_pr3_first_step_gradients_match_jax(jax_init, fixture_h5,
                                            native_backends):
    jcfg, cfg = _pr3_64(fixture_h5)
    store = build_dataset(cfg)
    # both sides take the port pipeline's batch, augmented by the native
    # engine: the fixture's seed has no ReLU tie under its pixels
    assert _pixel_backend(store, native) == "native", (
        "port side augments with numpy, expected native")
    pipe = HostPipeline(store, cfg.data, device="cpu", train=True)
    batch = next(pipe)
    pipe.close()
    variables = {k: dict(v) for k, v in jax_init.items()}
    mean, std = build_dataset(cfg).proprio_stats()
    variables["batch_stats"]["proprio"] = {"proprio_mean": mean,
                                           "proprio_std": std}
    model = build_model(jcfg.model)
    t = jcfg.train

    def loss_fn(params, jbatch):
        (pos, quat), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, train=True, mutable=["batch_stats"])
        return jax_pose_loss(pos, quat, jbatch["target_pos"],
                             jbatch["target_quat"], pos_weight=t.pos_weight,
                             rot_weight=t.rot_weight, rot_loss=t.rot_loss,
                             pos_loss=t.pos_loss, huber_delta=t.huber_delta)[0]

    jbatch = jax.tree.map(lambda a: jnp.asarray(a.numpy()), batch)
    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"], jbatch)
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]}, cfg.model)

    state = create_state(cfg, torch.device("cpu"),
                         state_dict_from_jax(variables, cfg.model))
    forward_backward(state.model, batch, cfg.train)
    named = dict(state.model.named_parameters())
    assert set(named) <= set(want)
    # every parameter's gradient within 1e-4 of that tensor's largest
    for k, p in named.items():
        w = want[k].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


def test_train_without_device_raises_when_cuda_is_absent(fixture_h5,
                                                         monkeypatch):
    from rgb_proprioceptive_pose_estimator_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _pr3_64(fixture_h5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)

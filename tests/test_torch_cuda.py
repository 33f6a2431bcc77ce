"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where JAX is not installed; tests/conftest.py
imports JAX, so run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test skips, from a fixture, where torch.cuda.is_available() is False.

Tolerances: normalize_u8 and scale_bias_relu round x * s + b twice, as
their plain versions do, and convert to bf16 to nearest even, as
``.to(torch.bfloat16)`` does, so they equal the plain versions exactly (NaN
where the plain version has NaN). The two reductions sum in another order
than the plain versions: 1e-5 of the sum of magnitudes per channel. The
training BatchNorm's epilogue (bn_affine_act, bn_act_sums, bn_act_dx)
rounds as its plain versions do too: its forward and, given the same sums,
its dx equal them exactly; its sums are held as the other reductions'.
"""

import time

import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch import Predictor
from rgb_proprioceptive_pose_estimator_tpu_torch.config import preset
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)

pytestmark = pytest.mark.cuda

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _exact(out, ref):
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


# a view one element past a 16-byte boundary (2-D (M, C) for the kernels
# over rows, the image shape for normalize_u8): the kernels take it through
# their one-element path
MISALIGNED = "misaligned"
# pr5's stem site, per camera: 1024 samples x 3 frames of 64 x 64 x 64,
# 805 M elements (3.2 GB in f32), four times pr4's largest
PR5_STEM_SHAPE = (3072, 64, 64, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 16, 16, 9),
                                   (3, 37, 41, 3), (MISALIGNED, 3, 37, 41, 3)])
def test_normalize_u8_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    if shape[0] == MISALIGNED:
        n = int(np.prod(shape[1:]))
        img = torch.randint(0, 256, (n + 1,), generator=g, device=cuda,
                            dtype=torch.uint8)[1:].view(shape[1:])
        assert img.data_ptr() % 16 and img.is_contiguous()
    else:
        img = torch.randint(0, 256, shape, generator=g, device=cuda,
                            dtype=torch.uint8)
    before = fused.normalize_u8.launches
    scalar = fused.normalize_u8.scalar_launches
    out = fused.normalize_u8(img, MEAN, STD, dtype)
    torch.cuda.synchronize()
    assert fused.normalize_u8.launches == before + 1
    # 16-byte reads unless the input is misaligned (a tail of n % 16
    # elements goes one at a time in the same launch)
    assert (fused.normalize_u8.scalar_launches - scalar
            == int(shape[0] == MISALIGNED))
    ref = fused.normalize_u8_reference(img, MEAN, STD, dtype)
    assert out.dtype == dtype and out.shape == img.shape
    _exact(out, ref)


def _nonfinite_(x, channels=4):
    """Write NaN, +inf and -inf into a few rows of x's first ``channels``
    channels, in place; the other channels stay finite."""
    rows = fused.channel_rows(x)
    for i, value in enumerate((float("nan"), float("inf"), float("-inf"))):
        rows[i::97, i % channels] = value
        rows[i + 1::211, (i + 1) % channels] = value
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (3, 512, 4, 4),
                                   (1001, 24), (4099, 100),
                                   (MISALIGNED, 4099, 64), PR5_STEM_SHAPE])
def test_scale_bias_relu_kernel_matches_plain(cuda, shape, dtype):
    x = _stats_inputs(shape, dtype, cuda, seed=1, shift=0.0)
    c = x.shape[1]
    g = torch.Generator(device=cuda).manual_seed(9)
    s = torch.rand(c, generator=g, device=cuda) + 0.5
    b = torch.randn(c, generator=g, device=cuda) * 0.5
    before = fused.scale_bias_relu.launches
    scalar = fused.scale_bias_relu.scalar_launches
    out = fused.scale_bias_relu(x, s, b)
    torch.cuda.synchronize()
    assert fused.scale_bias_relu.launches == before + 1
    assert (fused.scale_bias_relu.scalar_launches - scalar
            == int(bool(_scalar_path(x))))
    ref = fused.scale_bias_relu_reference(x, s, b)
    assert out.dtype == dtype and out.stride() == x.stride()
    _exact(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_bn_relu_kernels_place_nan_and_inf_as_plain(cuda, direction, dtype):
    """NaN, +inf and -inf in x (and in g): the forward keeps NaN through
    its ReLU, and the backward multiplies g by the mask, as the plain
    versions (and the JAX package) do."""
    shape = (4, 64, 16, 16)
    x = _nonfinite_(_stats_inputs(shape, dtype, cuda, seed=10, shift=0.0))
    gen = torch.Generator(device=cuda).manual_seed(11)
    s = torch.rand(64, generator=gen, device=cuda) + 0.5
    b = torch.randn(64, generator=gen, device=cuda) * 0.5
    if direction == "forward":
        ref = fused.scale_bias_relu_reference(x, s, b)
        assert ref.isnan().any() and ref.isinf().any()
        _exact(fused.scale_bias_relu(x, s, b), ref)
        return
    gout = _nonfinite_(_stats_inputs(shape, dtype, cuda, seed=12), 8)
    dx, ds, db = fused.scale_bias_relu_backward(x, gout, s, b)
    rdx, rds, rdb = fused.scale_bias_relu_backward_reference(x, gout, s, b)
    # NaN at masked elements whose g is NaN or inf, and in their channels
    assert rdx.isnan().any() and rds.isnan().any() and rdb.isnan().any()
    assert rdb[8:].isfinite().all()
    # dx: the tolerance of the finite test (exact in f32, one bf16 ulp)
    torch.testing.assert_close(
        dx, rdx, rtol=0.0 if dtype == torch.float32 else 2.0 ** -7, atol=0,
        equal_nan=True)
    for got, want in ((ds, rds), (db, rdb)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        inf = want.isinf()
        assert torch.equal(got[inf], want[inf])
    gm = gout.float() * (rdx.float() != 0)
    xf = fused.channel_rows(x).float()
    gmf = fused.channel_rows(gm)
    fin = rds.isfinite() & rdb.isfinite()
    tol_s = 1e-5 * (gmf * xf).abs().sum(0) + 1e-6
    tol_b = 1e-5 * gmf.abs().sum(0) + 1e-6
    assert ((ds - rds).abs() <= tol_s)[fin].all()
    assert ((db - rdb).abs() <= tol_b)[fin].all()
STEM_SHAPE = (128, 64, 64, 64)
# (12544, 2048): pr4's widest BatchNorm, (256, 2048, 7, 7) as rows; and
# pr5's stem
REDUCTION_SHAPES = [(8, 64, 32, 32), (16, 512, 4, 4), (100003, 64),
                    (1000, 3), STEM_SHAPE, (4099, 100), (MISALIGNED, 4099, 64),
                    (12544, 2048), PR5_STEM_SHAPE]


def _stats_inputs(shape, dtype, cuda, seed, shift=0.5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if shape[0] == MISALIGNED:
        m, c = shape[1:]
        x = torch.empty(m * c + 1, dtype=dtype, device=cuda)[1:].view(m, c)
        x.copy_(torch.randn((m, c), generator=g, device=cuda) + shift)
        assert x.data_ptr() % 16
        return x
    x = (torch.randn(shape, generator=g, device=cuda) + shift).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _scalar_path(x):
    """The kernels take one element per access: C is not a multiple of 16
    bytes' worth, or x is not 16-byte aligned."""
    return x.shape[1] % (16 // x.element_size()) != 0 or x.data_ptr() % 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REDUCTION_SHAPES)
def test_channel_stats_kernel_matches_plain(cuda, shape, dtype):
    x = _stats_inputs(shape, dtype, cuda, seed=2)
    before = fused.channel_stats.launches
    scalar = fused.channel_stats.scalar_launches
    s, ss = fused.channel_stats(x)
    again = fused.channel_stats(x)
    torch.cuda.synchronize()
    assert fused.channel_stats.launches == before + 2
    assert (fused.channel_stats.scalar_launches - scalar
            == 2 * bool(_scalar_path(x)))
    # deterministic: no float atomics, a fixed order of partial sums
    assert torch.equal(s, again[0]) and torch.equal(ss, again[1])
    rs, rss = fused.channel_stats_reference(x)
    # f32 sums of the same values in other orders: 1e-5 of the sum of
    # magnitudes per channel
    xf = fused.channel_rows(x).float()
    assert torch.all((s - rs).abs() <= 1e-5 * xf.abs().sum(0))
    assert torch.all((ss - rss).abs() <= 1e-5 * (xf * xf).sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [s for s in REDUCTION_SHAPES
                                   if s != (1000, 3)])
def test_scale_bias_relu_backward_kernel_matches_plain(cuda, shape, dtype):
    x = _stats_inputs(shape, dtype, cuda, seed=3)
    gout = _stats_inputs(shape, dtype, cuda, seed=4)
    c = x.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(5)
    s = torch.rand(c, generator=gen, device=cuda) + 0.5
    b = torch.randn(c, generator=gen, device=cuda) * 0.5
    before = fused.scale_bias_relu_backward.launches
    dx, ds, db = fused.scale_bias_relu_backward(x, gout, s, b)
    again = fused.scale_bias_relu_backward(x, gout, s, b)
    torch.cuda.synchronize()
    assert fused.scale_bias_relu_backward.launches == before + 2
    assert all(torch.equal(a, a2) for a, a2 in zip((dx, ds, db), again))
    rdx, rds, rdb = fused.scale_bias_relu_backward_reference(x, gout, s, b)
    assert dx.dtype == dtype and dx.stride() == x.stride()
    # the kernel decides the mask from x*s+b rounded twice, as the plain
    # version does, so dx agrees to the output's rounding: exact in f32,
    # one bf16 ulp in bf16
    tol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert ((dx.float() - rdx.float()).abs()
            <= tol * rdx.float().abs()).all()
    gm = gout.float() * (rdx.float() != 0)
    xf = fused.channel_rows(x).float()
    gmf = fused.channel_rows(gm)
    assert torch.all((ds - rds).abs() <= 1e-5 * (gmf * xf).abs().sum(0)
                     + 1e-6)
    assert torch.all((db - rdb).abs() <= 1e-5 * gmf.abs().sum(0) + 1e-6)


# the BN epilogue's sites: pr5's stem, a stage-4 site and the V = 1 path
BN_EPILOGUE_SHAPES = [PR5_STEM_SHAPE, (16, 512, 4, 4), (4099, 100)]


def _bn_epilogue_inputs(shape, dtype, cuda, seed):
    """x, g and the f32 per-channel (scale, bias, sum_g, sum_gx, gamma,
    mean, inv) of a training BatchNorm site, with n: the statistics of x
    itself, and sums on the scale of a real backward's."""
    x = _stats_inputs(shape, dtype, cuda, seed=seed)
    gout = _stats_inputs(shape, dtype, cuda, seed=seed + 1, shift=0.0)
    c = x.shape[1]
    n = x.numel() // c
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    gamma = torch.rand(c, generator=gen, device=cuda) + 0.5
    beta = torch.randn(c, generator=gen, device=cuda) * 0.5
    s, ss = fused.channel_stats(x)
    mean = s / n
    inv = torch.rsqrt(torch.clamp_min(ss / n - mean * mean, 0.0) + 1e-5)
    scale = gamma * inv
    bias = beta - mean * scale
    sum_g, sum_gx = fused.bn_act_sums_reference(x, gout, scale, bias, True)
    return x, gout, [scale, bias, sum_g, sum_gx, gamma, mean, inv], n


@pytest.mark.parametrize("act", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_EPILOGUE_SHAPES)
def test_bn_epilogue_kernels_match_plain(cuda, shape, dtype, act):
    x, gout, vecs, n = _bn_epilogue_inputs(shape, dtype, cuda, seed=20)
    scale, bias, _, _, gamma, mean, inv = vecs
    wrappers = (fused.bn_affine_act, fused.bn_act_sums, fused.bn_act_dx)
    before = [(w.launches, w.scalar_launches) for w in wrappers]
    y = fused.bn_affine_act(x, scale, bias, act)
    sum_g, sum_gx = fused.bn_act_sums(x, gout, scale, bias, act)
    dx = fused.bn_act_dx(x, gout, scale, bias, act, sum_g, sum_gx, gamma,
                         mean, inv, n)
    torch.cuda.synchronize()
    scalar = int(bool(_scalar_path(x)))
    assert [(w.launches, w.scalar_launches) for w in wrappers] == [
        (k + 1, v + scalar) for k, v in before]
    # the forward, exactly
    assert y.dtype == dtype and y.stride() == x.stride()
    _exact(y, fused.bn_affine_act_reference(x, scale, bias, act))
    # the sums, to the reductions' tolerance
    rg, rgx = fused.bn_act_sums_reference(x, gout, scale, bias, act)
    gm = fused.channel_rows(gout).float()
    if act:
        gm = gm * (fused.channel_rows(y).float() > 0)
    xf = fused.channel_rows(x).float()
    assert torch.all((sum_g - rg).abs() <= 1e-5 * gm.abs().sum(0) + 1e-6)
    assert torch.all((sum_gx - rgx).abs()
                     <= 1e-5 * (gm * xf).abs().sum(0) + 1e-6)
    # dx from the same sums, exactly
    assert dx.dtype == dtype and dx.stride() == x.stride()
    _exact(dx, fused.bn_act_dx_reference(x, gout, scale, bias, act, sum_g,
                                         sum_gx, gamma, mean, inv, n))


@pytest.mark.parametrize("act", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_epilogue_kernels_place_nan_and_inf_as_plain(cuda, dtype, act):
    """NaN, +inf and -inf in x and in g: the forward keeps NaN through its
    ReLU; the backward selects g by the ReLU's decision, so a NaN or inf g
    where the ReLU is off gives 0 there, as torch.relu's gradient does."""
    shape = (4, 64, 16, 16)
    x, gout, vecs, n = _bn_epilogue_inputs(shape, dtype, cuda, seed=30)
    _nonfinite_(x)
    _nonfinite_(gout, 8)
    scale, bias, sum_g, sum_gx, gamma, mean, inv = vecs
    ref = fused.bn_affine_act_reference(x, scale, bias, act)
    assert ref.isnan().any() and ref.isinf().any()
    _exact(fused.bn_affine_act(x, scale, bias, act), ref)
    got = fused.bn_act_sums(x, gout, scale, bias, act)
    want = fused.bn_act_sums_reference(x, gout, scale, bias, act)
    # NaN where x is NaN (0 * NaN in sum(gm * x)) or an unmasked g is; the
    # channels past the fourth are finite in x and g
    assert any(bool(w.isnan().any()) for w in want)
    assert all(bool(w[4:].isfinite().all()) for w in want)
    for u, w in zip(got, want):
        assert torch.equal(u.isnan(), w.isnan())
        assert torch.equal(u.isinf(), w.isinf())
        inf = w.isinf()
        assert torch.equal(u[inf], w[inf])
    # dx from finite sums: NaN and inf where x or g put them
    dx = fused.bn_act_dx(x, gout, scale, bias, act, sum_g, sum_gx, gamma,
                         mean, inv, n)
    rdx = fused.bn_act_dx_reference(x, gout, scale, bias, act, sum_g, sum_gx,
                                    gamma, mean, inv, n)
    assert rdx.isnan().any()
    _exact(dx, rdx)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _reductions_at(shape, dtype, cuda):
    """channel_stats and scale_bias_relu_backward as calls on seeded
    inputs of ``shape``."""
    x = _stats_inputs(shape, dtype, cuda, seed=6)
    gout = _stats_inputs(shape, dtype, cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    s = torch.rand(x.shape[1], generator=gen, device=cuda) + 0.5
    b = torch.randn(x.shape[1], generator=gen, device=cuda) * 0.5
    return {"channel_stats": lambda: fused.channel_stats(x),
            "scale_bias_relu_backward":
                lambda: fused.scale_bias_relu_backward(x, gout, s, b),
            "bn_act_sums": lambda: fused.bn_act_sums(x, gout, s, b, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["channel_stats",
                                    "scale_bias_relu_backward",
                                    "bn_act_sums"])
def test_reduction_is_bitwise_repeatable_over_1000_launches(cuda, kernel,
                                                            dtype):
    # only the ticket is atomic: a partial missing from the last block's
    # fold, or folded in another order, would show as a differing bit
    call = _reductions_at(STEM_SHAPE, dtype, cuda)[kernel]
    first = [_bits(t).clone() for t in call()]
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(1000):
        for a, b in zip(call(), first):
            differ += (_bits(a) != b).sum()
    assert differ.item() == 0


def _device_kernels(call, tries=3):
    """The device kernels of one call of ``call``, after a warm call, as
    torch.profiler records them. Now and then a trace comes back with no
    device activity at all; such a trace is taken again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    return kernels


@pytest.mark.parametrize("kernel", ["channel_stats",
                                    "scale_bias_relu_backward",
                                    "bn_act_sums"])
@pytest.mark.parametrize("shape", [STEM_SHAPE, (16, 512, 4, 4), (4099, 100)])
def test_reduction_call_is_one_kernel_launch(cuda, kernel, shape):
    call = _reductions_at(shape, torch.float32, cuda)[kernel]
    kernels = _device_kernels(call)
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", [
    ("normalize_u8", (128, 128, 128, 3)), ("normalize_u8", (3, 37, 41, 3)),
    ("scale_bias_relu", STEM_SHAPE), ("scale_bias_relu", (16, 512, 4, 4)),
    ("scale_bias_relu", (4099, 100)), ("bn_affine_act", STEM_SHAPE),
    ("bn_affine_act", (16, 512, 4, 4)), ("bn_affine_act", (4099, 100)),
    ("bn_act_dx", STEM_SHAPE), ("bn_act_dx", (16, 512, 4, 4)),
    ("bn_act_dx", (4099, 100))])
def test_elementwise_call_is_one_kernel_launch(cuda, kernel, shape, dtype):
    if kernel == "normalize_u8":
        img = torch.zeros(shape, dtype=torch.uint8, device=cuda)
        kernels = _device_kernels(
            lambda: fused.normalize_u8(img, MEAN, STD, dtype))
    elif kernel.startswith("bn_"):
        x, gout, vecs, n = _bn_epilogue_inputs(shape, dtype, cuda, seed=14)
        s, b = vecs[:2]
        if kernel == "bn_affine_act":
            kernels = _device_kernels(
                lambda: fused.bn_affine_act(x, s, b, True))
        else:
            kernels = _device_kernels(
                lambda: fused.bn_act_dx(x, gout, s, b, True, *vecs[2:], n))
    else:
        x = _stats_inputs(shape, dtype, cuda, seed=13)
        s = torch.ones(x.shape[1], device=cuda)
        kernels = _device_kernels(lambda: fused.scale_bias_relu(x, s, s))
    assert len(kernels) == 1, kernels


def _epilogue_counts(before=(0, 0, 0, 0)):
    """Launches of bn_affine_act, bn_act_sums and bn_act_dx, and the three's
    one-element launches, less ``before``."""
    wrappers = (fused.bn_affine_act, fused.bn_act_sums, fused.bn_act_dx)
    now = (*(w.launches for w in wrappers),
           sum(w.scalar_launches for w in wrappers))
    return tuple(a - b for a, b in zip(now, before))


def test_training_step_on_cuda_matches_cpu_and_runs_the_kernels(cuda,
                                                                monkeypatch):
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        forward_backward,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    # A ReLU input within rounding of 0 takes another side on the card than
    # on the CPU and moves its BatchNorm channel's gradients by percents.
    # At this seed none does on either route on an H100 with deterministic
    # cuDNN (checked with chip_smoke.ReluTape; seed 4 has one tie since the
    # normalize and BN-ReLU kernels round as the CPU does); chip_smoke.py's
    # full-width comparison replays the card's ReLU decisions instead.
    rs = np.random.RandomState(5)
    batch = {"images": {"agentview": torch.from_numpy(
                 rs.randint(0, 256, (8, 64, 64, 3), np.uint8))},
             "proprio": torch.from_numpy(rs.randn(8, 32).astype(np.float32)),
             "target_pos": torch.from_numpy(rs.randn(8, 3).astype(np.float32)),
             "target_quat": torch.from_numpy(
                 rs.randn(8, 4).astype(np.float32))}
    for route, want in (("reduce", (9, 9, 0)), ("pallas", (0, 0, 20))):
        cfg = preset("pr3").override(**{"model.image_size": 64,
                                        "model.bn_stats": route})
        sd = state_dict_from_jax(random_jax_variables(cfg.model, seed=0),
                                 cfg.model)
        grads = {}
        for dev in ("cpu", cuda):
            state = create_state(cfg, torch.device(dev), sd)
            b = {k: ({c: t.to(dev) for c, t in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in batch.items()}
            counts = (fused.scale_bias_relu.launches,
                      fused.scale_bias_relu_backward.launches,
                      fused.channel_stats.launches)
            epilogue = _epilogue_counts()
            loss = forward_backward(state.model, b, cfg.train)["loss"]
            torch.cuda.synchronize()
            seen = (fused.scale_bias_relu.launches - counts[0],
                    fused.scale_bias_relu_backward.launches - counts[1],
                    fused.channel_stats.launches - counts[2])
            assert seen == (want if dev != "cpu" else (0, 0, 0)), route
            # the BN epilogue's forward, sums and dx at each of the 20
            # BatchNorms on the pallas route, none of them one element at a
            # time (every C a multiple of 8)
            sites = 20 if route == "pallas" and dev != "cpu" else 0
            assert _epilogue_counts(epilogue) == (sites, sites, sites, 0), route
            grads[str(dev)] = (loss.item(), {
                k: p.grad.cpu() for k, p in state.model.named_parameters()})
        (lc, gc), (lg, gg) = grads["cpu"], grads[str(cuda)]
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        for k in gc:
            assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


BOTTLENECK_SEED = 0


def test_bottleneck_train_step_on_cuda_matches_cpu(cuda, monkeypatch):
    """A (1, 1, 1, 1) Bottleneck ResNet, pr4's block widths (64 to 2048),
    one train step on the card against the CPU on both BN routes, f32 with
    TF32 off: loss rtol 1e-4, every gradient within 1e-3 of its tensor's
    largest, running statistics rtol 1e-4 atol 1e-5, and the kernel
    launches of its sites (9 BN-ReLU sites, 17 BatchNorms). The seed's
    ReLU inputs have no tie at 0 between the card and the CPU (checked on
    an H100 with chip_smoke.ReluTape)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import (
        ResNet,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rs = np.random.RandomState(BOTTLENECK_SEED)
    x = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    g = torch.from_numpy(rs.randn(4, 64).astype(np.float32))
    for route, want in (("reduce", (9, 9, 0)), ("pallas", (0, 0, 17))):
        torch.manual_seed(BOTTLENECK_SEED)
        cpu = ResNet((1, 1, 1, 1), "bottleneck", features=64,
                     bn_stats=route)
        state = {k: v.clone() for k, v in cpu.state_dict().items()}
        runs = {}
        for dev in ("cpu", cuda):
            model = ResNet((1, 1, 1, 1), "bottleneck", features=64,
                           bn_stats=route)
            model.load_state_dict(state)
            model.to(dev).train()
            counts = (fused.scale_bias_relu.launches,
                      fused.scale_bias_relu_backward.launches,
                      fused.channel_stats.launches)
            epilogue = _epilogue_counts()
            loss = (model(x.to(dev)) * g.to(dev)).sum()
            loss.backward()
            torch.cuda.synchronize()
            seen = (fused.scale_bias_relu.launches - counts[0],
                    fused.scale_bias_relu_backward.launches - counts[1],
                    fused.channel_stats.launches - counts[2])
            assert seen == (want if dev != "cpu" else (0, 0, 0)), route
            sites = 17 if route == "pallas" and dev != "cpu" else 0
            assert _epilogue_counts(epilogue) == (sites, sites, sites, 0), route
            runs[str(dev)] = (loss.item(),
                              {k: p.grad.cpu()
                               for k, p in model.named_parameters()},
                              {k: b.cpu() for k, b in model.named_buffers()})
        (lc, gc, bc), (lg, gg, bg) = runs["cpu"], runs[str(cuda)]
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        for k in gc:
            assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k
        for k in bc:
            torch.testing.assert_close(bg[k], bc[k], rtol=1e-4, atol=1e-5)


def test_wrappers_raise_on_cuda_tensors_they_do_not_take(cuda):
    x = torch.zeros((2, 8, 4, 4), device=cuda)          # NCHW-contiguous
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        fused.scale_bias_relu(x, s, s)
    img = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused.normalize_u8(img.transpose(1, 2), MEAN, STD)


def test_predictor_on_cuda_matches_cpu_and_runs_the_kernels(cuda,
                                                            monkeypatch):
    # full f32 on both sides: cuDNN would otherwise convolve in TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = preset("pr3").override(**{"model.image_size": 64})
    sd = state_dict_from_jax(random_jax_variables(cfg.model, seed=0),
                             cfg.model)
    rs = np.random.RandomState(0)
    obs = {"images": {"agentview": rs.randint(0, 256, (4, 64, 64, 3),
                                              np.uint8)},
           "proprio": rs.randn(4, 32).astype(np.float32)}
    gpu = Predictor(cfg, state_dict=sd, max_batch=4, device=cuda)
    k1, k2 = fused.normalize_u8.launches, fused.scale_bias_relu.launches
    pos, quat = gpu(obs)
    assert fused.normalize_u8.launches - k1 == 1
    assert fused.scale_bias_relu.launches - k2 == 9
    cpos, cquat = Predictor(cfg, state_dict=sd, device="cpu")(obs)
    np.testing.assert_allclose(pos, cpos, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(quat, cquat, rtol=1e-3, atol=1e-4)


def test_pr5_predictor_on_cuda_matches_cpu_and_runs_the_kernels(
        cuda, monkeypatch):
    """pr5 at full width (two cameras, 3 frames of 128 x 128 through
    ResNet-18 and an LSTM each) in f32, batch 2: the card against the CPU,
    one normalize_u8 per camera and nine scale_bias_relu per encoder."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = preset("pr5").override(**{"model.dtype": "float32"})
    m = cfg.model
    sd = state_dict_from_jax(random_jax_variables(m, seed=0), m)
    rs = np.random.RandomState(0)
    obs = {"images": {c: rs.randint(0, 256, (2, 3, 128, 128, 3), np.uint8)
                      for c in m.cameras},
           "proprio": rs.randn(2, 3, m.proprio_dim).astype(np.float32)}
    gpu = Predictor(cfg, state_dict=sd, max_batch=2, device=cuda)
    k1, k2 = fused.normalize_u8.launches, fused.scale_bias_relu.launches
    pos, quat = gpu(obs)
    assert fused.normalize_u8.launches - k1 == 2
    assert fused.scale_bias_relu.launches - k2 == 18
    cpos, cquat = Predictor(cfg, state_dict=sd, device="cpu")(obs)
    np.testing.assert_allclose(pos, cpos, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(quat, cquat, rtol=1e-3, atol=1e-4)


def test_span_host_clock_meets_the_profilers_device_clock(cuda):
    """utils/prof's spans take their host times from time.time_ns(), the
    clock of torch.profiler's timestamps. In one profiler trace, 30 spans
    5 ms apart, each launching a kernel after a synchronize: each kernel
    the trace holds starts within 2 ms of its own span's host start, the
    nearest span to it, and each span's device time (CUDA events around
    it) covers its kernel. On an H100 the kernel starts 0.04 to 1.1 ms
    after the span's host start by the trace's clock (its device clock is
    aligned to the host's only to a fraction of a millisecond, on either
    side), and the trace may drop a kernel."""
    from torch.autograd import DeviceType

    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import prof

    x = torch.ones(1 << 24, device=cuda)
    x.mul_(1.0)
    torch.cuda.synchronize()
    prof.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        for i in range(30):
            time.sleep(0.005)
            torch.cuda.synchronize()
            with prof.span("rppe.clock", device=cuda, step=i):
                x.mul_(1.0)
        torch.cuda.synchronize()
    spans = prof.drain()
    kernels = [e for e in p.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    assert len(spans) == 30 and 27 <= len(kernels) <= 30
    owners = set()
    for k in kernels:
        s = min(spans, key=lambda s: abs(k.start_ns() - s["start_ns"]))
        assert abs(k.start_ns() - s["start_ns"]) <= 2_000_000, (
            k.start_ns() - s["start_ns"])
        assert s["device_ms"] * 1e6 >= k.duration_ns() - 1_000
        owners.add(s["id"])
    assert len(owners) == len(kernels)

"""The port's kernel wrappers (ops/fused.py) and their plain versions,
held against the JAX package's Pallas kernels run in interpret mode on the
CPU (finite and non-finite inputs), and the launch plans of the kernels.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.ops.image_device import (
    normalize_images as jax_normalize_images,
)
from rgb_proprioceptive_pose_estimator_tpu.ops.pallas_fused import (
    pallas_normalize_u8,
)
from rgb_proprioceptive_pose_estimator_tpu.ops.pallas_fused import (
    scale_bias_relu as jax_scale_bias_relu,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.image_device import (
    normalize_images,
)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# the oracles of tests/test_pallas.py: f32 to 1e-5; bf16 to 2e-2, about
# one bf16 ulp of the normalized range |y| < 2.7
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _nchw_channels_last(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 16, 16, 9)])
def test_normalize_u8_reference_matches_pallas(shape, dtype):
    img = np.random.RandomState(0).randint(0, 256, shape, np.uint8)
    reps = shape[-1] // 3
    ref = pallas_normalize_u8(jnp.asarray(img), MEAN * reps, STD * reps,
                              getattr(jnp, dtype))
    out = fused.normalize_u8_reference(torch.from_numpy(img), MEAN, STD,
                                       getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               atol=TOL[dtype])


def _with_nonfinite(a: np.ndarray, rs: np.random.RandomState,
                    channels: int) -> np.ndarray:
    """a (..., C) with NaN, +inf and -inf at seeded places in its first
    ``channels`` channels; the other channels stay finite."""
    a = a.copy()
    flat = a.reshape(-1, a.shape[-1])
    for value in (np.nan, np.inf, -np.inf):
        rows = rs.randint(0, flat.shape[0], 3)
        flat[rows, rs.randint(0, channels, 3)] = value
    return a


@pytest.mark.parametrize("values", ["finite", "nonfinite"])
@pytest.mark.parametrize("layout", ["nchw_channels_last", "rows_ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_relu_reference_matches_pallas(layout, dtype, values):
    rs = np.random.RandomState(1)
    shape = (2, 8, 8, 64) if layout == "nchw_channels_last" else (1500, 24)
    x = rs.randn(*shape).astype(np.float32)
    scale = rs.randn(shape[-1]).astype(np.float32)
    bias = rs.randn(shape[-1]).astype(np.float32)
    if values == "nonfinite":
        # NaN stays NaN through the ReLU (jnp.maximum, torch.clamp_min);
        # inf times a negative scale becomes 0
        x = _with_nonfinite(x, rs, channels=8)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jax_scale_bias_relu(xj, jnp.asarray(scale),
                                         jnp.asarray(bias)), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if len(shape) == 4:
        xt = xt.permute(0, 3, 1, 2)
    out = fused.scale_bias_relu_reference(xt, torch.from_numpy(scale),
                                          torch.from_numpy(bias))
    assert out.dtype == xt.dtype
    if len(shape) == 4:
        assert out.is_contiguous(memory_format=torch.channels_last)
        out = out.permute(0, 2, 3, 1)
    if values == "nonfinite":
        assert np.isnan(ref).any() and np.isinf(ref).any()
    # f32: the oracle of tests/test_pallas.py; bf16: one ulp of the output;
    # NaN and inf at the same places (assert_allclose's equal_nan)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_relu_backward_reference_matches_jax_vjp_on_nonfinite(
        dtype):
    """NaN, +inf and -inf in x and in g: the plain backward multiplies g by
    the mask, as _sbr_bwd does, so a NaN or inf g at a masked element gives
    NaN in dx and in its channel's dscale and dbias."""
    rs = np.random.RandomState(5)
    shape, c_bad = (64, 16), 6
    x = rs.randn(*shape).astype(np.float32)
    scale = (rs.rand(shape[1]) + 0.5).astype(np.float32)
    bias = (rs.randn(shape[1]) * 0.1).astype(np.float32)
    # no finite pre-activation within 1e-2 of 0: the mask cannot depend on
    # how either side rounds
    pre = x * scale + bias
    x = np.where(np.abs(pre) < 1e-2, x + 0.05, x).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    x = _with_nonfinite(x, rs, c_bad)
    g = _with_nonfinite(g, rs, c_bad)
    # and a NaN and an inf g where the mask is 0
    masked = np.argwhere(x * scale + bias < 0)
    masked = masked[masked[:, 1] < c_bad]
    g[tuple(masked[0])], g[tuple(masked[1])] = np.nan, np.inf
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(jax_scale_bias_relu, jnp.asarray(x).astype(jdt),
                     jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(t, np.float32)
            for t in vjp(jnp.asarray(g).astype(jdt))]
    tdt = getattr(torch, dtype)
    got = fused.scale_bias_relu_backward_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert got[0].dtype == tdt
    got = [t.float().numpy() for t in got]
    dx_nan = np.isnan(want[0])
    assert dx_nan[tuple(masked[0])] and dx_nan[tuple(masked[1])]
    assert np.isnan(want[1][:c_bad]).any() and np.isnan(want[2][:c_bad]).any()
    assert np.isfinite(want[2][c_bad:]).all()
    # the tolerances of tests/test_torch_train.py's VJP test; NaN and inf at
    # the same places
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol,
                               equal_nan=True)
    for g_sum, w_sum in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g_sum, w_sum, rtol=1e-4, atol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize("kind", ["uint8", "uint8_stacked", "float"])
def test_normalize_images_matches_jax(kind):
    rs = np.random.RandomState(2)
    c = 9 if kind == "uint8_stacked" else 3
    img = rs.randint(0, 256, (2, 16, 16, c), np.uint8)
    if kind == "float":
        img = (img / 255.0).astype(np.float32)
    ref = jax_normalize_images(jnp.asarray(img), MEAN, STD, jnp.float32,
                               use_pallas=True)
    out = normalize_images(torch.from_numpy(img), MEAN, STD, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_wrappers_route_cpu_tensors_to_plain_versions_without_counting():
    rs = np.random.RandomState(3)
    img = torch.from_numpy(rs.randint(0, 256, (2, 8, 8, 3), np.uint8))
    x = _nchw_channels_last(rs.randn(2, 8, 8, 16).astype(np.float32))
    s = torch.from_numpy(rs.randn(16).astype(np.float32))
    b = torch.from_numpy(rs.randn(16).astype(np.float32))
    before = (fused.normalize_u8.launches, fused.scale_bias_relu.launches)
    assert torch.equal(fused.normalize_u8(img, MEAN, STD),
                       fused.normalize_u8_reference(img, MEAN, STD))
    assert torch.equal(fused.scale_bias_relu(x, s, b),
                       fused.scale_bias_relu_reference(x, s, b))
    assert (fused.normalize_u8.launches,
            fused.scale_bias_relu.launches) == before


def _bn_epilogue_args(rs, shape=(2, 8, 8, 16), dtype=torch.float32):
    """x, g (NCHW in channels_last memory) and the seven f32 per-channel
    vectors of the BN epilogue's wrappers: scale, bias, the two sums,
    gamma, mean and inv."""
    c = shape[-1]
    x = _nchw_channels_last(rs.randn(*shape).astype(np.float32)).to(dtype)
    g = _nchw_channels_last(rs.randn(*shape).astype(np.float32)).to(dtype)
    vec = [torch.from_numpy(rs.randn(c).astype(np.float32)) for _ in range(6)]
    inv = torch.from_numpy(rs.rand(c).astype(np.float32) + 0.5)
    return x, g, vec + [inv]


def test_bn_epilogue_wrappers_route_cpu_tensors_to_plain_versions_without_counting():
    x, g, (s, b, sg, sgx, gamma, mean, inv) = _bn_epilogue_args(
        np.random.RandomState(5))
    n = x.numel() // x.shape[1]
    wrappers = (fused.bn_affine_act, fused.bn_act_sums, fused.bn_act_dx)

    def counts():
        return tuple(getattr(w, k) for w in wrappers
                     for k in ("launches", "scalar_launches"))

    before = counts()
    for act in (False, True):
        assert torch.equal(fused.bn_affine_act(x, s, b, act),
                           fused.bn_affine_act_reference(x, s, b, act))
        for got, want in zip(fused.bn_act_sums(x, g, s, b, act),
                             fused.bn_act_sums_reference(x, g, s, b, act)):
            assert torch.equal(got, want)
        args = (x, g, s, b, act, sg, sgx, gamma, mean, inv, n)
        assert torch.equal(fused.bn_act_dx(*args),
                           fused.bn_act_dx_reference(*args))
    assert counts() == before


def test_bn_epilogue_relu_passes_the_gradient_where_the_forward_is_positive():
    """With act, the forward is relu(x*s + b) and the backward's gm is g
    where the forward's output is positive, else 0, a NaN g included; the
    sums and dx without act are those of gm with act off."""
    rs = np.random.RandomState(6)
    x, g, (s, b, sg, sgx, gamma, mean, inv) = _bn_epilogue_args(rs)
    g = g.clone()
    fused.channel_rows(g)[::7, 3] = float("nan")
    y = fused.bn_affine_act(x, s, b, True)
    assert torch.equal(y, torch.relu(fused.bn_affine_act(x, s, b, False)))
    on = y > 0
    assert on.any() and (~on).any()
    gm = torch.where(on, g, torch.zeros_like(g))
    assert gm.isnan().any() and not gm[~on].isnan().any()
    for got, want in zip(fused.bn_act_sums(x, g, s, b, True),
                         fused.bn_act_sums(x, gm, s, b, False)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    n = x.numel() // x.shape[1]
    torch.testing.assert_close(
        fused.bn_act_dx(x, g, s, b, True, sg, sgx, gamma, mean, inv, n),
        fused.bn_act_dx(x, gm, s, b, False, sg, sgx, gamma, mean, inv, n),
        rtol=0, atol=0, equal_nan=True)


def _bad_bn_epilogue(case):
    x = torch.zeros((2, 8, 4, 4)).to(memory_format=torch.channels_last)
    v = torch.ones(8)
    vecs = (v, v, v, v, v)                   # sums, gamma, mean, inv
    if case == "float16_x":
        return lambda: fused.bn_affine_act(x.half(), v, v, True)
    if case == "nchw_contiguous":
        return lambda: fused.bn_affine_act(x.contiguous(), v, v, False)
    if case == "float64_bias":
        return lambda: fused.bn_act_sums(x, x, v, v.double(), True)
    if case == "g_other_layout":
        return lambda: fused.bn_act_sums(x, x.contiguous(), v, v, True)
    if case == "g_other_dtype":
        return lambda: fused.bn_act_dx(x, x.to(torch.bfloat16), v, v, True,
                                       *vecs, 32)
    if case == "wrong_channels":
        return lambda: fused.bn_act_dx(x, x, v, v, False, v[:4], *vecs[1:],
                                       32)
    if case == "three_d":
        return lambda: fused.channels_innermost(x[0])
    raise AssertionError(case)


@pytest.mark.parametrize("case,error", [
    ("float16_x", TypeError), ("nchw_contiguous", ValueError),
    ("float64_bias", TypeError), ("g_other_layout", ValueError),
    ("g_other_dtype", ValueError), ("wrong_channels", ValueError),
    ("three_d", ValueError)])
def test_bn_epilogue_wrappers_reject_what_the_kernels_do_not_take(case,
                                                                  error):
    with pytest.raises(error):
        _bad_bn_epilogue(case)()


def _bad_normalize(case):
    img = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    if case == "float_input":
        return lambda: fused.normalize_u8(img.float(), MEAN, STD)
    if case == "float16_output":
        return lambda: fused.normalize_u8(img, MEAN, STD, torch.float16)
    if case == "channels_not_multiple":
        return lambda: fused.normalize_u8(img[..., :2].contiguous(), MEAN, STD)
    if case == "not_contiguous":
        return lambda: fused.normalize_u8(img.transpose(1, 2), MEAN, STD)
    raise AssertionError(case)


def _bad_sbr(case):
    x = torch.zeros((2, 8, 4, 4)).to(memory_format=torch.channels_last)
    s, b = torch.ones(8), torch.zeros(8)
    if case == "float16_x":
        return lambda: fused.scale_bias_relu(x.half(), s, b)
    if case == "float64_scale":
        return lambda: fused.scale_bias_relu(x, s.double(), b)
    if case == "nchw_contiguous":
        return lambda: fused.scale_bias_relu(x.contiguous(), s, b)
    if case == "three_d":
        return lambda: fused.scale_bias_relu(x[0], s, b)
    if case == "wrong_channels":
        return lambda: fused.scale_bias_relu(x, s[:4], b[:4])
    if case == "needs_grad":
        # the first derivative is a kernel; a second one is refused
        def second_derivative():
            s.requires_grad_()
            y = fused.scale_bias_relu(x + 1.0, s, b)
            (ds,) = torch.autograd.grad(y.sum(), s, create_graph=True)
            return ds
        return second_derivative
    raise AssertionError(case)


@pytest.mark.parametrize("case,error", [
    ("normalize:float_input", TypeError),
    ("normalize:float16_output", TypeError),
    ("normalize:channels_not_multiple", ValueError),
    ("normalize:not_contiguous", ValueError),
    ("sbr:float16_x", TypeError),
    ("sbr:float64_scale", TypeError),
    ("sbr:nchw_contiguous", ValueError),
    ("sbr:three_d", ValueError),
    ("sbr:wrong_channels", ValueError),
    ("sbr:needs_grad", NotImplementedError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(case, error):
    which, name = case.split(":")
    call = _bad_normalize(name) if which == "normalize" else _bad_sbr(name)
    with pytest.raises(error):
        call()


# ---------------------------------------------------------------------------
# the launch plan of the two reductions (channel_stats and
# scale_bias_relu_backward), checked against a numpy emulation of the
# kernels' row, channel and fold mappings (csrc/fused.cu)
# ---------------------------------------------------------------------------

# (M, C) of the twenty channel_stats sites and nine scale_bias_relu sites of
# a pr3 step at batch 128 (the stem and each stage), then ragged M and the C
# of the scalar path
STEP_REDUCTION_SITES = [(128 * 64 * 64, 64), (128 * 32 * 32, 64),
                       (128 * 16 * 16, 128), (128 * 8 * 8, 256),
                       (128 * 4 * 4, 512)]
# (M, C) of a pr4 step at batch 256 (ResNet-50 at 224x224): the BN-ReLU
# sites (the stem and each Bottleneck's conv1 and conv2), then the other
# BatchNorms (conv3 and the shortcuts), up to C = 2048 at 7x7
PR4_SBR_SITES = [(256 * 112 * 112, 64), (256 * 56 * 56, 64),
                 (256 * 56 * 56, 128), (256 * 28 * 28, 128),
                 (256 * 28 * 28, 256), (256 * 14 * 14, 256),
                 (256 * 14 * 14, 512), (256 * 7 * 7, 512)]
PR4_REDUCTION_SITES = PR4_SBR_SITES + [
    (256 * 56 * 56, 256), (256 * 28 * 28, 512), (256 * 14 * 14, 1024),
    (256 * 7 * 7, 2048)]
RAGGED_REDUCTIONS = [(100003, 64), (4099, 64), (4099, 100), (1001, 3),
                     (7, 512), (1, 3), (3, 100), (100003, 512)]
RED_THREADS = 512
ROW_PTRS = {"aligned": 1 << 20, "misaligned": (1 << 20) + 2}


def _emulate_rows(plan, m, c):
    """Which rows and channels the threads of a kernel over rows read and
    write, as hit counts (csrc/fused.cu: a thread's chunk is blockIdx.x *
    tx + threadIdx.x, its rows threadIdx.y, + ty, ... of its group)."""
    tx, ty = plan.block
    tiles, groups = plan.grid
    rows_hit = np.zeros(m, np.int64)
    for g in range(groups):
        start = g * plan.rows_per_group
        n = min(plan.rows_per_group, m - start)
        for slot in range(ty):                 # thread row slot threadIdx.y
            rows_hit[start + np.arange(slot, n, ty)] += 1
    chunks = np.arange(tiles)[:, None] * tx + np.arange(tx)[None, :]
    ch = (chunks[..., None] * plan.vec + np.arange(plan.vec)).reshape(-1)
    ch_hit = np.bincount(ch[ch < c], minlength=c)
    return rows_hit, ch_hit


def _emulate_plan(plan, m, c):
    """Which rows and channels the reduction's threads read, and which row
    groups the folding block reads, as hit counts."""
    tx, ty = plan.block
    groups = plan.grid[1]
    rows_hit, ch_hit = _emulate_rows(plan, m, c)
    # the last block of a tile: (slice, pair) threads over the groups
    pairs = 2 * tx * plan.vec
    slices = RED_THREADS // pairs
    fold_hit = np.bincount(np.concatenate(
        [np.arange(s, groups, slices) for s in range(slices)]),
        minlength=groups)
    return rows_hit, ch_hit, fold_hit, pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", STEP_REDUCTION_SITES + RAGGED_REDUCTIONS
                         + PR4_REDUCTION_SITES)
def test_reduction_plan_covers_every_row_and_channel_once(m, c, dtype):
    vec16 = 16 // dtype.itemsize
    base = 1 << 20                               # a 16-byte aligned address
    for ptrs in ((base,), (base, base + 4096, base + 8192),
                 (base + dtype.itemsize,), (base, base + 4096, base + 2)):
        plan = fused._reduction_plan(m, c, dtype, ptrs, sms=132)
        aligned = all(p % 16 == 0 for p in ptrs)
        want_vec = vec16 if c % vec16 == 0 and aligned else 1
        assert plan.vec == want_vec, (ptrs, plan)
        tx, ty = plan.block
        tiles, groups = plan.grid
        # CUDA's limits, and the kernel's: 512 threads, tx a power of two
        # within a warp, tiles of at most 64 channels, grid.y <= 65535,
        # 32-bit offsets within a group
        assert tx * ty == RED_THREADS and tx & (tx - 1) == 0 and tx <= 32
        assert tx * plan.vec <= 64
        assert 1 <= tiles <= 2 ** 31 - 1 and 1 <= groups <= 65535
        assert plan.rows_per_group * c <= 2 ** 31 - 1
        assert plan.rows_per_group % ty == 0
        rows_hit, ch_hit, fold_hit, pairs = _emulate_plan(plan, m, c)
        assert (rows_hit == 1).all() and (ch_hit == 1).all()
        assert pairs <= RED_THREADS and (fold_hit == 1).all()


@pytest.mark.parametrize("m,c", STEP_REDUCTION_SITES)
def test_reduction_plan_fills_the_card_at_large_sites_and_not_at_small(m, c):
    for dtype in (torch.float32, torch.bfloat16):
        plan = fused._reduction_plan(m, c, dtype, (0,), sms=132)
        tx, ty = plan.block
        slices = RED_THREADS // (2 * tx * plan.vec)
        # the folding block's threads read at most 32 partials each
        assert -(-plan.groups // slices) <= 32
        # each thread takes at least one full loop trip of rows
        assert plan.rows_per_group >= ty * 8
        if m * c >= 2 ** 22:                 # 16 MB of f32: fill the card
            assert plan.tiles * plan.groups >= 128
        else:
            assert plan.tiles * plan.groups < 132
    with pytest.raises(ValueError):
        fused._reduction_plan(0, 64, torch.float32, (0,), sms=132)


# ---------------------------------------------------------------------------
# the launch plans of K2's forward and K1, checked against a numpy
# emulation of the kernels' index mappings (csrc/fused.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align", ["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", STEP_REDUCTION_SITES + RAGGED_REDUCTIONS
                         + [(1001, 24)] + PR4_SBR_SITES)
def test_sbr_forward_plan_covers_every_element_once(m, c, dtype, align):
    ptr = ROW_PTRS[align]
    plan = fused._sbr_forward_plan(m, c, dtype, (1 << 20, ptr), sms=132)
    vec16 = 16 // dtype.itemsize
    # 16-byte accesses at every pr3 and pr4 site; one element where C or a
    # pointer forbids them
    want_vec = vec16 if c % vec16 == 0 and align == "aligned" else 1
    assert plan.vec == want_vec
    if (m, c) in STEP_REDUCTION_SITES + PR4_SBR_SITES and align == "aligned":
        assert plan.vec == vec16
    tx, ty = plan.block
    tiles, groups = plan.grid
    # CUDA's limits and the kernel's: 512 threads, tx a power of two within
    # a warp, grid.y <= 65535, 32-bit offsets within a group
    assert tx * ty == RED_THREADS and tx & (tx - 1) == 0 and tx <= 32
    assert 1 <= groups <= 65535 and plan.rows_per_group * c <= 2 ** 31 - 1
    # every element once: each row once and each channel once (a thread's
    # channels are those of its chunk, whatever row it is at)
    rows_hit, ch_hit = _emulate_rows(plan, m, c)
    assert (rows_hit == 1).all() and (ch_hit == 1).all()
    # one wave of at most two blocks per SM (unless one group's tiles are
    # more); at a large site it fills the card; each thread gets a whole
    # loop trip of 4 rows, and no block is planned without rows
    assert tiles * groups <= max(2 * 132, tiles)
    if m * c >= 2 ** 22:
        assert tiles * groups >= 128
    assert plan.rows_per_group % (4 * ty) == 0
    assert (groups - 1) * plan.rows_per_group < m


# (M, C) of the forty BatchNorm sites of a pr5 step (two encoders of 20,
# 3072 frames each at 128 px): the stem, then each stage of ResNet-18
PR5_BN_SITES = [(3072 * 64 * 64, 64), (3072 * 32 * 32, 64),
                (3072 * 16 * 16, 128), (3072 * 8 * 8, 256),
                (3072 * 4 * 4, 512)]


@pytest.mark.parametrize("align", ["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", PR5_BN_SITES + STEP_REDUCTION_SITES
                         + RAGGED_REDUCTIONS)
def test_dx_plan_covers_every_element_once_at_one_block_per_sm(m, c, dtype,
                                                               align):
    """bn_act_dx's plan: K2's forward plan at one block per SM, 16-byte
    accesses where x, g and dx allow them, every element once."""
    ptr = ROW_PTRS[align]
    plan = fused._sbr_forward_plan(m, c, dtype, (1 << 20, 1 << 21, ptr),
                                   sms=132,
                                   blocks_per_sm=fused._DX_BLOCKS_PER_SM)
    vec16 = 16 // dtype.itemsize
    assert plan.vec == (vec16 if c % vec16 == 0 and align == "aligned"
                        else 1)
    tx, ty = plan.block
    tiles, groups = plan.grid
    assert tx * ty == RED_THREADS and tx & (tx - 1) == 0 and tx <= 32
    assert 1 <= groups <= 65535 and plan.rows_per_group * c <= 2 ** 31 - 1
    rows_hit, ch_hit = _emulate_rows(plan, m, c)
    assert (rows_hit == 1).all() and (ch_hit == 1).all()
    # one wave of one block per SM (unless one group's tiles are more), a
    # large site filling the card
    assert tiles * groups <= max(132, tiles)
    if m * c >= 2 ** 22:
        assert tiles * groups >= 128
    assert plan.rows_per_group % (4 * ty) == 0
    assert (groups - 1) * plan.rows_per_group < m


NORMALIZE_CASES = [((128, 128, 128, 3), 3), ((8, 128, 128, 9), 3),
                   ((3, 37, 41, 3), 3), ((2, 64, 64, 3), 3),
                   ((2, 5, 7, 9), 9), ((4, 8, 8, 64), 64), ((1, 1, 1, 5), 5),
                   ((1, 3, 5, 48), 48), ((256, 224, 224, 3), 3)]


@pytest.mark.parametrize("align", ["aligned", "misaligned"])
@pytest.mark.parametrize("shape,nstats", NORMALIZE_CASES)
def test_normalize_plan_fixes_each_thread_phase_and_covers_every_element_once(
        shape, nstats, align):
    n = math.prod(shape)
    plan = fused._normalize_plan(n, nstats, (ROW_PTRS[align], 1 << 21),
                                 sms=132)
    threads = plan.blocks * 256
    vector = align == "aligned" and n >= 16
    assert plan.vec == (16 if vector else 1)
    assert plan.n_vec == (n // 16 if vector else 0)
    assert 1 <= plan.blocks <= max(3 * 132, 8)
    if plan.n_vec:
        # the vector loop (csrc/fused.cu): chunk k is read by thread t = k %
        # vec_stride on trip k // vec_stride; a warp's lanes read 32
        # neighbouring chunks, and byte `off` of the warp's 512 is stored by
        # lane (off % 32W) // W, store q = off // 32W, output r = off % W,
        # with the constant it gathered on trip 0
        s = plan.vec_stride
        assert 32 <= s <= threads and s % 32 == 0
        k = np.arange(plan.n_vec, dtype=np.int64)
        t, trip = k % s, k // s
        lane = t % 32
        first = k - lane                         # the warp's first chunk
        assert (first == trip * s + (t - lane)).all()
        for w in (4, 8):                         # f32 and bf16 outputs
            for b in range(16):
                off = 16 * lane + b
                storer = (off % (32 * w)) // w
                q, r = off // (32 * w), off % w
                const = (16 * (t - lane) + storer * w + q * 32 * w + r) % nstats
                assert (const == (16 * k + b) % nstats).all()
    # the one-element loop: elements 16 n_vec .. n, element e taken by the
    # thread (e - begin) % scalar_stride-th from the grid's end, with the
    # constant of its first; the tail's threads are idle in the vector loop
    # where the grid has idle threads
    begin = 16 * plan.n_vec
    assert n - begin < 16 or not vector
    assert nstats <= plan.scalar_stride <= threads
    e = np.arange(begin, n, dtype=np.int64)
    t = (e - begin) % plan.scalar_stride
    assert ((begin + t) % nstats == e % nstats).all()
    if vector and n > begin and threads - plan.vec_stride >= n - begin:
        assert (threads - 1 - t >= plan.vec_stride).all()
    # one wave, filled where the accesses allow: one access per thread
    # where the wave holds them all, and no block without work
    accesses = plan.n_vec if vector else n
    if accesses >= 3 * 132 * 256:
        assert plan.blocks == 3 * 132
    elif accesses >= 8 * 256:
        assert (plan.blocks - 1) * 256 < accesses <= plan.blocks * 256

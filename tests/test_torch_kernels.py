"""The port's kernel wrappers (ops/fused.py) and their plain versions,
held against the JAX package's Pallas kernels run in interpret mode on the
CPU. The CUDA kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda.py)."""

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


@pytest.mark.parametrize("layout", ["nchw_channels_last", "rows_ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_relu_reference_matches_pallas(layout, dtype):
    rs = np.random.RandomState(1)
    shape = (2, 8, 8, 64) if layout == "nchw_channels_last" else (1500, 24)
    x = rs.randn(*shape).astype(np.float32)
    scale = rs.randn(shape[-1]).astype(np.float32)
    bias = rs.randn(shape[-1]).astype(np.float32)
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
    # f32: the oracle of tests/test_pallas.py; bf16: one ulp of the output
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                                   atol=1e-6)


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

"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where JAX is not installed; tests/conftest.py
imports JAX, so run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every test skips, from a fixture, where torch.cuda.is_available() is False.

Tolerances: the kernels compute x * s + b as one fused multiply-add where
the plain version rounds twice, so in f32 the two differ by about one ulp
of the largest intermediate, M = max|x|*max|s| + max|b|: tol = 1e-6 (1 + M).
In bf16 that ulp can flip the rounding of the output by one bf16 ulp:
tol = 2^-7 (1 + M).
"""

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


def _tol(dtype, magnitude):
    return (1e-6 if dtype == torch.float32 else 2.0 ** -7) * (1.0 + magnitude)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 16, 16, 9),
                                   (3, 37, 41, 3)])
def test_normalize_u8_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.randint(0, 256, shape, generator=g, device=cuda,
                        dtype=torch.uint8)
    before = fused.normalize_u8.launches
    out = fused.normalize_u8(img, MEAN, STD, dtype)
    torch.cuda.synchronize()
    assert fused.normalize_u8.launches == before + 1
    ref = fused.normalize_u8_reference(img, MEAN, STD, dtype)
    assert out.dtype == dtype and out.shape == img.shape
    magnitude = max(1 / (255 * s) for s in STD) * 255 + max(
        m / s for m, s in zip(MEAN, STD))
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _tol(dtype, magnitude)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (3, 512, 4, 4),
                                   (1001, 24)])
def test_scale_bias_relu_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    s = torch.rand(c, generator=g, device=cuda) + 0.5
    b = torch.randn(c, generator=g, device=cuda) * 0.5
    before = fused.scale_bias_relu.launches
    out = fused.scale_bias_relu(x, s, b)
    torch.cuda.synchronize()
    assert fused.scale_bias_relu.launches == before + 1
    ref = fused.scale_bias_relu_reference(x, s, b)
    assert out.dtype == dtype and out.stride() == x.stride()
    magnitude = (x.float().abs().max() * s.abs().max()
                 + b.abs().max()).item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _tol(dtype, magnitude)


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

"""Conv + BatchNorm + ReLU building blocks (counterpart of the JAX
package's ``models/blocks.py``), eval mode only.

Tensors inside the encoders are NCHW in ``channels_last`` memory, the
JAX package's NHWC layout seen through torch's dimension order: with
convolution weights in ``channels_last`` too, every convolution returns
``channels_last`` and the BN epilogue kernel sees channels innermost.

As in flax with ``dtype=bfloat16``, parameters stay f32 and are cast to
the compute dtype at each call; BatchNorm's folded scale and bias stay
f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import scale_bias_relu


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: f32 parameters, computed in
    ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNormAct(nn.Module):
    """Eval-mode BatchNorm with running statistics, folded into one
    per-channel ``scale * x + bias`` in f32, then ReLU if ``act``.

    With ``act`` the epilogue is the ``scale_bias_relu`` kernel (output in
    x's dtype, which is the compute dtype); without it, plain torch cast to
    ``compute_dtype``."""

    def __init__(self, features: int, eps: float = 1e-5, act: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.act = act
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNormAct runs in eval mode only in this port; batch "
                "statistics and their kernels come with the training slice "
                "(call .eval())")
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        if self.act:
            return scale_bias_relu(x, scale, bias)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = x.float() * scale.view(shape) + bias.view(shape)
        return y.to(self.compute_dtype)


class ConvBNReLU(nn.Module):
    """conv (no bias) -> BatchNormAct, the unit whose epilogue is the
    scale-bias-ReLU kernel."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1), act: bool = True,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(in_features, features, kernel, stride, padding,
                              bias=False)
        self.bn = BatchNormAct(features, eps=eps, act=act,
                               compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x.to(self.compute_dtype),
                     c.weight.to(self.compute_dtype), None, c.stride,
                     c.padding)
        return self.bn(x)

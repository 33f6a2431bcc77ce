"""Conv + BatchNorm + ReLU building blocks (counterpart of the JAX
package's ``models/blocks.py``), in train and eval mode.

Tensors inside the encoders are NCHW in ``channels_last`` memory, the
JAX package's NHWC layout seen through torch's dimension order: with
convolution weights in ``channels_last`` too, every convolution returns
``channels_last`` and the BN epilogue kernel sees channels innermost.

As in flax with ``dtype=bfloat16``, parameters stay f32 and are cast to
the compute dtype at each call; BatchNorm's folded scale and bias stay
f32.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import scale_bias_relu
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused_bn import bn_train
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

BN_STATS = ("reduce", "matmul", "pallas")


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
    """BatchNorm with torch semantics, then ReLU if ``act``.

    Eval mode folds the running statistics into one per-channel
    ``scale * x + bias`` in f32. Train mode normalizes by the batch
    statistics (biased variance), computed as ``stats_impl`` says:

    - "reduce": per-channel f32 sums of x and x^2 (``torch.sum``); the
      folded scale and bias then go to the ``scale_bias_relu`` kernel
      (with ``act``), whose backward is a kernel too; autograd reaches x
      through the statistics as well.
    - "matmul" / "pallas": ``ops/fused_bn.bn_train`` with its statistics
      from plain contractions or from the ``channel_stats`` kernel, the
      ReLU (with ``act``) part of it: the forward and its closed-form
      backward are the ``bn_affine_act``, ``bn_act_sums`` and
      ``bn_act_dx`` kernels.

    On a rank of a data-parallel group the statistics are the global
    batch's, as XLA's psum makes them in the JAX package: the sums go
    through ``parallel/dist.all_reduce_sum`` (whose backward sums the
    cotangents over the ranks) and are divided by the global count.

    Train mode also updates the running statistics, outside autograd, as
    torch does: ``running = momentum * running + (1 - momentum) * batch``
    with the flax ``momentum`` 0.9 (torch's 0.1) and the unbiased
    ``n / (n - 1)`` variance; not while ``update_running`` is False, which
    ``running_stats_frozen`` sets for the recomputation of an activation
    checkpoint (so that a step updates them once, as flax's ``nn.remat``
    does).

    With ``act`` the eval epilogue is the ``scale_bias_relu`` kernel
    (output in x's dtype, which is the compute dtype); without it, plain
    torch cast to ``compute_dtype``."""

    def __init__(self, features: int, eps: float = 1e-5, act: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 stats_impl: str = "reduce", momentum: float = 0.9):
        super().__init__()
        if stats_impl not in BN_STATS:
            raise ValueError(f"stats_impl must be one of {BN_STATS}, got "
                             f"{stats_impl!r}")
        self.eps = eps
        self.act = act
        self.compute_dtype = compute_dtype
        self.stats_impl = stats_impl
        self.momentum = momentum
        self.update_running = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _affine(self, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        if self.act:
            return scale_bias_relu(x, scale, bias)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = x.float() * scale.view(shape) + bias.view(shape)
        return y.to(self.compute_dtype)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        n: int) -> None:
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            m, m_t = self.momentum, 1.0 - self.momentum
            self.running_mean.copy_(m * self.running_mean + m_t * mean)
            self.running_var.copy_(m * self.running_var + m_t * unbiased)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            bias = self.bias - self.running_mean * scale
            return self._affine(x, scale, bias)
        n = x.numel() // x.shape[1] * dist.world()
        if self.stats_impl == "reduce":
            dims = tuple(d for d in range(x.ndim) if d != 1)
            xf = x.float()
            s, ss = torch.sum(xf, dim=dims), torch.sum(torch.square(xf),
                                                       dim=dims)
            if dist.world() > 1:
                s, ss = dist.all_reduce_sum(torch.stack([s, ss])).unbind(0)
            mean = s / n
            var = torch.clamp_min(ss / n - torch.square(mean), 0.0)
            scale = self.weight * torch.rsqrt(var + self.eps)
            y = self._affine(x, scale, self.bias - mean * scale)
        else:
            y, mean, var = bn_train(x, self.weight, self.bias, self.eps,
                                    self.stats_impl, act=self.act)
            y = y.to(self.compute_dtype)
        if self.update_running:
            self._update_running(mean.detach(), var.detach(), n)
        return y


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Inside the block, the BatchNormAct layers of ``module`` leave their
    running statistics as they are (the recomputation of an activation
    checkpoint: the forward that ran first has updated them)."""
    layers = [m for m in module.modules() if isinstance(m, BatchNormAct)]
    for m in layers:
        m.update_running = False
    try:
        yield
    finally:
        for m in layers:
            m.update_running = True


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax ``padding="SAME"`` along one dim: the output has
    ceil(size / stride) positions, and the padding they need is split low
    ``floor(p / 2)``, high ``ceil(p / 2)`` ((0, 1) for 64 -> 32 at k = 3)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBNReLU(nn.Module):
    """conv (no bias) -> BatchNormAct, the unit whose epilogue is the
    scale-bias-ReLU kernel.

    ``padding`` is symmetric per dim, torch's convention, or ``"SAME"``,
    flax's: padded by ``same_padding`` with ``F.pad`` (which keeps
    ``channels_last``) before a pad-0 conv, since flax pads a stride-2
    conv on the high side only where torch's ``padding=1`` pads both."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Union[Tuple[int, int], str] = (1, 1),
                 act: bool = True,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_stats: str = "reduce"):
        super().__init__()
        if isinstance(padding, str) and padding != "SAME":
            raise ValueError(f"padding must be a pair or 'SAME', got "
                             f"{padding!r}")
        self.compute_dtype = compute_dtype
        self.same = padding == "SAME"
        self.conv = nn.Conv2d(in_features, features, kernel, stride,
                              0 if self.same else padding, bias=False)
        self.bn = BatchNormAct(features, eps=eps, act=act,
                               compute_dtype=compute_dtype,
                               stats_impl=bn_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.same:
            (top, bottom), (left, right) = (
                same_padding(n, k, s) for n, k, s in
                zip(x.shape[-2:], c.kernel_size, c.stride))
            x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x.to(self.compute_dtype),
                     c.weight.to(self.compute_dtype), None, c.stride,
                     c.padding)
        return self.bn(x)

"""Training-mode BatchNorm with a hand-written backward (counterpart of the
JAX package's ``ops/fused_bn.py``).

``bn_train`` normalizes x by its own batch statistics. The statistics come
from the ``channel_stats`` kernel (``stats_impl="pallas"``, one read of x)
or from plain torch contractions (``"matmul"``, ``ops/bn_stats.py``). The
formula is the JAX package's: ``var = max(ss/n - mean^2, 0)`` (biased, as
torch normalizes) and ``rsqrt(var + eps)``. The backward is the JAX
package's closed form in plain torch (XLA there, not Pallas): per-channel
``sum(g)`` and ``sum(g * x)``, then ``dx = g*a + x*b + c`` in one pass.

The ``mean``/``var`` outputs feed only the caller's running-statistics
update (models/blocks.BatchNormAct): they are not differentiable, as the
JAX VJP ignores their cotangents.

On a rank of a data-parallel group (``parallel/dist.py``) the forward
sums ``(sum, sumsq)`` over the ranks and divides by the global count, and
the backward sums ``(sum(g), sum(g * x))`` over the ranks for dx, as the
JAX package's psum does. The gamma and beta gradients it returns stay the
rank's own sums: DistributedDataParallel averages parameter gradients
over the ranks, so global sums there would come out N times too large
(what ``torch.nn.SyncBatchNorm`` does too).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.bn_stats import (
    channel_sum_sumsq_matmul,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import channel_stats
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

STATS_IMPLS = ("matmul", "pallas")


def _channel_view(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.ndim - 2))


def _stats(x: torch.Tensor, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """per-channel (sum, sumsq) in f32."""
    if impl == "pallas":
        return channel_stats(x)
    return channel_sum_sumsq_matmul(x)


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stats_impl):
        n = x.numel() // x.shape[1] * dist.world()
        s, ss = _stats(x, stats_impl)
        if dist.world() > 1:
            s, ss = dist.sum_(torch.stack([s, ss])).unbind(0)
        mean = s / n
        var = torch.clamp_min(ss / n - torch.square(mean), 0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        bias = beta - mean * scale
        y = (x.float() * _channel_view(x, scale)
             + _channel_view(x, bias)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, mean, inv = ctx.saved_tensors
        n = x.numel() // x.shape[1] * dist.world()
        dims = tuple(d for d in range(x.ndim) if d != 1)
        gf = g.float()
        xf = x.float()
        sum_g = torch.sum(gf, dim=dims)
        cross = torch.sum(gf * xf, dim=dims)
        sum_g_xhat = (cross - mean * sum_g) * inv     # = sum(g * xhat)
        sum_g_all, sum_g_xhat_all = sum_g, sum_g_xhat
        if dist.world() > 1:
            # the global batch's sums for dx; dgamma and dbeta below stay
            # this rank's (DDP averages them)
            sum_g_all, cross_all = dist.sum_(
                torch.stack([sum_g, cross])).unbind(0)
            sum_g_xhat_all = (cross_all - mean * sum_g_all) * inv
        # dx = (gamma*inv/n) * (n*g - sum_g - xhat*sum_g_xhat)
        #    = g*a + x*b + c, per-channel a, b, c
        a = gamma * inv
        b = -gamma * torch.square(inv) * sum_g_xhat_all / n
        c = -(a * sum_g_all / n) - b * mean
        dx = (gf * _channel_view(x, a) + xf * _channel_view(x, b)
              + _channel_view(x, c)).to(x.dtype)
        return dx, sum_g_xhat, sum_g, None, None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-5, stats_impl: str = "matmul"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm of x (channels at dim 1; NCHW in channels_last
    memory for ``stats_impl="pallas"``) by its own batch statistics.

    Returns (y, mean, var): y in x's dtype; mean and var (biased) are f32
    per-channel batch statistics for the running-statistics update, and
    carry no gradient."""
    if stats_impl not in STATS_IMPLS:
        raise ValueError(f"bn_train: stats_impl must be one of {STATS_IMPLS}, "
                         f"got {stats_impl!r}")
    return _BNTrain.apply(x, gamma, beta, eps, stats_impl)

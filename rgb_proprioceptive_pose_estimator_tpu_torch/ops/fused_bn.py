"""Training-mode BatchNorm with a hand-written backward (counterpart of the
JAX package's ``ops/fused_bn.py``), and the ReLU after it.

``bn_train`` normalizes x by its own batch statistics. The statistics come
from the ``channel_stats`` kernel (``stats_impl="pallas"``, one read of x)
or from plain torch contractions (``"matmul"``, ``ops/bn_stats.py``). The
formula is the JAX package's: ``var = max(ss/n - mean^2, 0)`` (biased, as
torch normalizes) and ``rsqrt(var + eps)``. With ``act`` the ReLU is part
of the function. The epilogue is three kernels of ``ops/fused.py`` (plain
versions on the CPU): the forward ``act(x * scale + bias)``
(``bn_affine_act``), then the JAX package's closed-form backward (XLA
there, not Pallas) in two passes over x and g: the per-channel
``sum(gm)`` and ``sum(gm * x)`` of the gradient gm the ReLU passes
(``bn_act_sums``), then ``dx = gm*a + x*b + c`` (``bn_act_dx``).

The ``mean``/``var`` outputs feed only the caller's running-statistics
update (models/blocks.BatchNormAct): they are not differentiable, as the
JAX VJP ignores their cotangents.

On a rank of a data-parallel group (``parallel/dist.py``) the forward
sums ``(sum, sumsq)`` over the ranks and divides by the global count, and
the backward sums ``(sum(gm), sum(gm * x))`` over the ranks between its
two passes, for dx, as the JAX package's psum does. The gamma and beta
gradients it returns stay the rank's own sums: DistributedDataParallel
averages parameter gradients over the ranks, so global sums there would
come out N times too large (what ``torch.nn.SyncBatchNorm`` does too).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.bn_stats import (
    channel_sum_sumsq_matmul,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import (
    bn_act_dx,
    bn_act_sums,
    bn_affine_act,
    channel_stats,
    channels_innermost,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

STATS_IMPLS = ("matmul", "pallas")


def _stats(x: torch.Tensor, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """per-channel (sum, sumsq) in f32."""
    if impl == "pallas":
        return channel_stats(x)
    return channel_sum_sumsq_matmul(x)


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, stats_impl, act):
        n = x.numel() // x.shape[1] * dist.world()
        s, ss = _stats(x, stats_impl)
        if dist.world() > 1:
            s, ss = dist.sum_(torch.stack([s, ss])).unbind(0)
        mean = s / n
        var = torch.clamp_min(ss / n - torch.square(mean), 0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        bias = beta - mean * scale
        # the kernels take channels innermost; the matmul route's
        # statistics take any layout
        x = channels_innermost(x)
        y = bn_affine_act(x, scale, bias, act)
        ctx.act = act
        ctx.save_for_backward(x, gamma, mean, inv, scale, bias)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, mean, inv, scale, bias = ctx.saved_tensors
        n = x.numel() // x.shape[1] * dist.world()
        # the layout of a gradient is not the caller's to choose (max
        # pooling, residual adds and convolutions may hand back
        # NCHW-contiguous memory): copy, and count the copy
        laid = channels_innermost(g)
        bn_train.grad_layout_copies += laid is not g
        g = laid
        sum_g, sum_gx = bn_act_sums(x, g, scale, bias, ctx.act)
        # this rank's sums for dgamma and dbeta (DDP averages them)
        dgamma = (sum_gx - mean * sum_g) * inv          # = sum(gm * xhat)
        dbeta = sum_g
        if dist.world() > 1:
            # the global batch's sums for dx
            sum_g, sum_gx = dist.sum_(torch.stack([sum_g, sum_gx])).unbind(0)
        dx = bn_act_dx(x, g, scale, bias, ctx.act, sum_g, sum_gx, gamma, mean,
                       inv, n)
        return dx, dgamma, dbeta, None, None, None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-5, stats_impl: str = "matmul", act: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm of x (channels at dim 1; 4-D NCHW or 2-D (M, C);
    in channels_last memory for ``stats_impl="pallas"``) by its own batch
    statistics, then ReLU if ``act``.

    Returns (y, mean, var): y in x's dtype, channels innermost; mean and var
    (biased) are f32 per-channel batch statistics for the
    running-statistics update, and carry no gradient. A gradient of y laid
    out otherwise than x is copied first, and counted in
    ``bn_train.grad_layout_copies``."""
    if stats_impl not in STATS_IMPLS:
        raise ValueError(f"bn_train: stats_impl must be one of {STATS_IMPLS}, "
                         f"got {stats_impl!r}")
    return _BNTrain.apply(x, gamma, beta, eps, stats_impl, act)


bn_train.grad_layout_copies = 0

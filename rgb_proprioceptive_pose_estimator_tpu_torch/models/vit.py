"""ViT image encoder (counterpart of the JAX package's ``models/vit.py``):
patch embedding, pre-LN transformer blocks, LayerNorm, mean or class-token
pooling, and a feature projection.

Parameters keep flax's names and, for attention, flax's per-head layout,
so that ``utils/convert.py`` carries them with no reshape:

    patch_embed.weight (dim, C, patch, patch), .bias   conv, torch layout
    cls_token (1, 1, dim)                              pool="cls" only
    pos_embed (1, tokens, dim)
    block{i}.ln1/ln2.weight, .bias                     flax LayerNorm scale, bias
    block{i}.attn.{query,key,value}.weight (dim, heads, dim/heads),
                                      .bias (heads, dim/heads)
    block{i}.attn.out.weight (heads, dim/heads, dim), .bias (dim,)
    block{i}.mlp1/mlp2                                 Dense, torch layout
    ln_out, proj

As in flax with ``dtype=bfloat16``, parameters stay f32 and are cast to
the compute dtype at each call. LayerNorm is flax's: epsilon 1e-6 and the
variance as E[x^2] - E[x]^2 in f32 (``use_fast_variance``), output in the
compute dtype. Attention is ``F.scaled_dot_product_attention`` (flax's
``MultiHeadDotProductAttention``, which XLA compiles, is no Pallas
kernel); the MLP's GELU is the exact (erf) one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import Dense

POOLS = ("mean", "cls")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` over the last dim: f32 statistics
    with the variance E[x^2] - E[x]^2 (clamped at 0), f32 scale and bias,
    written in ``compute_dtype``."""

    def __init__(self, features: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class HeadDense(nn.Module):
    """flax ``DenseGeneral`` of attention: ``weight`` (dim, heads, head_dim)
    and ``bias`` (heads, head_dim) project (B, N, dim) to (B, heads, N,
    head_dim); with ``out=True``, ``weight`` (heads, head_dim, dim) and
    ``bias`` (dim,) project that back to (B, N, dim)."""

    def __init__(self, dim: int, heads: int, out: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = dim // heads
        self.out, self.heads = out, heads
        self.compute_dtype = compute_dtype
        shape = (heads, hd, dim) if out else (dim, heads, hd)
        fan_in = dim
        self.weight = nn.Parameter(torch.empty(shape).normal_(
            0.0, 1.0 / math.sqrt(fan_in)))
        self.bias = nn.Parameter(torch.zeros(dim if out else (heads, hd)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if self.out:                      # (B, H, N, D) -> (B, N, E)
            bsz, h, n, d = x.shape
            y = x.transpose(1, 2).reshape(bsz, n, h * d)
            return F.linear(y, w.reshape(h * d, -1).t(), b)
        bsz, n, e = x.shape                # (B, N, E) -> (B, H, N, D)
        y = F.linear(x.to(dt), w.reshape(e, -1).t(), b.reshape(-1))
        return y.view(bsz, n, self.heads, -1).transpose(1, 2)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout): softmax(q k^T / sqrt(head_dim)) v per head."""

    def __init__(self, dim: int, heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if heads < 1 or dim % heads:
            raise ValueError(f"ViT dim {dim} must divide by heads {heads}")
        self.query = HeadDense(dim, heads, compute_dtype=compute_dtype)
        self.key = HeadDense(dim, heads, compute_dtype=compute_dtype)
        self.value = HeadDense(dim, heads, compute_dtype=compute_dtype)
        self.out = HeadDense(dim, heads, out=True,
                             compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.scaled_dot_product_attention(self.query(x), self.key(x),
                                           self.value(x))
        return self.out(y)


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> MHSA -> +res, LN -> MLP(exact GELU) -> +res."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, compute_dtype=compute_dtype)
        self.attn = Attention(dim, heads, compute_dtype)
        self.ln2 = LayerNorm(dim, compute_dtype=compute_dtype)
        self.mlp1 = Dense(dim, dim * mlp_ratio, compute_dtype)
        self.mlp2 = Dense(dim * mlp_ratio, dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x))))


class ViT(nn.Module):
    """NHWC images in the compute dtype, any channel count (3T for T
    stacked frames) -> (B, features): patch embedding, ``depth`` blocks,
    LayerNorm, then the tokens' mean (pool="mean") or a prepended class
    token (pool="cls", torchvision's convention), projected to
    ``features``. ``image_size`` (H = W) fixes the token count, and so
    ``pos_embed``'s shape."""

    def __init__(self, features: int, image_size: int, in_channels: int = 3,
                 patch: int = 16, dim: int = 384, depth: int = 6,
                 heads: int = 6, mlp_ratio: int = 4, pool: str = "mean",
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"ViT.pool must be 'mean' or 'cls', got "
                             f"{pool!r}")
        if patch < 1 or image_size % patch:
            raise ValueError(f"ViT input {image_size}x{image_size} not "
                             f"divisible by patch {patch}")
        self.patch, self.dim, self.pool = patch, dim, pool
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, patch)
        tokens = (image_size // patch) ** 2 + (pool == "cls")
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, tokens, dim).normal_(0.0, 0.02))
        self.blocks = [f"block{i}" for i in range(depth)]
        for name in self.blocks:
            self.add_module(name, TransformerBlock(dim, heads, mlp_ratio,
                                                   compute_dtype))
        self.ln_out = LayerNorm(dim, compute_dtype=compute_dtype)
        self.proj = Dense(dim, features, compute_dtype)
        self.patch_embed.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f"ViT input {h}x{w} not divisible by patch "
                             f"{self.patch}")
        dt = self.compute_dtype
        pe = self.patch_embed
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), pe.weight.to(dt),
                     pe.bias.to(dt), pe.stride)
        x = y.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        if self.pool == "cls":
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, self.dim), x],
                          dim=1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"ViT input {h}x{w} gives {x.shape[1]} tokens; "
                             f"pos_embed has {self.pos_embed.shape[1]}")
        x = x + self.pos_embed.to(dt)
        for name in self.blocks:
            block = getattr(self, name)
            if self.remat and self.training:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_out(x)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.proj(x)

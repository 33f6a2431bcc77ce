"""Frozen arithmetic of the benchmark: the operations a training step of
a configuration needs, and the bytes the hand-written kernels' sites
must move, both from shapes alone, whatever implements them.

Operations count the convolutions and matrix products, two per
multiply-add; a training step is three forward passes' worth (forward,
and the backward's two products per layer). Elementwise work,
normalisation and the optimizer are left out, as model-FLOP
utilisation counts them.

Bytes count each input read once and each output written once:
``scale_bias_relu`` reads x and writes y; its backward reads x and the
output gradient and writes dx (with two f32 per channel for scale and
bias each way). The sites are the BatchNorm layers followed by a ReLU,
whose epilogue the kernel is (models/blocks.BatchNormAct with ``act``).
``channel_stats`` reads x and writes two f32 sums per channel, at every
BatchNorm layer of a step whose statistics it takes (``model.bn_stats``
"pallas").
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_RESNETS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet_convs(backbone: str, hw: int, in_ch: int = 3
                 ) -> List[Tuple[int, int, int, int, bool]]:
    """Every convolution of the ResNet at ``hw`` input pixels, in order:
    (in channels, out channels, kernel, output pixels, ReLU after its
    BatchNorm)."""
    stages, kind = _RESNETS[backbone]
    convs = []
    s = _out(hw, 7, 2, 3)
    convs.append((in_ch, 64, 7, s * s, True))
    s = _out(s, 3, 2, 1)                      # max pool
    c_in = 64
    for stage, n in enumerate(stages):
        width = 64 * 2 ** stage
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            so = _out(s, 3, stride, 1)
            if kind == "basic":
                out = width
                convs.append((c_in, width, 3, so * so, True))
                convs.append((width, width, 3, so * so, False))
            else:
                out = 4 * width
                convs.append((c_in, width, 1, s * s, True))
                convs.append((width, width, 3, so * so, True))
                convs.append((width, out, 1, so * so, False))
            if stride != 1 or c_in != out:
                convs.append((c_in, out, 1, so * so, False))
            c_in, s = out, so
    return convs


def resnet_width(backbone: str) -> int:
    stages, kind = _RESNETS[backbone]
    return 64 * 2 ** (len(stages) - 1) * (4 if kind == "bottleneck" else 1)


def resnet_macs(backbone: str, hw: int, in_ch: int = 3,
                classes: int = 0) -> int:
    """Multiply-adds of one image's forward pass, with a ``classes``-way
    classifier when given (torchvision's published counts include it)."""
    macs = sum(ci * co * k * k * px
               for ci, co, k, px, _ in resnet_convs(backbone, hw, in_ch))
    return macs + resnet_width(backbone) * classes


def _lstm(m: Dict) -> bool:
    return m["temporal_frames"] > 1 and m["temporal_mode"] == "lstm"


def forward_macs_per_sample(m: Dict) -> int:
    """Multiply-adds of one sample's forward pass, model config ``m``."""
    frames = m["temporal_frames"]
    feats = m["image_features"]
    if _lstm(m):
        images, in_ch = frames, 3
    else:
        images, in_ch = 1, 3 * frames
    per_cam = images * (resnet_macs(m["backbone"], m["image_size"], in_ch)
                        + resnet_width(m["backbone"]) * feats)
    if _lstm(m):
        per_cam += frames * 4 * feats * (feats + feats)
    macs = per_cam * len(m["cameras"])
    d = feats * len(m["cameras"])
    if m["use_proprio"]:
        width = m["proprio_dim"] * frames
        for h in list(m["proprio_hidden"]) + [m["proprio_features"]]:
            macs += width * h
            width = h
        d += m["proprio_features"]
    for h in m["head_hidden"]:
        macs += d * h
        d = h
    macs += d * (3 + (6 if m["rot_rep"] == "rot6d" else 4))
    return macs


def train_flops_per_sample(m: Dict) -> float:
    """Operations of one sample in a training step: 3 forward passes,
    2 per multiply-add."""
    return 3.0 * 2.0 * forward_macs_per_sample(m)


def sbr_sites(m: Dict, rows: int) -> List[Tuple[int, int]]:
    """(rows M, channels C) of every scale_bias_relu site of a step on
    ``rows`` samples: the BatchNorm layers with a ReLU, per image."""
    frames = m["temporal_frames"]
    images, in_ch = (frames, 3) if _lstm(m) else (1, 3 * frames)
    per_image = [(px, co) for _, co, _, px, act in
                 resnet_convs(m["backbone"], m["image_size"], in_ch) if act]
    n = rows * images
    return [(n * px, c) for _ in m["cameras"] for px, c in per_image]


def fused_bytes_per_step(m: Dict, rows: int) -> Dict[str, float]:
    """Bytes each hand-written kernel's sites of one training step on
    ``rows`` samples need, by kernel: scale_bias_relu forward and
    backward at every site. (normalize_u8 does not run in a step whose
    frames come augmented, as floats, from the device augmentation.)"""
    elt = 2 if m["dtype"] == "bfloat16" else 4
    fwd = bwd = 0.0
    for mm, c in sbr_sites(m, rows):
        fwd += 2 * mm * c * elt + 2 * c * 4
        bwd += 3 * mm * c * elt + 4 * c * 4
    return {"scale_bias_relu": fwd, "scale_bias_relu_backward": bwd}


def bn_sites(m: Dict, rows: int) -> List[Tuple[int, int]]:
    """(rows M, channels C) of every BatchNorm layer of a step on
    ``rows`` samples, per image."""
    frames = m["temporal_frames"]
    images, in_ch = (frames, 3) if _lstm(m) else (1, 3 * frames)
    per_image = [(px, co) for _, co, _, px, _ in
                 resnet_convs(m["backbone"], m["image_size"], in_ch)]
    n = rows * images
    return [(n * px, c) for _ in m["cameras"] for px, c in per_image]


def channel_stats_bytes_per_step(m: Dict, rows: int) -> float:
    """Bytes the channel_stats sites of one training step on ``rows``
    samples need: every BatchNorm layer's input read once, its two f32
    sums per channel written once."""
    elt = 2 if m["dtype"] == "bfloat16" else 4
    return float(sum(mm * c * elt + 2 * c * 4 for mm, c in bn_sites(m, rows)))

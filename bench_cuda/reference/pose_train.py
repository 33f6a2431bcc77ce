"""Plain PyTorch reference of the pose estimator's first training steps.

It follows, from the raw demos and weights that the benchmark hands both
sides, what one training step of the pose estimator is defined to do:

- the sampler: epoch ``e`` visits the samples in the order of
  ``numpy.random.RandomState((data_seed + e) % (2**31 - 1)).permutation``;
  a sample is a (demo, step) pair, its frames are steps ``t - T + 1 .. t``
  of its demo clamped at the demo's start, its label the pose at ``t``;
- the random streams: a ``torch.Generator`` on the device seeded from
  ``SeedSequence([train_seed, stream, step])``, stream 0 for the frame
  augmentation and stream 1 for camera dropout;
- the augmentation: per camera, in camera order, crop offsets
  ``U{0..H-out}`` (rows, then columns), the jitter's on-mask ``U < p``
  and its brightness, contrast and saturation factors ``U(1-a, 1+a)``;
  a crop of the uint8 frames, then brightness, contrast about each
  frame's mean grey, saturation about each pixel's grey, clipped to
  [0, 1];
- the model: per camera a ResNet (He et al., arXiv:1512.03385) with
  training-mode BatchNorm (biased variance to normalise, unbiased into
  the running statistics with momentum 0.9), global average pooling and
  a ReLU projection, then for several frames an LSTM (gates i, f, g, o)
  whose last output is the camera's feature, zeroed where the camera
  drops out; a ReLU MLP over the z-scored proprioception; two ReLU head
  layers and a linear output split into a position and a unit
  quaternion;
- the loss: the mean squared position error plus the mean chordal
  distance ``1 - <q, q'>^2``;
- AdamW (decoupled decay, bias-corrected moments) at the warm-up-cosine
  learning rate of the update count.

Everything is float32 with TF32 off, unless ``precision`` asks for
bfloat16 (a witness) or for the float8 control. Nothing here imports the program under test.
Each ResNet unit is recomputed in the backward pass
(``torch.utils.checkpoint``), so that a global batch at its full size
fits beside nothing else on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
QUAT_EPS = 1e-8

RESNETS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}
GATES = ("i", "f", "g", "o")


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: Tensor, kind: str) -> Tensor:
    """x rounded to ``kind`` and back to float32: ``bf16``, or float8
    ``e4m3`` / ``e5m2`` under a per-tensor scale that maps the largest
    magnitude to the format's largest value."""
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    dtype, top = ((torch.float8_e4m3fn, E4M3_MAX) if kind == "e4m3"
                  else (torch.float8_e5m2, E5M2_MAX))
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x.float() / scale).to(dtype).float() * scale


class _Held(torch.autograd.Function):
    """A value held in a lower precision: rounded on the way forward,
    its gradient rounded on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Precision:
    """The precision of what the configurations compute in their compute
    dtype: convolution and matrix-product operands and results, the
    normalised images, BatchNorm outputs, residual sums, the LSTM's gates
    and the gradients flowing back through them. Parameters, BatchNorm
    statistics, the LSTM's cell and output, the output layer and the loss
    stay float32, as they do in bfloat16 configurations.

    ``f32``: nothing rounded (the reference). ``bf16``: those values in
    bfloat16. ``fp8``: in float8, e4m3 forward and e5m2 for gradients
    (the control, one precision below the configurations' bfloat16)."""

    NAMES = ("f32", "bf16", "fp8")

    def __init__(self, name: str = "f32"):
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}")
        self.name = name
        self.kinds = {"bf16": ("bf16", "bf16"),
                      "fp8": ("e4m3", "e5m2")}.get(name)

    def act(self, x: Tensor) -> Tensor:
        """A value computed in the compute dtype."""
        if self.kinds is None:
            return x
        return _Held.apply(x, *self.kinds)

    def param(self, w: Tensor) -> Tensor:
        """A float32 parameter cast to the compute dtype for a product."""
        if self.kinds is None:
            return w
        return w + (_round(w, self.kinds[0]) - w).detach()


def _conv(x: Tensor, w: Tensor, stride: int, pad: int,
          prec: Precision) -> Tensor:
    return prec.act(F.conv2d(prec.act(x), prec.param(w), None, stride, pad))


def _dense(x: Tensor, w: Tensor, b: Optional[Tensor],
           prec: Precision) -> Tensor:
    y = prec.act(x) @ prec.param(w).t()
    return prec.act(y if b is None else y + prec.param(b))


# ---------------------------------------------------------------------------
# weights: names, shapes and initial values
# ---------------------------------------------------------------------------


def _resnet_units(backbone: str) -> List[Tuple[str, List[Tuple]]]:
    """The ResNet's units in order: ("stem", convs) and one per block,
    each conv as (name, in, out, kernel, stride, pad, relu)."""
    stages, kind = RESNETS[backbone]
    units = [("stem", [("stem", 3, 64, 7, 2, 3, True)])]
    width_in = 64
    for s, n in enumerate(stages):
        width = 64 * 2 ** s
        for i in range(n):
            stride = 2 if (i == 0 and s > 0) else 1
            name = f"stage{s + 1}_block{i}"
            if kind == "basic":
                out = width
                convs = [(f"{name}.conv1", width_in, width, 3, stride, 1, True),
                         (f"{name}.conv2", width, width, 3, 1, 1, False)]
            else:
                out = 4 * width
                convs = [(f"{name}.conv1", width_in, width, 1, 1, 0, True),
                         (f"{name}.conv2", width, width, 3, stride, 1, True),
                         (f"{name}.conv3", width, out, 1, 1, 0, False)]
            if stride != 1 or width_in != out:
                convs.append((f"{name}.downsample", width_in, out, 1,
                              stride, 0, False))
            units.append((name, convs))
            width_in = out
    return units


def resnet_width(backbone: str) -> int:
    """Channels of the ResNet's last stage."""
    stages, kind = RESNETS[backbone]
    return 64 * 2 ** (len(stages) - 1) * (4 if kind == "bottleneck" else 1)


def uses_lstm(m: Dict) -> bool:
    return m["temporal_frames"] > 1 and m["temporal_mode"] == "lstm"


def param_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight and buffer of model config
    ``m``, under the state-dict names both sides load. init: ``he``
    (normal, std sqrt(2 / fan_out)), ``lecun`` (normal, std
    sqrt(1 / fan_in)), ``zeros``, ``ones``."""
    out = []
    feats = m["image_features"]
    frames_in = 3 if uses_lstm(m) else 3 * m["temporal_frames"]
    for cam in m["cameras"]:
        enc = f"encoder_{cam}."
        for _, convs in _resnet_units(m["backbone"]):
            for name, cin, cout, k, _, _, _ in convs:
                cin = frames_in if name == "stem" else cin
                out.append((f"{enc}{name}.conv.weight", (cout, cin, k, k),
                            "he"))
                for b, init in (("weight", "ones"), ("bias", "zeros"),
                                ("running_mean", "zeros"),
                                ("running_var", "ones")):
                    out.append((f"{enc}{name}.bn.{b}", (cout,), init))
        out.append((f"{enc}proj.weight", (feats, resnet_width(m["backbone"])),
                    "lecun"))
        out.append((f"{enc}proj.bias", (feats,), "zeros"))
        if uses_lstm(m):
            for g in GATES:
                out.append((f"lstm_{cam}.i{g}.weight", (feats, feats),
                            "lecun"))
            for g in GATES:
                out.append((f"lstm_{cam}.h{g}.weight", (feats, feats),
                            "lecun"))
                out.append((f"lstm_{cam}.h{g}.bias", (feats,), "zeros"))
    d = feats * len(m["cameras"])
    if m["use_proprio"]:
        if m["proprio_normalize"]:
            out.append(("proprio.proprio_mean", (m["proprio_dim"],), "zeros"))
            out.append(("proprio.proprio_std", (m["proprio_dim"],), "ones"))
        width = m["proprio_dim"] * m["temporal_frames"]
        layers = [f"dense{i}" for i in range(len(m["proprio_hidden"]))]
        for name, h in zip(layers + ["proj"],
                           list(m["proprio_hidden"]) + [m["proprio_features"]]):
            out.append((f"proprio.{name}.weight", (h, width), "lecun"))
            out.append((f"proprio.{name}.bias", (h,), "zeros"))
            width = h
        d += m["proprio_features"]
    for i, h in enumerate(m["head_hidden"]):
        out.append((f"head{i}.weight", (h, d), "lecun"))
        out.append((f"head{i}.bias", (h,), "zeros"))
        d = h
    rot = 6 if m["rot_rep"] == "rot6d" else 4
    out.append(("pose_out.weight", (3 + rot, d), "lecun"))
    out.append(("pose_out.bias", (3 + rot,), "zeros"))
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var", "proprio_mean",
                          "proprio_std"))


def make_weights(m: Dict, seed: int, device) -> Dict[str, Tensor]:
    """Initial float32 weights of model config ``m`` from ``seed``: one
    normal draw on ``device`` for all of them, each leaf a slice scaled to
    its init's std."""
    specs = param_specs(m)
    random = [(n, s, i) for n, s, i in specs if i in ("he", "lecun")]
    total = sum(math.prod(s) for _, s, _ in random)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            if init == "he":
                std = math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
            else:
                std = math.sqrt(1.0 / shape[1])
            out[name] = flat[at:at + n].view(shape) * std
            at += n
    return out


# ---------------------------------------------------------------------------
# data: samples, batches, proprio statistics
# ---------------------------------------------------------------------------


class Demos:
    """The raw demos: ``frames`` {camera: uint8 (N, H, W, 3)}, ``proprio`` float32 (N, D), ``pose`` float32 (N, 7) (position,
    quaternion), flat over demos in order, and ``offsets`` (n_demos + 1,)
    where demo d holds rows offsets[d] .. offsets[d + 1]."""

    def __init__(self, frames: Dict[str, np.ndarray], proprio: np.ndarray,
                 pose: np.ndarray, offsets: np.ndarray):
        self.frames = frames
        self.proprio = proprio
        self.pose = pose
        self.offsets = np.asarray(offsets, np.int64)


def samples(offsets: np.ndarray, lookahead: int = 0) -> np.ndarray:
    """(n, 2) (demo, step) of every sample, demo-major."""
    rows = []
    for d in range(len(offsets) - 1):
        steps = int(offsets[d + 1] - offsets[d])
        rows.extend((d, t) for t in range(steps - lookahead))
    return np.asarray(rows, np.int64).reshape(-1, 2)


def batch_samples(n_samples: int, batch: int, data_seed: int,
                  step: int) -> np.ndarray:
    """Sample ids of global batch ``step``: whole batches of one epoch's
    permutation, the tail of an epoch dropped."""
    per_epoch = n_samples // batch
    epoch, pos = divmod(step, per_epoch)
    perm = np.random.RandomState(
        (data_seed + epoch) % (2 ** 31 - 1)).permutation(n_samples)
    return perm[pos * batch:(pos + 1) * batch]


def proprio_stats(proprio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dim mean and std (floored at 1e-6) over every row."""
    return (proprio.mean(0, dtype=np.float64).astype(np.float32),
            np.maximum(proprio.std(0, dtype=np.float64), 1e-6)
            .astype(np.float32))


def make_batch(demos: Demos, ids: np.ndarray, frames_per_sample: int,
               lookahead: int, device) -> Dict:
    """Rows (B, T) of the frames, proprio (B, T, D), label position and
    unit quaternion of the samples ``ids``."""
    sample = samples(demos.offsets, lookahead)[ids]
    t = sample[:, 1:2] + np.arange(-frames_per_sample + 1, 1)[None]
    rows = demos.offsets[sample[:, 0]][:, None] + np.clip(t, 0, None)
    label = rows[:, -1] + lookahead
    quat = demos.pose[label, 3:7].astype(np.float64)
    quat /= np.maximum(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-8)
    return {"rows": torch.from_numpy(rows).to(device),
            "proprio": torch.from_numpy(demos.proprio[rows]).to(device),
            "pos": torch.from_numpy(demos.pose[label, :3]).to(device),
            "quat": torch.from_numpy(quat.astype(np.float32)).to(device)}


# ---------------------------------------------------------------------------
# random streams and augmentation
# ---------------------------------------------------------------------------


def stream(seed: int, kind: int, step: int, device) -> torch.Generator:
    """The generator of random stream ``kind`` at step ``step``."""
    mixed = np.random.SeedSequence([seed, kind, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def draw_augmentation(gen: torch.Generator, n: int, h: int, w: int,
                      d: Dict, out_hw: int) -> Dict[str, Tensor]:
    """One camera's draws for ``n`` samples, data config ``d``."""
    dev = gen.device
    out = {"oy": torch.randint(0, h - out_hw + 1, (n,), generator=gen,
                               device=dev),
           "ox": torch.randint(0, w - out_hw + 1, (n,), generator=gen,
                               device=dev)}
    if d["jitter_prob"] > 0:
        out["on"] = (torch.rand(n, generator=gen, device=dev)
                     < d["jitter_prob"]).float()
        for name in ("brightness", "contrast", "saturation"):
            a = d[f"jitter_{name}"]
            if a > 0:
                lo = max(0.0, 1.0 - a)
                out[name] = lo + (1.0 + a - lo) * torch.rand(
                    n, generator=gen, device=dev)
    return out


def augment(frames: Tensor, draws: Dict[str, Tensor], d: Dict,
            out_hw: int) -> Tensor:
    """uint8 (B, T, H, W, 3) -> float32 (B, T, out, out, 3) in [0, 1]."""
    b, t, _, w, c = frames.shape
    grid = torch.arange(out_hw, device=frames.device)
    rows = (draws["oy"][:, None] + grid).view(b, 1, out_hw, 1, 1)
    x = torch.gather(frames, 2, rows.expand(b, t, out_hw, w, c))
    cols = (draws["ox"][:, None] + grid).view(b, 1, 1, out_hw, 1)
    x = torch.gather(x, 3, cols.expand(b, t, out_hw, out_hw, c))
    x = x.float() / 255.0
    if d["jitter_prob"] > 0:
        on = draws["on"].view(b, 1, 1, 1, 1)

        def factor(name):
            return 1.0 + on * (draws[name].view(b, 1, 1, 1, 1) - 1.0)

        grey_w = torch.tensor([0.299, 0.587, 0.114], device=x.device)
        if d["jitter_brightness"] > 0:
            x = x * factor("brightness")
        if d["jitter_contrast"] > 0:
            mean = (x * grey_w).sum(-1).mean(dim=(2, 3))[..., None, None,
                                                        None]
            x = mean + (x - mean) * factor("contrast")
        if d["jitter_saturation"] > 0:
            grey = (x * grey_w).sum(-1, keepdim=True)
            x = grey + (x - grey) * factor("saturation")
        x = x.clamp(0.0, 1.0)
    return x


def check_supported(cfg: Dict) -> None:
    """The reference covers the configurations' data route: pad-and-crop
    without flips or hue, device augmentation, camera dropout without
    proprio dropout, quaternion output."""
    m, d = cfg["model"], cfg["data"]
    unsupported = {
        "data.hflip_prob": d["hflip_prob"] != 0,
        "data.jitter_hue": d["jitter_hue"] != 0,
        "data.crop_scale": tuple(d["crop_scale"]) != (1.0, 1.0),
        "data.crop_ratio": tuple(d["crop_ratio"]) != (1.0, 1.0),
        "model.proprio_dropout": m["proprio_dropout"] != 0,
        "model.rot_rep": m["rot_rep"] != "quat",
        "model.backbone": m["backbone"] not in RESNETS,
        "model.use_proprio": not m["use_proprio"],
        "train.optimizer": cfg["train"]["optimizer"] != "adamw",
        "train.grad_accum": cfg["train"]["grad_accum"] != 1,
        "train.grad_clip": cfg["train"]["grad_clip"] != 0,
        "train.pos_loss": cfg["train"]["pos_loss"] != "mse",
        "train.rot_loss": cfg["train"]["rot_loss"] != "chordal",
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise ValueError(f"the reference does not cover {bad}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _batch_norm(x: Tensor, w: Dict[str, Tensor], name: str,
                stats: Dict[str, Tuple[Tensor, Tensor]]) -> Tensor:
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    stats[name] = (mean.detach(), var.detach() * (n / max(n - 1, 1)))
    scale = w[f"{name}.bn.weight"] * torch.rsqrt(var + BN_EPS)
    return ((x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
            + w[f"{name}.bn.bias"].view(1, -1, 1, 1))


def _unit(x: Tensor, convs, w: Dict[str, Tensor], prefix: str,
          stats: Dict, prec: Precision) -> Tensor:
    """One ResNet unit: the stem with its max pool, or a residual block."""
    if convs[0][0] == "stem":
        name, _, _, _, stride, pad, _ = convs[0]
        y = _conv(x, w[f"{prefix}{name}.conv.weight"], stride, pad, prec)
        y = torch.relu(prec.act(_batch_norm(y, w, prefix + name, stats)))
        return F.max_pool2d(y, 3, 2, 1)
    main = [c for c in convs if not c[0].endswith("downsample")]
    short = [c for c in convs if c[0].endswith("downsample")]
    y = x
    for name, _, _, _, stride, pad, relu in main:
        y = _conv(y, w[f"{prefix}{name}.conv.weight"], stride, pad, prec)
        y = prec.act(_batch_norm(y, w, prefix + name, stats))
        y = torch.relu(y) if relu else y
    if short:
        name, _, _, _, stride, pad, _ = short[0]
        r = _conv(x, w[f"{prefix}{name}.conv.weight"], stride, pad, prec)
        x = prec.act(_batch_norm(r, w, prefix + name, stats))
    return torch.relu(prec.act(y + x))


def resnet(x: Tensor, w: Dict[str, Tensor], prefix: str, backbone: str,
           stats: Dict, prec: Precision, recompute: bool) -> Tensor:
    """NCHW float32 frames -> (N, image_features) features."""
    for _, convs in _resnet_units(backbone):
        if recompute and torch.is_grad_enabled():
            x = checkpoint(_unit, x, convs, w, prefix, stats, prec,
                           use_reentrant=False)
        else:
            x = _unit(x, convs, w, prefix, stats, prec)
    x = x.mean(dim=(2, 3))
    return torch.relu(_dense(x, w[f"{prefix}proj.weight"],
                             w[f"{prefix}proj.bias"], prec))


def lstm(x: Tensor, w: Dict[str, Tensor], prefix: str,
         prec: Precision) -> Tensor:
    """(B, T, F) -> the last step's output (B, H), from a zero state."""
    b, t, _ = x.shape
    w_in = torch.cat([w[f"{prefix}i{g}.weight"] for g in GATES])
    w_h = torch.cat([w[f"{prefix}h{g}.weight"] for g in GATES])
    b_h = torch.cat([w[f"{prefix}h{g}.bias"] for g in GATES])
    h = x.new_zeros((b, w_h.shape[1]))
    c = torch.zeros_like(h)
    for s in range(t):
        gates = prec.act(_dense(x[:, s], w_in, None, prec)
                         + _dense(h, w_h, b_h, prec))
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = (prec.act(torch.sigmoid(v)) for v in (i, f, o))
        c = f * c + i * prec.act(torch.tanh(g))
        h = o * torch.tanh(c)
    return h


def unit_quaternion(q: Tensor) -> Tensor:
    return q / torch.sqrt((q * q).sum(-1, keepdim=True) + QUAT_EPS ** 2)


def forward(w: Dict[str, Tensor], images: Dict[str, Tensor],
            proprio: Tensor, keep: Optional[Tensor], m: Dict,
            stats: Dict, prec: Precision,
            recompute: bool = True) -> Tuple[Tensor, Tensor]:
    """Training-mode forward: images {camera: float (B, T, H, W, 3) in
    [0, 1]}, proprio (B, T, D), keep (B, cameras) or None ->
    (position (B, 3), unit quaternion (B, 4))."""
    mean = torch.tensor(m["image_mean"], device=proprio.device)
    std = torch.tensor(m["image_std"], device=proprio.device)
    feats = []
    for ci, cam in enumerate(m["cameras"]):
        x = images[cam]
        b, t = x.shape[:2]
        x = prec.act((x - mean) / std)
        if uses_lstm(m):
            x = x.reshape((b * t,) + x.shape[2:]).permute(0, 3, 1, 2)
        else:
            x = x.permute(0, 2, 3, 1, 4).reshape(b, *x.shape[2:4], -1)
            x = x.permute(0, 3, 1, 2)
        f = resnet(x, w, f"encoder_{cam}.", m["backbone"], stats, prec,
                   recompute)
        if uses_lstm(m):
            f = lstm(f.reshape(b, t, -1), w, f"lstm_{cam}.", prec)
        if keep is not None:
            f = f * keep[:, ci:ci + 1]
        feats.append(f)
    s = proprio
    if m["proprio_normalize"]:
        s = (s - w["proprio.proprio_mean"]) / w["proprio.proprio_std"]
    s = s.reshape(s.shape[0], -1)
    for i in range(len(m["proprio_hidden"])):
        s = torch.relu(_dense(s, w[f"proprio.dense{i}.weight"],
                              w[f"proprio.dense{i}.bias"], prec))
    feats.append(torch.relu(_dense(s, w["proprio.proj.weight"],
                                   w["proprio.proj.bias"], prec)))
    h = torch.cat(feats, dim=-1)
    for i in range(len(m["head_hidden"])):
        h = torch.relu(_dense(h, w[f"head{i}.weight"], w[f"head{i}.bias"],
                              prec))
    out = h @ w["pose_out.weight"].t() + w["pose_out.bias"]
    return out[:, :3], unit_quaternion(out[:, 3:7])


def pose_loss(pos: Tensor, quat: Tensor, tpos: Tensor, tquat: Tensor,
              t: Dict) -> Tensor:
    rot = 1.0 - torch.square((unit_quaternion(quat)
                              * unit_quaternion(tquat)).sum(-1))
    return (t["pos_weight"] * torch.mean(torch.square(pos - tpos))
            + t["rot_weight"] * torch.mean(rot))


def learning_rate(t: Dict, count: int) -> float:
    """Warm-up from 0 then cosine decay (or a constant), at update
    ``count``."""
    lr, warm = t["lr"], t["warmup_steps"]
    if t["lr_schedule"] == "cosine":
        w = max(warm, 1)
        if count < w:
            return lr * count / w
        decay = max(t["steps"], warm + 1) - w
        c = min(count - w, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
    if t["lr_schedule"] == "constant":
        return lr * min(count / warm, 1.0) if warm > 0 else lr
    raise ValueError(f"the reference has no schedule {t['lr_schedule']!r}")


# ---------------------------------------------------------------------------
# the first steps
# ---------------------------------------------------------------------------


def train_steps(cfg: Dict, demos: Demos, weights: Dict[str, Tensor],
                train_seed: int, data_seed: int, device, steps: int = 3,
                precision: str = "f32", batch_rows: Optional[Tuple] = None,
                loss_rows: Optional[Tuple] = None, flip: bool = False
                ) -> Dict:
    """``steps`` training steps of config ``cfg`` from ``weights`` (the
    proprio statistics are worked out here) on global batches 0 ..
    steps - 1. Returns the losses, the per-leaf norms of the first
    gradient, and what the steps changed (the parameters and the
    BatchNorm running statistics): per-leaf norms, and the changes
    themselves on the host.

    Faults for calibrating the comparison: ``batch_rows`` (lo, hi) keeps
    only those rows of every global batch (the rest is left out);
    ``loss_rows`` (lo, hi) takes the loss over those rows alone, with the
    forward over all of them (one rank's gradient, unexchanged);
    ``flip`` steps along the gradient instead of against it."""
    check_supported(cfg)
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    prec = Precision(precision)
    dev = torch.device(device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        frames = {c: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for c, v in demos.frames.items()}
        w = {k: v.detach().to(dev, torch.float32, copy=True)
             for k, v in weights.items()}
        mean, std = proprio_stats(demos.proprio)
        w["proprio.proprio_mean"] = torch.from_numpy(mean).to(dev)
        w["proprio.proprio_std"] = torch.from_numpy(std).to(dev)
        start = {k: v.clone() for k, v in w.items()}
        names = [n for n, _, _ in param_specs(m) if not is_buffer(n)]
        for n in names:
            w[n].requires_grad_(True)
        moments = {n: (torch.zeros_like(w[n]), torch.zeros_like(w[n]))
                   for n in names}
        n_samples = len(samples(demos.offsets, d["target_lookahead"]))
        frames_t = m["temporal_frames"]
        out_hw = m["image_size"]
        b1, b2 = ADAM_BETAS
        losses, first_grad = [], {}
        for step in range(steps):
            ids = batch_samples(n_samples, d["batch_size"], data_seed, step)
            batch = make_batch(demos, ids, frames_t, d["target_lookahead"],
                               dev)
            gen = stream(train_seed, 0, step, dev)
            images = {}
            for cam in m["cameras"]:
                src = frames[cam]
                draws = draw_augmentation(gen, len(ids), src.shape[1],
                                          src.shape[2], d, out_hw)
                images[cam] = augment(src[batch["rows"]], draws, d, out_hw)
            keep = None
            if m["camera_dropout"] > 0:
                u = torch.rand((len(ids), len(m["cameras"])),
                               generator=stream(train_seed, 1, step, dev),
                               device=dev)
                keep = (u < 1.0 - m["camera_dropout"]).float()
            proprio, tpos, tquat = batch["proprio"], batch["pos"], \
                batch["quat"]
            if batch_rows is not None:
                sl = slice(*batch_rows)
                images = {c: v[sl] for c, v in images.items()}
                proprio, tpos, tquat = proprio[sl], tpos[sl], tquat[sl]
                keep = None if keep is None else keep[sl]
            stats: Dict = {}
            pos, quat = forward(w, images, proprio, keep, m, stats, prec)
            if loss_rows is not None:
                sl = slice(*loss_rows)
                pos, quat, tpos, tquat = pos[sl], quat[sl], tpos[sl], \
                    tquat[sl]
            loss = pose_loss(pos, quat, tpos, tquat, t)
            grads = torch.autograd.grad(loss, [w[n] for n in names])
            losses.append(float(loss.detach()))
            lr = learning_rate(t, step)
            with torch.no_grad():
                for layer, (bmean, bvar) in stats.items():
                    for key, v in (("running_mean", bmean),
                                   ("running_var", bvar)):
                        r = w[f"{layer}.bn.{key}"]
                        r.copy_(BN_MOMENTUM * r + (1 - BN_MOMENTUM) * v)
                for n, g in zip(names, grads):
                    if flip:
                        g = -g
                    if step == 0:
                        first_grad[n] = float(torch.linalg.vector_norm(
                            g.double()))
                    p = w[n]
                    mom, vel = moments[n]
                    p.mul_(1.0 - lr * t["weight_decay"])
                    mom.mul_(b1).add_(g, alpha=1 - b1)
                    vel.mul_(b2).addcmul_(g, g, value=1 - b2)
                    bc1 = 1 - b1 ** (step + 1)
                    bc2 = 1 - b2 ** (step + 1)
                    denom = vel.sqrt() / math.sqrt(bc2) + ADAM_EPS
                    p.addcdiv_(mom, denom, value=-lr / bc1)
            del grads, images, batch, stats, pos, quat, loss
        change, change_t = {}, {}
        with torch.no_grad():
            for n, v in w.items():
                if n.endswith(("proprio_mean", "proprio_std")):
                    continue
                delta = v.detach() - start[n]
                change[n] = float(torch.linalg.vector_norm(delta.double()))
                change_t[n] = delta.cpu()
        return {"losses": losses, "first_grad": first_grad,
                "change": change, "change_t": change_t}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap between two per-leaf norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    med = float(np.median([ref[n] for n in leaves]))
    out = {}
    for n in leaves:
        den = max(ref[n], med)
        out[n] = abs(got[n] - ref[n]) / den if den > 0 else abs(got[n]
                                                                - ref[n])
    return out


def leaf_turns(got: Dict[str, Tensor], ref: Dict[str, Tensor],
               leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of direction between two tensors: one minus their
    cosine, 0 where they point alike, 2 where they point opposite. With
    the gap of norms it covers the difference of the two: it sees a
    change of direction or of sign, which a norm does not."""
    out = {}
    for n in leaves:
        a, b = got[n].double().flatten(), ref[n].double().flatten()
        den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
        if den > 0:
            out[n] = 1.0 - float(a @ b) / den
        else:   # a leaf that one side left unmoved has no direction
            out[n] = float(bool(a.any() or b.any()))
    return out


def compare(got: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """The numbers the comparison can hold, each with where it is worst:
    the worst step's relative loss gap; the worst and the median leaf's
    first-gradient gap; the worst and the median leaf's change gap, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (BatchNorm running statistics always count); and the
    worst and the median leaf's gap of direction of that change, over
    those of them that have a gradient."""
    rel = [abs(g - r) / abs(r) for g, r in zip(got["losses"], ref["losses"])]
    step = int(np.argmax(rel))
    grads = sorted(ref["first_grad"])
    med = float(np.median([ref["first_grad"][n] for n in grads]))
    moved = [n for n in sorted(ref["change"])
             if n not in ref["first_grad"]
             or ref["first_grad"][n] >= 1e-3 * med]
    out = {"loss_gap": (rel[step], f"step {step}")}
    for key, gaps in (
            ("grad", leaf_gaps(got["first_grad"], ref["first_grad"], grads)),
            ("change", leaf_gaps(got["change"], ref["change"], moved)),
            ("change_dir", leaf_turns(got["change_t"], ref["change_t"],
                                      [n for n in moved
                                       if n in ref["first_grad"]]))):
        worst = max(gaps, key=gaps.get)
        out[f"{key}_gap"] = (gaps[worst], worst)
        out[f"{key}_gap_median"] = (float(np.median(list(gaps.values()))),
                                    f"{len(gaps)} leaves")
    return out

"""On-device image augmentation in the train step (counterpart of the JAX
package's ``ops/image_augment_device.py``).

With ``data.augment_device`` the host only resizes to ``image_size +
2*crop_margin`` (deterministic, so the resize cache and the device cache
can hold final-size arrays); random crop, horizontal flip and colour
jitter run on the device, on the uint8 frames of the batch. The reference
computes all of it in XLA, not in a kernel of its own, so the port's
version is plain torch on the card.

Crop modes:
  * default: a fixed-size window at a random offset within the margin
    (pad-and-crop), by row and column gathers of the uint8 source;
  * ``crop_scale``/``crop_ratio`` set: a continuous RandomResizedCrop --
    the per-sample window (area ~ U(scale)*HW, log-uniform aspect,
    clamped to fit) is resampled bilinearly to the fixed output size.

The random draws are apart from the arithmetic: ``device_augment`` takes
them as tensors (``draw_device_aug`` makes them from a
``torch.Generator``), so the same draws give the reference's pixels.
torch cannot reproduce ``jax.random``'s bits; what it keeps is the
reference's distributions and its per-(sample, camera) structure.
Temporal stacks share one draw per (sample, camera): the same crop, flip
and jitter across the T frames. On a rank of a data-parallel group the
draws are those of the global batch, of which the rank keeps its rows,
so that the ranks together augment as one process does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.pose_math import (
    mirror_pose,
)

Draws = Dict[str, torch.Tensor]


def is_rrc(crop_scale: Sequence[float], crop_ratio: Sequence[float]) -> bool:
    """Whether the crop is the continuous RandomResizedCrop."""
    return (tuple(crop_scale) != (1.0, 1.0)
            or tuple(crop_ratio) != (1.0, 1.0))


def hue_rotate(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Hue rotation of float RGB in [0,1], (..., 3); ``shift``
    broadcastable (fraction of a full turn). The reference's arithmetic,
    in its order."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.amax(x, dim=-1)
    minc = torch.amin(x, dim=-1)
    eqc = maxc == minc
    cr = maxc - minc
    one = torch.ones_like(maxc)
    div = torch.where(eqc, one, cr)
    s = cr / torch.where(eqc, one, maxc)
    rc = (maxc - r) / div
    gc = (maxc - g) / div
    bc = (maxc - b) / div
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    h = torch.remainder(h + shift, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.to(torch.int32), 6).long()[..., None]
    p = maxc * (1.0 - s)
    q = maxc * (1.0 - s * f)
    t = maxc * (1.0 - s * (1.0 - f))

    def pick(*vals):
        # jnp.select over the masks i == 0..5: exactly one holds
        return torch.gather(torch.stack(vals, dim=-1), -1, i)[..., 0]

    rr = pick(maxc, q, p, p, t, maxc)
    gg = pick(t, maxc, maxc, q, p, p)
    bb = pick(p, p, t, maxc, maxc, q)
    return torch.stack([rr, gg, bb], dim=-1)


def _take(img: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-sample gather along ``dim`` (2 = rows, 3 = columns) of
    (B, T, H, W, C): ``idx`` (B, n) -> the dim becomes n."""
    b = img.shape[0]
    bi = torch.arange(b, device=img.device)[:, None]
    moved = img.movedim(dim, 1)                    # (B, dim, ...)
    return moved[bi, idx].movedim(1, dim)


def _bilinear_window(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                     ch: torch.Tensor, cw: torch.Tensor,
                     out_hw: int) -> torch.Tensor:
    """Resample each sample's float window [y0, y0+ch) x [x0, x0+cw) of
    (B, T, H, W, C) to (B, T, out_hw, out_hw, C) f32, bilinear with
    half-pixel centres. The corner gathers run on the source dtype (uint8
    in training) and cast to f32 at the lerp, as the reference does:
    every uint8 value is exact in f32, and the gathers move 4x fewer
    bytes."""
    _, _, h, w, _ = img.shape
    grid = torch.arange(out_hw, device=img.device, dtype=torch.float32) + 0.5
    fy = y0[:, None] + grid * (ch / out_hw)[:, None] - 0.5
    fx = x0[:, None] + grid * (cw / out_hw)[:, None] - 0.5
    iy = torch.floor(fy)
    ix = torch.floor(fx)
    wy = (fy - iy)[:, None, :, None, None]
    wx = (fx - ix)[:, None, None, :, None]
    y0i = torch.clamp(iy.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(ix.to(torch.int32), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    top = _take(img, y0i.long(), 2)                # (B, T, out, W, C)
    bot = _take(img, y1i.long(), 2)
    tl = _take(top, x0i.long(), 3).float()          # (B, T, out, out, C)
    tr = _take(top, x1i.long(), 3).float()
    bl = _take(bot, x0i.long(), 3).float()
    br = _take(bot, x1i.long(), 3).float()
    t_ = tl + (tr - tl) * wx
    b_ = bl + (br - bl) * wx
    return t_ + (b_ - t_) * wy


def _uniform(generator: torch.Generator, rows: int, first: int, b: int,
             device: torch.device, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    """U(lo, hi) of the global batch's ``rows`` samples, of which rows
    ``first`` to ``first + b`` are kept (all of them off a group)."""
    u = torch.rand(rows, generator=generator, device=device)
    u = u[first:first + b]
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def draw_device_aug(generator: torch.Generator, b: int, h: int, w: int,
                    out_hw: int, *, hflip_prob: float = 0.0,
                    jitter_brightness: float = 0.2,
                    jitter_contrast: float = 0.2,
                    jitter_saturation: float = 0.2,
                    jitter_hue: float = 0.0, jitter_prob: float = 0.8,
                    crop_scale: Tuple[float, float] = (1.0, 1.0),
                    crop_ratio: Tuple[float, float] = (1.0, 1.0),
                    flip_shared: bool = False, first: int = 0,
                    rows: Optional[int] = None,
                    device: Optional[torch.device] = None) -> Draws:
    """One camera's draws for ``device_augment`` of a batch of ``b``
    (H, W) frames, from ``generator`` (on ``device``), with the
    reference's distributions: crop offsets ``oy``/``ox`` (int64 for
    pad-and-crop; f32 with the window sizes ``ch``/``cw`` for
    RandomResizedCrop), ``flip`` (bool; not drawn when ``flip_shared``:
    the batch's shared pose-mirror flip replaces it), the jitter on-mask
    ``on`` (f32 0/1), the raw factors ``brightness``/``contrast``/
    ``saturation`` and the raw hue ``shift`` (``device_augment`` applies
    them where ``on`` is 1). On a rank of a group the draws are the
    global batch's ``rows`` of which rows ``first`` to ``first + b`` are
    kept."""
    rows = rows or b
    dev = device if device is not None else generator.device

    def uni(lo=0.0, hi=1.0):
        return _uniform(generator, rows, first, b, dev, lo, hi)

    out: Draws = {}
    if is_rrc(crop_scale, crop_ratio):
        area = uni(crop_scale[0], crop_scale[1]) * (h * w)
        log_r = uni(math.log(crop_ratio[0]), math.log(crop_ratio[1]))
        ar = torch.exp(log_r)
        cw = torch.clamp(torch.sqrt(area * ar), 1.0, float(w))
        ch = torch.clamp(torch.sqrt(area / ar), 1.0, float(h))
        out.update(ch=ch, cw=cw, oy=uni() * (h - ch), ox=uni() * (w - cw))
    else:
        out["oy"] = torch.randint(0, h - out_hw + 1, (rows,),
                                  generator=generator,
                                  device=dev)[first:first + b]
        out["ox"] = torch.randint(0, w - out_hw + 1, (rows,),
                                  generator=generator,
                                  device=dev)[first:first + b]
    if hflip_prob > 0 and not flip_shared:
        out["flip"] = uni() < hflip_prob
    if jitter_prob > 0:
        out["on"] = (uni() < jitter_prob).float()
        for name, amount in (("brightness", jitter_brightness),
                             ("contrast", jitter_contrast),
                             ("saturation", jitter_saturation)):
            if amount > 0:
                out[name] = uni(max(0.0, 1.0 - amount), 1.0 + amount)
        if jitter_hue > 0:
            amp = min(jitter_hue, 0.5)
            out["hue"] = uni(-amp, amp)
    return out


def device_augment(images: torch.Tensor, draws: Draws, out_hw: int,
                   hflip_prob: float = 0.0,
                   jitter_brightness: float = 0.2,
                   jitter_contrast: float = 0.2,
                   jitter_saturation: float = 0.2,
                   jitter_hue: float = 0.0, jitter_prob: float = 0.8,
                   crop_scale: Tuple[float, float] = (1.0, 1.0),
                   crop_ratio: Tuple[float, float] = (1.0, 1.0),
                   flip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, [T,] H, W, C) uint8 -> (B, [T,] out_hw, out_hw, C) f32 in [0, 1]
    with ``draws`` (``draw_device_aug``'s keys), the reference's
    ``device_augment`` given the same draws. ``flip_mask`` (B,) bool, if
    given, replaces the per-camera flip: pose-mirror mode shares one flip
    per sample across cameras so that the mirrored label stays
    consistent."""
    temporal = images.dim() == 5
    if not temporal:
        images = images[:, None]
    b, t, h, w, c = images.shape
    if h < out_hw or w < out_hw:
        raise ValueError(f"source {h}x{w} smaller than crop {out_hw}")

    def per_sample(v: torch.Tensor) -> torch.Tensor:
        return v.reshape(b, 1, 1, 1, 1)

    if is_rrc(crop_scale, crop_ratio):
        x = _bilinear_window(images, draws["oy"], draws["ox"], draws["ch"],
                             draws["cw"], out_hw) * (1.0 / 255.0)
    else:
        grid = torch.arange(out_hw, device=images.device)
        rows = draws["oy"].long()[:, None] + grid
        cols = draws["ox"].long()[:, None] + grid
        x = _take(_take(images, rows, 2), cols, 3).float() * (1.0 / 255.0)

    flip = flip_mask if flip_mask is not None else (
        draws["flip"] if hflip_prob > 0 else None)
    if flip is not None:
        x = torch.where(per_sample(flip), x.flip(3), x)

    if jitter_prob > 0:
        on = per_sample(draws["on"])

        def factor(name: str) -> torch.Tensor:
            return 1.0 + on * (per_sample(draws[name]) - 1.0)  # off -> 1.0

        if jitter_brightness > 0:
            x = x * factor("brightness")
        if jitter_contrast > 0:
            # per-frame grayscale mean anchor (torchvision adjust_contrast),
            # one factor per sample; non-RGB falls back to the channel mean
            if c == 3:
                gray_m = (x[..., 0] * 0.299 + x[..., 1] * 0.587
                          + x[..., 2] * 0.114)
                m = torch.mean(gray_m, dim=(2, 3), keepdim=True)[..., None]
            else:
                m = torch.mean(x, dim=(2, 3, 4), keepdim=True)
            x = m + (x - m) * factor("contrast")
        if jitter_saturation > 0 and c == 3:
            gray = (x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587
                    + x[..., 2:3] * 0.114)
            x = gray + (x - gray) * factor("saturation")
        if jitter_hue > 0 and c == 3:
            shift = draws["hue"].reshape(b, 1, 1, 1) * on[..., 0]
            # on the clipped intermediate (valid RGB cube), the host
            # backends' brightness -> contrast -> saturation -> hue order
            x = hue_rotate(torch.clamp(x, 0.0, 1.0), shift)
        x = torch.clamp(x, 0.0, 1.0)

    if not temporal:
        x = x[:, 0]
    return x


def draw_batch_aug(generator: torch.Generator, batch: Dict,
                   cameras: Sequence[str], out_hw: int,
                   hflip_prob: float = 0.0, hflip_pose_mirror: bool = False,
                   first: int = 0, rows: Optional[int] = None,
                   **kwargs) -> Dict[str, Draws]:
    """The draws of ``augment_batch_images`` for ``batch``: each camera's
    (``draw_device_aug``, in camera order), then, with
    ``hflip_pose_mirror``, the shared flip under "flip_mask"."""
    kwargs = {k: v for k, v in kwargs.items()
              if not k.startswith("hflip_mirror")}
    shared = hflip_pose_mirror and hflip_prob > 0
    out: Dict[str, Draws] = {}
    for cam in cameras:
        img = batch["images"][cam]
        b, h, w = img.shape[0], img.shape[-3], img.shape[-2]
        out[cam] = draw_device_aug(generator, b, h, w, out_hw,
                                   hflip_prob=hflip_prob, flip_shared=shared,
                                   first=first, rows=rows,
                                   device=img.device, **kwargs)
    if shared:
        img = batch["images"][cameras[0]]
        b = img.shape[0]
        out["flip_mask"] = {"flip": _uniform(generator, rows or b, first, b,
                                             img.device) < hflip_prob}
    return out


def augment_batch_images(batch: Dict, draws: Dict[str, Draws],
                         cameras: Sequence[str], out_hw: int,
                         hflip_prob: float = 0.0,
                         hflip_pose_mirror: bool = False,
                         hflip_mirror_axis: int = 0,
                         hflip_mirror_center: float = 0.0,
                         **kwargs) -> Dict:
    """``device_augment`` on every camera with its own draws (independent
    per camera, as the host backends draw them); returns a new batch.
    With ``hflip_pose_mirror`` one flip per sample (``draws
    ["flip_mask"]``) is shared by all cameras and the target pose is
    mirrored with the image (ops/pose_math.mirror_pose)."""
    out = dict(batch)
    flip_mask = None
    if hflip_pose_mirror and hflip_prob > 0:
        flip_mask = draws["flip_mask"]["flip"]
        mpos, mquat = mirror_pose(batch["target_pos"], batch["target_quat"],
                                  axis=hflip_mirror_axis,
                                  center=hflip_mirror_center)
        out["target_pos"] = torch.where(flip_mask[:, None], mpos,
                                        batch["target_pos"])
        out["target_quat"] = torch.where(flip_mask[:, None], mquat,
                                         batch["target_quat"])
    images = dict(batch["images"])
    for cam in cameras:
        images[cam] = device_augment(images[cam], draws[cam], out_hw,
                                     hflip_prob=hflip_prob,
                                     flip_mask=flip_mask, **kwargs)
    out["images"] = images
    return out

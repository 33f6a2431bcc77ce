"""Host-side uint8 image augmentations (C2, BASELINE.json:5,10).

decode -> resize -> random-resized-crop -> hflip -> color-jitter, all in
uint8/float32 ON HOST; per-channel normalization is deferred to the device
where it fuses into the first conv (SURVEY.md section 4.4 "normalize
deferred to device"). Eval path is deterministic: center crop + resize
(SURVEY.md section 4.2).

Two pixel backends share ONE parameter sampler (`sample_aug_params`, numpy
RNG), so augmentation *randomness* is backend-independent:

  * numpy/opencv (this file) -- reference implementation and fallback;
  * the native C++ engine (runtime/csrc/augment.cc via ctypes) -- the
    throughput path for the 160k images/sec host budget (SURVEY.md
    section 8 hard-part 1).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

try:
    import cv2

    cv2.setNumThreads(0)  # threading is managed by the pipeline workers
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


class AugParams(NamedTuple):
    """Resolved per-sample augmentation: rectangular crop window + flip +
    jitter factors (<= 0 disables brightness/contrast/saturation; hue is a
    shift in [-0.5, 0.5], 0.0 = identity/skip)."""

    y0: int
    x0: int
    ch: int                        # crop window height
    cw: int                        # crop window width
    flip: bool
    brightness: float
    contrast: float
    saturation: float
    hue: float = 0.0


def _rrc_window(h: int, w: int, scale: Tuple[float, float],
                ratio: Tuple[float, float], u: np.ndarray):
    """torchvision RandomResizedCrop.get_params: 10 attempts of
    (area ~ U(scale)*HW, log-uniform aspect), else the clamped center-crop
    fallback. `u` supplies 2 uniforms per attempt (shape (10, 2))."""
    area = h * w
    log_r = (np.log(ratio[0]), np.log(ratio[1]))
    for a in range(10):
        target = area * (scale[0] + u[a, 0] * (scale[1] - scale[0]))
        ar = np.exp(log_r[0] + u[a, 1] * (log_r[1] - log_r[0]))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            return ch, cw, False
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        ch, cw = h, w
    return ch, cw, True            # centered fallback


def sample_aug_params(
    h: int,
    w: int,
    rng: np.random.RandomState,
    crop_scale: Tuple[float, float] = (0.8, 1.0),
    crop_ratio: Tuple[float, float] = (1.0, 1.0),
    hflip_prob: float = 0.5,
    jitter_brightness: float = 0.2,
    jitter_contrast: float = 0.2,
    jitter_saturation: float = 0.2,
    jitter_hue: float = 0.0,
    jitter_prob: float = 0.8,
) -> AugParams:
    """Draw augmentation parameters (the ONLY source of randomness).

    Crop windows follow torchvision RandomResizedCrop (area from
    `crop_scale`, log-uniform aspect from `crop_ratio`; VERDICT r1
    missing-6); `crop_ratio=(1,1)` gives square windows."""
    u = rng.uniform(size=(10, 2))
    ch, cw, centered = _rrc_window(h, w, crop_scale, crop_ratio, u)
    if centered:
        y0, x0 = (h - ch) // 2, (w - cw) // 2
    else:
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
    flip = hflip_prob > 0 and rng.uniform() < hflip_prob
    fb = fc = fs = fh = 0.0
    if jitter_prob > 0 and rng.uniform() < jitter_prob:
        if jitter_brightness > 0:
            fb = rng.uniform(max(0.0, 1 - jitter_brightness),
                             1 + jitter_brightness)
        if jitter_contrast > 0:
            fc = rng.uniform(max(0.0, 1 - jitter_contrast),
                             1 + jitter_contrast)
        if jitter_saturation > 0:
            fs = rng.uniform(max(0.0, 1 - jitter_saturation),
                             1 + jitter_saturation)
        if jitter_hue > 0:
            fh = rng.uniform(-min(jitter_hue, 0.5), min(jitter_hue, 0.5))
    return AugParams(y0, x0, ch, cw, flip, fb, fc, fs, fh)


# ---------------------------------------------------------------------------
# numpy/opencv pixel backend
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Vectorized counter-based parameter sampling (VERDICT r1 weak-4): one
# numpy pass draws every sample's augmentation parameters -- no per-sample
# RandomState construction in the pipeline workers' GIL hot path.
# ---------------------------------------------------------------------------


def _splitmix64(z: np.ndarray) -> np.ndarray:
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hashed_uniforms(seeds: np.ndarray, k: int) -> np.ndarray:
    """(n, k) uniforms in [0, 1): counter-based splitmix64 hash of
    (seed, column). Deterministic in the seed values alone -- independent
    of worker count, call order, and batch composition."""
    s = np.asarray(seeds, dtype=np.uint64)
    ctr = (s[:, None] * np.uint64(0x100000001B3)
           + np.arange(k, dtype=np.uint64)[None, :])
    z = _splitmix64(ctr)
    return (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def sample_aug_params_batch(
    hs: np.ndarray,
    ws: np.ndarray,
    seeds: np.ndarray,
    crop_scale: Tuple[float, float] = (1.0, 1.0),
    crop_ratio: Tuple[float, float] = (1.0, 1.0),
    hflip_prob: float = 0.0,
    jitter_brightness: float = 0.2,
    jitter_contrast: float = 0.2,
    jitter_saturation: float = 0.2,
    jitter_hue: float = 0.0,
    jitter_prob: float = 0.8,
):
    """Vectorized batch equivalent of `sample_aug_params`: same parameter
    distributions (torchvision RandomResizedCrop 10-attempt window, color
    jitter factors), drawn from the counter-based stream (the per-sample
    RandomState stream of `sample_aug_params` remains for the single-image
    API). Returns a dict of arrays:
    {y0, x0, ch, cw (int32), flip (bool), brightness, contrast, saturation,
    hue (float32; <=0 disables b/c/s, hue 0.0 = identity)}."""
    hs = np.asarray(hs, dtype=np.int64)
    ws = np.asarray(ws, dtype=np.int64)
    n = len(seeds)
    u = hashed_uniforms(seeds, 28)  # 10 attempts x 2 + offsets(2) + 6

    # --- torchvision RandomResizedCrop, vectorized over 10 attempts ---
    area = (hs * ws).astype(np.float64)
    s_lo, s_hi = crop_scale
    r_lo, r_hi = crop_ratio
    ua = u[:, 0:20:2]              # (n, 10) area draws
    ur = u[:, 1:20:2]              # (n, 10) aspect draws
    target = area[:, None] * (s_lo + ua * (s_hi - s_lo))
    ar = np.exp(np.log(r_lo) + ur * (np.log(r_hi) - np.log(r_lo)))
    cw_t = np.round(np.sqrt(target * ar)).astype(np.int64)
    ch_t = np.round(np.sqrt(target / ar)).astype(np.int64)
    ok = ((cw_t > 0) & (cw_t <= ws[:, None])
          & (ch_t > 0) & (ch_t <= hs[:, None]))
    first = np.argmax(ok, axis=1)              # first valid attempt
    any_ok = ok[np.arange(n), first]
    ch = ch_t[np.arange(n), first]
    cw = cw_t[np.arange(n), first]
    # fallback: clamp the full image to the ratio bounds, centered
    in_ratio = ws / np.maximum(hs, 1)
    fb_w = np.where(in_ratio < r_lo, ws, np.where(
        in_ratio > r_hi, np.round(hs * r_hi).astype(np.int64), ws))
    fb_h = np.where(in_ratio < r_lo, np.round(ws / r_lo).astype(np.int64),
                    np.where(in_ratio > r_hi, hs, hs))
    ch = np.where(any_ok, ch, fb_h)
    cw = np.where(any_ok, cw, fb_w)
    ch = np.clip(ch, 1, hs)
    cw = np.clip(cw, 1, ws)
    # uniform integer offset in [0, h-ch]; centered for the fallback
    y0 = (u[:, 20] * (hs - ch + 1)).astype(np.int64)
    x0 = (u[:, 21] * (ws - cw + 1)).astype(np.int64)
    y0 = np.where(any_ok, y0, (hs - ch) // 2)
    x0 = np.where(any_ok, x0, (ws - cw) // 2)

    flip = (u[:, 22] < hflip_prob) if hflip_prob > 0 else np.zeros(n, bool)
    on = (u[:, 23] < jitter_prob) if jitter_prob > 0 else np.zeros(n, bool)

    def factor(col: np.ndarray, amount: float) -> np.ndarray:
        if amount <= 0:
            return np.zeros(n, np.float32)
        f_lo = max(0.0, 1.0 - amount)
        f = f_lo + col * (1.0 + amount - f_lo)
        return np.where(on, f, 0.0).astype(np.float32)

    if jitter_hue > 0:
        amp = min(jitter_hue, 0.5)
        hue = np.where(on, (u[:, 27] * 2.0 - 1.0) * amp, 0.0)
        hue = hue.astype(np.float32)
    else:
        hue = np.zeros(n, np.float32)

    return {
        "y0": y0.astype(np.int32),
        "x0": x0.astype(np.int32),
        "ch": ch.astype(np.int32),
        "cw": cw.astype(np.int32),
        "flip": flip,
        "brightness": factor(u[:, 24], jitter_brightness),
        "contrast": factor(u[:, 25], jitter_contrast),
        "saturation": factor(u[:, 26], jitter_saturation),
        "hue": hue,
    }


def params_row(pb: dict, i: int) -> AugParams:
    """AugParams view of row i of a `sample_aug_params_batch` result (for
    the per-image numpy pixel backend)."""
    return AugParams(int(pb["y0"][i]), int(pb["x0"][i]), int(pb["ch"][i]),
                     int(pb["cw"][i]),
                     bool(pb["flip"][i]), float(pb["brightness"][i]),
                     float(pb["contrast"][i]), float(pb["saturation"][i]),
                     float(pb["hue"][i]))


def decode_image(buf: np.ndarray) -> np.ndarray:
    """JPEG/PNG bytes (1-D uint8) -> RGB uint8 HWC (C2 "decode",
    BASELINE.json:5; VERDICT r1 missing-3). Bytes are produced/consumed in
    standard channel order (files are viewable by any image tool)."""
    if not _HAS_CV2:
        raise RuntimeError(
            "opencv is required to decode encoded image observations")
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cv2.imdecode failed: not a decodable image")
    return np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB


def encode_image(img: np.ndarray, ext: str = ".jpg",
                 quality: int = 95) -> np.ndarray:
    """RGB uint8 HWC -> encoded bytes (1-D uint8). Inverse of decode_image
    (lossy for JPEG)."""
    if not _HAS_CV2:
        raise RuntimeError("opencv is required to encode images")
    params = ([int(cv2.IMWRITE_JPEG_QUALITY), quality]
              if ext in (".jpg", ".jpeg") else [])
    ok, buf = cv2.imencode(ext, img[..., ::-1], params)
    if not ok:
        raise ValueError(f"cv2.imencode({ext!r}) failed")
    return buf.reshape(-1)


def resize(img: np.ndarray, out_hw: int) -> np.ndarray:
    """uint8 HWC resize (bilinear)."""
    if img.shape[0] == out_hw and img.shape[1] == out_hw:
        return img
    if _HAS_CV2:
        return cv2.resize(img, (out_hw, out_hw), interpolation=cv2.INTER_LINEAR)
    # numpy nearest fallback
    ys = (np.arange(out_hw) * img.shape[0] / out_hw).astype(np.int64)
    xs = (np.arange(out_hw) * img.shape[1] / out_hw).astype(np.int64)
    return img[ys][:, xs]


def center_crop_resize(img: np.ndarray, out_hw: int) -> np.ndarray:
    """Deterministic eval transform: center square crop + resize."""
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return resize(img[y0:y0 + s, x0:x0 + s], out_hw)


def hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def adjust_hue(x: np.ndarray, shift: float) -> np.ndarray:
    """Hue rotation of float32 RGB (0-255 scale) by `shift` in [-0.5, 0.5]
    full turns -- the same RGB<->HSV math as torchvision's tensor
    `adjust_hue` (asserted in tests/parity/test_aug_parity.py)."""
    v = x * (1.0 / 255.0)
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc = np.max(v, axis=-1)
    minc = np.min(v, axis=-1)
    eqc = maxc == minc
    cr = maxc - minc
    div = np.where(eqc, 1.0, cr)
    s = cr / np.where(eqc, 1.0, maxc)
    rc = (maxc - r) / div
    gc = (maxc - g) / div
    bc = (maxc - b) / div
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0 + 1.0) % 1.0
    h = (h + shift) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p_ = maxc * (1.0 - s)
    q_ = maxc * (1.0 - s * f)
    t_ = maxc * (1.0 - s * (1.0 - f))
    out = np.empty_like(v)
    for k, (rr, gg, bb) in enumerate([(maxc, t_, p_), (q_, maxc, p_),
                                      (p_, maxc, t_), (p_, q_, maxc),
                                      (t_, p_, maxc), (maxc, p_, q_)]):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out * 255.0


def jitter_with_factors(img: np.ndarray, fb: float, fc: float,
                        fs: float, fh: float = 0.0) -> np.ndarray:
    """Apply brightness/contrast/saturation/hue with explicit factors
    (<= 0 skips b/c/s; hue 0.0 = identity), in fixed b->c->s->h order
    (torchvision samples a random order; the fixed order is this
    framework's documented convention). Contrast anchors on the mean of
    the GRAYSCALE image like torchvision's adjust_contrast (ADVICE r1);
    non-RGB channel counts fall back to the channel mean."""
    x = img.astype(np.float32)
    if fb > 0:
        x *= fb
    if fc > 0:
        if x.shape[-1] == 3:
            m = (x @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
                 ).mean(dtype=np.float32)
        else:
            m = x.mean(dtype=np.float32)
        x = m + (x - m) * fc
    if fs > 0:
        gray = x @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
        x = gray[..., None] + (x - gray[..., None]) * fs
    if fh != 0.0 and x.shape[-1] == 3:
        # hue operates on the clipped intermediate (valid RGB cube)
        x = adjust_hue(np.clip(x, 0, 255), fh)
    return np.clip(x, 0, 255).astype(np.uint8)


def apply_aug_params(img: np.ndarray, p: AugParams,
                     out_hw: int) -> np.ndarray:
    """Apply resolved params to one uint8 HWC image (numpy backend)."""
    img = resize(img[p.y0:p.y0 + p.ch, p.x0:p.x0 + p.cw], out_hw)
    if p.flip:
        img = hflip(img)
    if p.brightness > 0 or p.contrast > 0 or p.saturation > 0 or p.hue != 0:
        img = jitter_with_factors(img, p.brightness, p.contrast,
                                  p.saturation, p.hue)
    return np.ascontiguousarray(img)


def augment_image(img: np.ndarray, out_hw: int,
                  rng: np.random.RandomState, **kwargs) -> np.ndarray:
    """Sample + apply in one call (convenience / tests)."""
    p = sample_aug_params(img.shape[0], img.shape[1], rng, **kwargs)
    return apply_aug_params(img, p, out_hw)

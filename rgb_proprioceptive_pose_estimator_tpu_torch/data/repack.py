"""A copy of the JAX package's ``data/repack.py`` (jax-free), for the
port's ``cli repack``; h5py and OpenCV are imported only where a file
is opened.

Offline dataset repack (`cli repack`): resize and/or re-encode the
image observations of a robomimic-layout demo file once, instead of at
every run startup.

Why this exists (TPU workflow, not a reference feature): the
device-resident dataset (`data.device_cache`) builds its HBM cache by
decoding + deterministically resizing EVERY frame at startup — on raw
480/240px captures that is minutes of one-core host work per run, paid
again by every run, sweep member, and resumed preemption. Repacking to
the training resolution makes the runtime resize a no-op: the cache
build degrades to a read, and with `--encode jpeg` the file also shrinks
~10× on disk. The transform applied is byte-identical to the runtime
one (`augment.center_crop_resize`, the eval/device-cache path), so a
file repacked at `model.image_size` trains and evaluates EXACTLY like
the original through the device-cache and eval pipelines (test-pinned);
the only train-path difference is host-side random-crop augmentation,
which then sees the resized frame as its source (same as it would at
runtime after the deterministic resize — pass a LARGER --size to keep
crop headroom, e.g. image_size + 2*crop_margin for the device-aug path).

Everything that is not a configured camera's image stream — proprio,
targets, extra obs keys, unconfigured cameras, `mask/` filter keys,
group/file attributes — copies through verbatim, so the repacked file
remains a complete robomimic dataset, not a training-only artifact.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np



def _resize_frames(frames: np.ndarray, size: int, use_native: bool
                   ) -> np.ndarray:
    """Deterministic center-crop-resize, the same code path the runtime
    uses (hdf5_store._resized_gather) so repack-then-train is pixel-exact
    vs resize-at-runtime."""
    # (augment imports OpenCV where it is installed: only when pixels move)
    from rgb_proprioceptive_pose_estimator_tpu_torch.data import augment as aug

    if frames.shape[1] == frames.shape[2] == size:
        return frames
    if use_native:
        from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import (
            native as native_mod,
        )

        if native_mod.available():
            return native_mod.center_crop_resize_batch(frames, size)
    return np.stack([aug.center_crop_resize(fr, size) for fr in frames])


def repack_file(
    src_path: str,
    out_path: str,
    cameras: Sequence[str],
    size: int,
    encode: str = "raw",
    max_demos: int = 0,
    image_key_format: str = "obs/{camera}_image",
    jpeg_quality: int = 95,
    use_native: bool = True,
) -> Dict[str, int]:
    """Repack one file; returns {"demos", "frames", "bytes_in", "bytes_out"}.

    The output is written to a temp name and moved into place atomically
    (same contract as data/playback.py: a truncated file must never look
    like a finished dataset)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        _h5py,
        _natural_key,
    )

    if encode not in ("raw", "jpeg", "png"):
        raise ValueError(f"encode must be raw|jpeg|png, got {encode!r}")
    if size <= 0:
        raise ValueError(f"--size must be positive, got {size}")
    image_keys = {image_key_format.format(camera=c) for c in cameras}
    tmp_path = out_path + ".tmp"
    n_demos = n_frames = 0
    try:
        h5py = _h5py()
        with h5py.File(src_path, "r") as src, \
                h5py.File(tmp_path, "w") as out:
            if "data" not in src:
                raise KeyError(f"{src_path}: no 'data' group (not a "
                               "robomimic-layout demo file)")
            odata = out.create_group("data")
            for k, v in src["data"].attrs.items():
                odata.attrs[k] = v
            for k, v in src.attrs.items():
                out.attrs[k] = v
            keys = sorted(src["data"].keys(), key=_natural_key)
            if max_demos > 0:
                keys = keys[:max_demos]
            for dk in keys:
                g = src["data"][dk]
                og = odata.create_group(dk)
                for k, v in g.attrs.items():
                    og.attrs[k] = v
                _copy_group(g, og, "", image_keys, size, encode,
                            jpeg_quality, use_native)
                # frame count from the first configured camera present
                for ik in image_keys:
                    if ik in g:
                        n_frames += len(g[ik])
                        break
                n_demos += 1
            # every other top-level member (mask/ filter keys, env
            # metadata, user groups) copies verbatim -- the output is a
            # complete dataset, not a training-only artifact
            for name in src.keys():
                if name != "data":
                    src.copy(name, out)
        os.replace(tmp_path, out_path)
    except BaseException:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise
    return {"demos": n_demos, "frames": n_frames,
            "bytes_in": os.path.getsize(src_path),
            "bytes_out": os.path.getsize(out_path)}


def _copy_group(g_src: "h5py.Group", g_dst: "h5py.Group", prefix: str,
                image_keys: set, size: int, encode: str,
                jpeg_quality: int, use_native: bool) -> None:
    from rgb_proprioceptive_pose_estimator_tpu_torch.data import augment as aug
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        _h5py,
    )

    h5py = _h5py()
    for name, item in g_src.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(item, h5py.Group):
            sub = g_dst.create_group(name)
            for k, v in item.attrs.items():
                sub.attrs[k] = v
            _copy_group(item, sub, path, image_keys, size, encode,
                        jpeg_quality, use_native)
        elif path in image_keys:
            frames = item[...]
            if h5py.check_vlen_dtype(item.dtype) is not None:
                frames = np.stack([aug.decode_image(b) for b in frames])
            if frames.ndim != 4 or frames.shape[-1] != 3:
                raise ValueError(
                    f"{path}: expected (T,H,W,3) uint8 frames, got shape "
                    f"{frames.shape}")
            res = _resize_frames(frames.astype(np.uint8, copy=False),
                                 size, use_native)
            if encode == "raw":
                ds = g_dst.create_dataset(name, data=res,
                                          compression="gzip",
                                          compression_opts=1)
            else:
                ext = ".jpg" if encode == "jpeg" else ".png"
                ds = g_dst.create_dataset(
                    name, (len(res),), dtype=h5py.vlen_dtype(np.uint8))
                ds[...] = [aug.encode_image(fr, ext, quality=jpeg_quality)
                           for fr in res]
            for k, v in item.attrs.items():   # dataset-level attrs survive
                ds.attrs[k] = v
        else:
            # verbatim copy (data + attrs + dtype; h5py handles cross-file)
            g_src.copy(name, g_dst)

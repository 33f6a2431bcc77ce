"""Robosuite/robomimic-style HDF5 demo-trajectory store (C1,
BASELINE.json:5,9).

Layout read (SURVEY.md section 4.4, robomimic convention):

    data/
      demo_0/
        obs/<camera>_image          (T, H, W, 3) uint8
        obs/robot0_proprio-state    (T, D) float
        obs/object                  (T, >=7) float; [:3]=pos, [3:7]=quat
      demo_1/ ...

Indexing is flat over (demo, t) pairs. Temporal stacking (C11) gathers the
T most recent frames with clamp-at-episode-start padding. h5py handles are
per-(thread, file) (h5py is not safe across threads on a shared handle --
SURVEY.md section 4.4); small tensors (proprio, targets) are cached in RAM
at init, images optionally (`cache_images`).

`path` may name several demo files (comma list and/or glob patterns, see
expand_paths); their demos concatenate into one dataset, split at demo
granularity across the whole collection.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
import threading
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from rgb_proprioceptive_pose_estimator_tpu_torch.data import augment as aug


def _h5py():
    """h5py, imported where a file is opened or written: the module
    imports without it, so a host without h5py can train from memory."""
    import h5py

    return h5py


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def expand_paths(spec) -> List[str]:
    """data.path may name several demo files: a comma-separated list and/or
    glob patterns ("/data/lift*.hdf5,/data/can.hdf5"), or a sequence of
    such strings. Each glob expands sorted (natural order); a token that
    matches nothing is an error (a silent empty dataset is worse)."""
    tokens: List[str] = []
    for part in ([spec] if isinstance(spec, (str, os.PathLike)) else spec):
        tokens.extend(t.strip() for t in str(part).split(",") if t.strip())
    out: List[str] = []
    for tok in tokens:
        if _glob.has_magic(tok):
            hits = sorted(_glob.glob(tok), key=_natural_key)
            if not hits:
                raise FileNotFoundError(
                    f"data.path pattern {tok!r} matches no files")
            out.extend(hits)
        else:
            out.append(tok)
    if not out:
        raise ValueError(f"data.path {spec!r} names no files")
    # duplicates (e.g. a file named both explicitly and via a glob, or
    # the same file via a relative path / symlink) would silently double
    # its demos in the dataset -- compare resolved paths, keep the
    # spellings as listed
    seen = set()
    dup = []
    for p in out:
        rp = os.path.realpath(p)
        if rp in seen:
            dup.append(p)
        seen.add(rp)
    if dup:
        raise ValueError(f"data.path lists files more than once: {dup}")
    return out


class HDF5DemoStore:
    def __init__(
        self,
        path: str,
        cameras: Sequence[str] = ("agentview",),
        image_size: int = 128,
        temporal_frames: int = 1,
        image_key_format: str = "obs/{camera}_image",
        proprio_key: str = "obs/robot0_proprio-state",
        target_key: str = "obs/object",
        # predictive targets: label[t] = target pose at t + K within the
        # same demo; the last K steps of every demo are excluded from the
        # sample index so every label exists (data.target_lookahead)
        target_lookahead: int = 0,
        use_proprio: bool = True,
        use_native: bool = True,               # C++ augment engine if built
        cache_images: Optional[bool] = None,   # None = auto (< 4 GiB)
        split: str = "all",                    # "all" | "train" | "val"
        val_fraction: float = 0.0,             # held-out fraction, by demo
        split_seed: int = 0,
        # cap the dataset at the first N demos of the concatenated list
        # (natural order, BEFORE the split -- robomimic-style n_demos
        # data-efficiency studies). 0 = all.
        max_demos: int = 0,
        # robomimic filter key: restrict each file to the demos named in
        # its mask/<filter_key> dataset (applied before max_demos and the
        # train/val split). "" = all demos.
        filter_key: str = "",
        # device-side augmentation (data.augment_device): train batches are
        # deterministically resized to this size (image_size + 2*margin);
        # the random crop/flip/jitter happens inside the jitted train step
        device_aug_hw: Optional[int] = None,
        crop_scale: Tuple[float, float] = (1.0, 1.0),
        crop_ratio: Tuple[float, float] = (1.0, 1.0),
        hflip_prob: float = 0.0,
        # hflip label consistency (VERDICT r1 missing-2): mirror the target
        # pose with the flip; one flip draw per sample shared by all cameras
        hflip_pose_mirror: bool = False,
        hflip_mirror_axis: int = 0,
        hflip_mirror_center: float = 0.0,
        jitter_brightness: float = 0.2,
        jitter_contrast: float = 0.2,
        jitter_saturation: float = 0.2,
        jitter_hue: float = 0.0,
        jitter_prob: float = 0.8,
    ):
        self.path = path                  # the spec as configured
        self.paths = expand_paths(path)   # resolved file list
        self.cameras = tuple(cameras)
        self.image_size = image_size
        self.temporal_frames = temporal_frames
        self.image_key_format = image_key_format
        self.proprio_key = proprio_key
        # robomimic idiom: several low-dim obs keys ("obs/robot0_eef_pos,
        # obs/robot0_eef_quat,obs/robot0_gripper_qpos") concatenate along
        # the feature dim, in the configured order
        self.proprio_keys = tuple(
            k.strip() for k in proprio_key.split(",") if k.strip())
        self.target_key = target_key
        # like proprio_key, the target may span several obs keys
        # ("obs/cube_pos,obs/cube_quat" -- robomimic often stores pos and
        # quat separately); features concatenate in the configured order
        # and the [:3]=pos / [3:7]=quat convention applies to the result
        self.target_keys = tuple(
            k.strip() for k in target_key.split(",") if k.strip())
        if target_lookahead < 0:
            raise ValueError(
                f"target_lookahead must be >= 0, got {target_lookahead}")
        self.target_lookahead = int(target_lookahead)
        self.use_proprio = use_proprio
        self.use_native = use_native
        self.device_aug_hw = device_aug_hw
        # data.device_cache: get_batch emits int32 frame indices instead of
        # pixel arrays (set by data/pipeline.build_dataset)
        self.emit_image_indices = False
        # data.cache_layout="sharded": a CacheShardPlan remapping emitted
        # indices to shard-local cache rows (set by engine/loop.fit /
        # api.evaluate when the HBM cache is sharded across the mesh)
        self.cache_plan = None
        self._aug_kwargs = dict(
            crop_scale=crop_scale, crop_ratio=crop_ratio,
            hflip_prob=hflip_prob,
            jitter_brightness=jitter_brightness,
            jitter_contrast=jitter_contrast,
            jitter_saturation=jitter_saturation, jitter_hue=jitter_hue,
            jitter_prob=jitter_prob,
        )
        self.hflip_prob = hflip_prob
        self.hflip_pose_mirror = hflip_pose_mirror
        self.hflip_mirror_axis = hflip_mirror_axis
        self.hflip_mirror_center = hflip_mirror_center
        self._local = threading.local()
        # memoized deterministic resizes as ONE flat (N, hw, hw, 3) array
        # per (cam, hw) with a per-demo done bitmap -- serves the eval
        # transform and the device-aug train path (both deterministic) via
        # a single vectorized gather; each frame is resized once per size
        self._resized_flat: Dict[Tuple[str, int], np.ndarray] = {}
        self._resized_done: Dict[Tuple[str, int], np.ndarray] = {}
        self._resized_lock = threading.Lock()

        # per-camera encoding flag: raw (T,H,W,3) uint8 arrays vs encoded
        # JPEG/PNG bytes as (T,) vlen-uint8 datasets (C2 "decode",
        # VERDICT r1 missing-3); must be uniform per camera across demos
        self._encoded: Dict[str, bool] = {}

        # Build the flat (demo, t) index + cache small tensors. Demos from
        # all files concatenate into one dataset in (file, natural-key)
        # order; `_demo_loc[di] = (file_idx, h5 group key)` is the lookup,
        # `_demo_keys[di]` the unique display name ("stem/demo_k" when
        # more than one file).
        self._proprio: List[np.ndarray] = []
        self._pos: List[np.ndarray] = []
        self._quat: List[np.ndarray] = []
        self._demo_keys: List[str] = []
        self._demo_loc: List[Tuple[int, str]] = []
        index: List[Tuple[int, int]] = []
        img_bytes = 0
        stems = [os.path.splitext(os.path.basename(p))[0]
                 for p in self.paths]
        if len(set(stems)) != len(stems):   # same basename in two dirs
            stems = [f"{fi}_{s}" for fi, s in enumerate(stems)]
        multi = len(self.paths) > 1
        fhs = [self._open(fi) for fi in range(len(self.paths))]
        try:
            demos: List[Tuple[int, str]] = []
            for fi, f in enumerate(fhs):
                keys = sorted(f["data"].keys(), key=_natural_key)
                if filter_key:
                    if "mask" not in f or filter_key not in f["mask"]:
                        have = sorted(f["mask"].keys()) if "mask" in f else []
                        raise KeyError(
                            f"{self.paths[fi]}: no mask/{filter_key} "
                            f"dataset (robomimic filter key); available "
                            f"filter keys: {have}")
                    names = {n.decode() if isinstance(n, bytes) else str(n)
                             for n in np.asarray(f["mask"][filter_key])}
                    keys = [k for k in keys if k in names]
                    if not keys:
                        raise ValueError(
                            f"{self.paths[fi]}: mask/{filter_key} matches "
                            "no demos in data/")
                demos.extend((fi, dk) for dk in keys)
            if max_demos > 0:
                demos = demos[:max_demos]
            if val_fraction > 0 and split != "all":
                # split at demo granularity so no trajectory leaks across;
                # the permutation runs over the CONCATENATED demo list, so
                # every file contributes to both splits in expectation
                n_val = max(1, int(round(len(demos) * val_fraction)))
                perm = np.random.RandomState(split_seed).permutation(
                    len(demos))
                val_set = set(perm[:n_val].tolist())
                demos = [d for i, d in enumerate(demos)
                         if (i in val_set) == (split == "val")]
                if not demos:
                    raise ValueError(
                        f"split {split!r} empty (val_fraction="
                        f"{val_fraction}, {len(val_set)} val demos)")
            for di, (fi, dk) in enumerate(demos):
                path = self.paths[fi]       # accurate error messages
                g = fhs[fi]["data"][dk]
                for key in list(self.target_keys) + (
                        list(self.proprio_keys) if use_proprio else []) + [
                        self.image_key_format.format(camera=c)
                        for c in self.cameras]:
                    if key not in g:
                        have = list(g.get("obs", g).keys())
                        raise KeyError(
                            f"{path}: demo {dk!r} has no dataset {key!r}; "
                            f"available obs keys: {have}. Adjust "
                            "data.image_key_format / proprio_key / "
                            "target_key (see docs/DATA_FORMAT.md)")
                tparts = [np.asarray(g[k], dtype=np.float32).reshape(
                    len(g[k]), -1) for k in self.target_keys]
                if len({p.shape[0] for p in tparts}) > 1:
                    raise ValueError(
                        f"{path}: demo {dk!r} target keys disagree on "
                        f"step count: " + ", ".join(
                            f"{k}={p.shape[0]}" for k, p in
                            zip(self.target_keys, tparts)))
                tgt = (np.concatenate(tparts, axis=-1)
                       if len(tparts) > 1 else tparts[0])
                if tgt.ndim != 2 or tgt.shape[1] < 7:
                    raise ValueError(
                        f"{path}: {dk}/{self.target_key} has shape "
                        f"{tgt.shape}; need (T, >=7) with [:3]=pos, "
                        "[3:7]=quat (see docs/DATA_FORMAT.md)")
                steps = tgt.shape[0]
                self._demo_keys.append(f"{stems[fi]}/{dk}" if multi else dk)
                self._demo_loc.append((fi, dk))
                self._pos.append(tgt[:, :3])
                q = tgt[:, 3:7]
                q = q / np.maximum(
                    np.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
                self._quat.append(q.astype(np.float32))
                if use_proprio:
                    parts = []
                    for k in self.proprio_keys:
                        arr = np.asarray(g[k], dtype=np.float32)
                        if arr.shape[0] != steps:
                            raise ValueError(
                                f"{path}: {dk}/{k} has {arr.shape[0]} steps "
                                f"but {self.target_key} has {steps}")
                        parts.append(arr.reshape(steps, -1))
                    self._proprio.append(np.concatenate(parts, axis=-1)
                                         if len(parts) > 1 else parts[0])
                for cam in self.cameras:
                    ds = g[self.image_key_format.format(camera=cam)]
                    enc = self._is_encoded(ds)
                    prev = self._encoded.setdefault(cam, enc)
                    if prev != enc:
                        raise ValueError(
                            f"{path}: camera {cam!r} mixes encoded and raw "
                            f"image datasets across demos")
                    if enc:
                        if ds.ndim != 1:
                            raise ValueError(
                                f"{path}: {dk}/{cam}: encoded image dataset "
                                f"must be (T,) vlen bytes, got {ds.shape}")
                        # encoded bytes: on-disk size ~= in-RAM cache size
                        img_bytes += int(ds.id.get_storage_size())
                    else:
                        img_bytes += int(np.prod(ds.shape)) * ds.dtype.itemsize
                # predictive targets: a sample needs its t+K label inside
                # the same demo, so the last K steps carry no sample
                # (a demo shorter than K+1 contributes none)
                index.extend((di, t)
                             for t in range(steps - self.target_lookahead))
        finally:
            for f in fhs:
                f.close()
        if not index:
            # np.asarray([]) would be 1-D and every later self._index[...]
            # gather would fail with a cryptic IndexError (ADVICE r4)
            n_steps = [p.shape[0] for p in self._pos]
            raise ValueError(
                f"target_lookahead={self.target_lookahead} leaves zero "
                f"samples: every demo needs at least "
                f"{self.target_lookahead + 1} steps, but the "
                f"{len(n_steps)} matched demos have "
                f"{min(n_steps)}..{max(n_steps)}" if n_steps else
                f"{self.paths}: no demos matched (check data.filter_key / "
                "the file's data/ group)")
        self._index = np.asarray(index, dtype=np.int64)
        self.proprio_dim = (
            self._proprio[0].shape[-1] if (use_proprio and self._proprio) else 0)

        # Flat per-step tensors + demo offsets (VERDICT r1 weak-4): batch
        # assembly becomes one vectorized gather instead of a per-sample
        # Python loop. Flat position demo_off[d] + t equals the global
        # sample index by construction (demos and steps appended in order).
        steps_arr = np.asarray([p.shape[0] for p in self._pos], np.int64)
        self._demo_off = np.zeros(len(steps_arr) + 1, np.int64)
        np.cumsum(steps_arr, out=self._demo_off[1:])
        self._pos_flat = (np.concatenate(self._pos) if self._pos
                          else np.zeros((0, 3), np.float32))
        self._quat_flat = (np.concatenate(self._quat) if self._quat
                           else np.zeros((0, 4), np.float32))
        self._proprio_flat = (np.concatenate(self._proprio)
                              if (use_proprio and self._proprio) else None)

        if cache_images is None:
            cache_images = img_bytes < (4 << 30)
        # raw image cache: one flat (N, H, W, 3) array per camera when all
        # demos share a source shape (vectorized frame gather); per-demo
        # dict otherwise (heterogeneous shapes, encoded byte arrays)
        self._image_cache: Optional[Dict[Tuple[int, str], np.ndarray]] = None
        self._raw_flat: Dict[str, np.ndarray] = {}
        if cache_images:
            cache: Dict[Tuple[int, str], np.ndarray] = {}
            fhs = [self._open(fi) for fi in range(len(self.paths))]
            try:
                for cam in self.cameras:
                    key = self.image_key_format.format(camera=cam)
                    shapes = set()
                    for fi, dk in self._demo_loc:
                        ds = fhs[fi]["data"][dk][key]
                        shapes.add(ds.shape[1:] if not self._encoded[cam]
                                   else ())
                    uniform = (not self._encoded[cam]) and len(shapes) == 1
                    if uniform:
                        hw = next(iter(shapes))
                        flat = np.empty((int(self._demo_off[-1]), *hw),
                                        np.uint8)
                        for di, (fi, dk) in enumerate(self._demo_loc):
                            lo = self._demo_off[di]
                            hi = self._demo_off[di + 1]
                            self._read_into(fhs[fi]["data"][dk][key],
                                            flat[lo:hi])
                        self._raw_flat[cam] = flat
                    else:
                        for di, (fi, dk) in enumerate(self._demo_loc):
                            cache[(di, cam)] = np.asarray(
                                fhs[fi]["data"][dk][key])
            finally:
                for f in fhs:
                    f.close()
            self._image_cache = cache
        self._cache_images = bool(cache_images)

    # -- low-level access ---------------------------------------------------

    def _open(self, fi: int):
        """The file of ``self.paths[fi]``, opened for reading."""
        return _h5py().File(self.paths[fi], "r")

    @staticmethod
    def _is_encoded(ds) -> bool:
        """Whether an image dataset holds encoded (vlen byte) frames."""
        return _h5py().check_vlen_dtype(ds.dtype) is not None

    @staticmethod
    def _read_into(ds, out: np.ndarray) -> None:
        ds.read_direct(out)

    def _fileh(self, fi: int) -> "h5py.File":
        """Per-(thread, file) h5py handle -- h5py is not safe across
        threads on a shared handle (SURVEY.md section 4.4)."""
        d = getattr(self._local, "files", None)
        if d is None:
            d = self._local.files = {}
        f = d.get(fi)
        if f is None:
            f = d[fi] = self._open(fi)
        return f

    def _demo_raw(self, demo: int, cam: str) -> np.ndarray:
        """All source frames of one demo, decoded, (T, H, W, 3) uint8."""
        lo, hi = self._demo_off[demo], self._demo_off[demo + 1]
        if cam in self._raw_flat:
            return self._raw_flat[cam][lo:hi]
        if self._cache_images and (demo, cam) in (self._image_cache or {}):
            raw = self._image_cache[(demo, cam)]
        else:
            fi, dk = self._demo_loc[demo]
            raw = self._fileh(fi)["data"][dk][
                self.image_key_format.format(camera=cam)][...]
        if self._encoded.get(cam, False):
            raw = np.stack([aug.decode_image(b) for b in raw])
        return raw

    def _read_frames(self, demo: int, cam: str, ts: np.ndarray) -> np.ndarray:
        """Frames (len(ts), H, W, 3) uint8; ts may repeat (clamped padding).
        Encoded cameras are decoded here, in the pipeline worker threads
        (cv2.imdecode releases the GIL -- SURVEY.md section 4.4's decode
        stage)."""
        encoded = self._encoded.get(cam, False)
        if cam in self._raw_flat:
            return self._raw_flat[cam][self._demo_off[demo] + ts]
        if self._cache_images and self._image_cache is not None:
            frames = self._image_cache[(demo, cam)]
            if not encoded:
                return frames[ts]
            uniq, inv = np.unique(ts, return_inverse=True)
            return np.stack([aug.decode_image(frames[t])
                             for t in uniq])[inv]
        fi, dk = self._demo_loc[demo]
        ds = self._fileh(fi)["data"][
            dk][self.image_key_format.format(camera=cam)]
        uniq, inv = np.unique(ts, return_inverse=True)
        if encoded:
            return np.stack([aug.decode_image(b) for b in ds[uniq]])[inv]
        return np.asarray(ds[uniq])[inv]

    def _resized_gather(self, cam: str, hw: int,
                        flat_idx: np.ndarray) -> Optional[np.ndarray]:
        """Deterministically-resized frames gathered by flat index from the
        memoized (N, hw, hw, 3) cache; None when images are not RAM-cached
        (memoizing whole demos would defeat the point of not caching).

        Thread notes: demo resizes are idempotent, the done-bit is set
        AFTER the slab write, and concurrent gathers touch disjoint or
        identical bytes -- worst case two workers resize one demo once
        each."""
        if not self._cache_images:
            return None
        key = (cam, hw)
        with self._resized_lock:
            arr = self._resized_flat.get(key)
            if arr is None:
                n_total = int(self._demo_off[-1])
                arr = np.empty((n_total, hw, hw, 3), np.uint8)
                self._resized_flat[key] = arr
                self._resized_done[key] = np.zeros(
                    len(self._demo_keys), bool)
            done = self._resized_done[key]
        need = np.unique(np.searchsorted(
            self._demo_off, flat_idx.reshape(-1), side="right") - 1)
        from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import (
            native as native_mod,
        )

        use_native = self.use_native and native_mod.available()
        for d in need:
            if done[d]:
                continue
            raw = self._demo_raw(int(d), cam)
            if use_native:
                res = native_mod.center_crop_resize_batch(raw, hw)
            else:
                res = np.stack([aug.center_crop_resize(fr, hw)
                                for fr in raw])
            lo, hi = self._demo_off[d], self._demo_off[d + 1]
            arr[lo:hi] = res
            done[d] = True
        return arr[flat_idx]

    def build_resized_cache(self, hw: int) -> Dict[str, np.ndarray]:
        """Force-fill and return the full deterministic resize cache,
        {camera: (N_frames, hw, hw, 3) uint8} -- the arrays a
        device-resident dataset uploads to HBM (data.device_cache).
        Requires RAM image caching (enabled automatically for datasets
        small enough to consider device residency)."""
        if not self._cache_images:
            raise ValueError(
                "device_cache requires the RAM image cache; this dataset "
                "was opened with cache_images=False (too large?)")
        out = {}
        all_idx = np.arange(int(self._demo_off[-1]))
        for cam in self.cameras:
            self._resized_gather(cam, hw, all_idx)   # fills every demo
            out[cam] = self._resized_flat[(cam, hw)]
        return out

    def __len__(self) -> int:
        return len(self._index)

    def frames_per_demo(self) -> np.ndarray:
        """(n_demos,) frame counts, demo order -- the weights the sharded
        cache layout bin-packs (data/cache_shard.build_shard_plan)."""
        return np.diff(self._demo_off)

    def sample_demos(self) -> np.ndarray:
        """(len(self),) demo index of every sample -- maps samples to
        cache shards (CacheShardPlan.shard_of_sample)."""
        return self._index[:, 0]

    def proprio_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dim (mean, std) of the proprio vectors in THIS split
        (model.proprio_normalize; fit() computes on the train split so the
        val/test path reuses training statistics). std is floored at 1e-6
        so constant dims normalize to 0 instead of inf."""
        if self._proprio_flat is None:
            raise ValueError("dataset has no proprio data "
                             "(use_proprio=False)")
        p = self._proprio_flat.reshape(-1, self._proprio_flat.shape[-1])
        return (p.mean(0, dtype=np.float64).astype(np.float32),
                np.maximum(p.std(0, dtype=np.float64), 1e-6)
                .astype(np.float32))

    # -- batch assembly (runs inside pipeline worker threads) ----------------

    def get_batch(self, indices: np.ndarray, augment: bool = False,
                  seed: int = 0) -> Dict:
        """Assemble one batch. Everything except per-image pixel work is
        vectorized numpy (VERDICT r1 weak-4: no per-sample Python loops or
        RandomState construction in the GIL hot path); pixel work runs in
        the C++ engine or cv2, both of which release the GIL."""
        tf = self.temporal_frames
        n = len(indices)
        indices = np.asarray(indices, dtype=np.int64)
        batch: Dict = {}

        dt = self._index[indices]                      # (n, 2): demo, t
        demos, ts0 = dt[:, 0], dt[:, 1]
        # temporal window with clamp-at-episode-start padding (C11)
        win = np.clip(ts0[:, None] + np.arange(-tf + 1, 1)[None, :], 0, None)
        flat_idx = self._demo_off[demos][:, None] + win  # (n, tf)

        # pose-mirroring flips (label-consistent hflip): ONE draw per sample
        # shared by every camera, because all cameras must agree with the
        # single mirrored label. Only applies when flips happen on host
        # (device-aug mirrors inside the train step instead).
        flips = None
        if (augment and self.cameras and self.hflip_pose_mirror
                and self.hflip_prob > 0 and self.device_aug_hw is None):
            fseeds = (seed * 1_000_003 + indices * 31
                      + 500_009) % (2 ** 31 - 1)
            flips = aug.hashed_uniforms(fseeds, 1)[:, 0] < self.hflip_prob

        if self.cameras:
            if self.emit_image_indices:
                # device-resident dataset (data.device_cache): the jitted
                # step gathers frames from the HBM cache by flat index --
                # no pixel bytes cross the host->device boundary. Under a
                # sharded cache (data.cache_layout) the emitted index is
                # the SHARD-LOCAL row; the sampler guarantees each batch
                # segment references only its own device's shard
                fi = flat_idx[:, 0] if tf == 1 else flat_idx
                if self.cache_plan is not None:
                    fi = self.cache_plan.local_row_of_frame[fi]
                batch["image_idx"] = fi.astype(np.int32)
            else:
                batch["images"] = {
                    cam: self._camera_batch(cam, ci, indices, demos, win,
                                            flat_idx, augment, seed,
                                            forced_flips=flips)
                    for ci, cam in enumerate(self.cameras)
                }

        if self.use_proprio:
            proprio = self._proprio_flat[flat_idx]     # (n, tf, D)
            batch["proprio"] = proprio[:, 0] if tf == 1 else proprio

        # label index: the LAST window frame, shifted K steps ahead for
        # predictive targets (in-range by construction: the index build
        # excluded each demo's last K steps)
        lab = flat_idx[:, -1] + self.target_lookahead
        tpos = self._pos_flat[lab].copy()               # (n, 3)
        tquat = self._quat_flat[lab].copy()
        if flips is not None and flips.any():
            # mirror the label with the image (ops/pose_math.mirror_pose
            # semantics, numpy): reflect pos about the plane, conjugate the
            # quaternion by the reflection
            ax, ctr = self.hflip_mirror_axis, self.hflip_mirror_center
            tpos[flips, ax] = 2.0 * ctr - tpos[flips, ax]
            qsign = -np.ones(4, dtype=np.float32)
            qsign[0] = 1.0
            qsign[1 + ax] = 1.0
            tquat[flips] *= qsign
        batch["target_pos"] = tpos
        batch["target_quat"] = tquat
        return batch

    def _camera_batch(self, cam: str, cam_idx: int, indices: np.ndarray,
                      demos: np.ndarray, win: np.ndarray,
                      flat_idx: np.ndarray, augment: bool, seed: int,
                      forced_flips: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, [tf,] hw, hw, 3) uint8 augmented/eval-transformed frames.

        One parameter draw per (sample, camera): all frames of a temporal
        stack share crop/flip/jitter (temporal consistency); cameras get
        independent draws -- except the flip when `forced_flips` is given
        (pose-mirror mode shares one flip per sample across cameras).
        Parameters come from the vectorized counter-based sampler; pixel
        work runs on the native C++ engine when built, else the numpy
        backend -- identical parameters either way."""
        tf, hw, n = self.temporal_frames, self.image_size, len(indices)

        if augment and self.device_aug_hw is not None:
            # device-side augmentation: host only resizes (deterministic);
            # crop/flip/jitter happen inside the jitted train step
            hw = self.device_aug_hw
            augment = False

        if not augment:
            gathered = self._resized_gather(cam, hw, flat_idx)
            if gathered is not None:   # (n, tf, hw, hw, 3)
                return gathered[:, 0] if tf == 1 else gathered

        # source frames: one vectorized gather from the flat raw cache when
        # available, else per-sample reads (h5py / decode)
        frames = None     # (n*tf, sh, sw, 3) contiguous, when uniform
        raws = None       # list of (tf, sh_i, sw_i, 3), when heterogeneous
        if cam in self._raw_flat:
            frames = self._raw_flat[cam][flat_idx.reshape(-1)]
        else:
            raws = [self._read_frames(int(d), cam, ts)
                    for d, ts in zip(demos, win)]
            if len({r.shape for r in raws}) == 1:
                frames = np.concatenate(raws, axis=0)

        if frames is not None:
            hs = np.full(n, frames.shape[1], np.int64)
            ws = np.full(n, frames.shape[2], np.int64)
        else:
            hs = np.asarray([r.shape[1] for r in raws], np.int64)
            ws = np.asarray([r.shape[2] for r in raws], np.int64)

        pb = None
        if augment:
            sseeds = (seed * 1_000_003 + indices * 31
                      + cam_idx * 7_777) % (2 ** 31 - 1)
            pb = aug.sample_aug_params_batch(hs, ws, sseeds,
                                             **self._aug_kwargs)
            if forced_flips is not None:
                pb["flip"] = np.asarray(forced_flips, bool)

        native = None
        if self.use_native and frames is not None:
            # heterogeneous source sizes fall back to the per-image numpy
            # path (the batch engine wants one contiguous array)
            from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import (
                native as native_mod,
            )

            if native_mod.available():
                native = native_mod

        if native is not None:
            if augment:
                crops = np.repeat(np.stack(
                    [pb["y0"], pb["x0"], pb["ch"], pb["cw"]], axis=1),
                    tf, axis=0)
                flips = np.repeat(pb["flip"].astype(np.uint8), tf)
                jit = np.repeat(np.stack(
                    [pb["brightness"], pb["contrast"], pb["saturation"],
                     pb["hue"]],
                    axis=1).astype(np.float32), tf, axis=0)
                out = native.augment_batch(frames, hw, crops, flips, jit)
            else:
                out = native.center_crop_resize_batch(frames, hw)
            out = out.reshape(n, tf, hw, hw, 3)
        else:
            if raws is None:
                raws = frames.reshape(n, tf, *frames.shape[1:])
            out = np.empty((n, tf, hw, hw, 3), dtype=np.uint8)
            for bi in range(n):
                p = aug.params_row(pb, bi) if augment else None
                for fi, fr in enumerate(raws[bi]):
                    if augment:
                        out[bi, fi] = aug.apply_aug_params(fr, p, hw)
                    else:
                        out[bi, fi] = aug.center_crop_resize(fr, hw)
        return out[:, 0] if tf == 1 else out


# ---------------------------------------------------------------------------
# Fixture generator (SURVEY.md section 5.2: tests build a tiny generated
# robosuite-layout file rather than shipping binary data).
# ---------------------------------------------------------------------------


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(N, 4) unit quaternions (w, x, y, z) -> (N, 3, 3) rotation matrices
    (numpy twin of ops/pose_math; sign-invariant)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def demo_fixture_arrays(
    n_demos: int = 3,
    steps: int = 20,
    cameras: Sequence[str] = ("agentview", "robot0_eye_in_hand"),
    image_hw: int = 84,
    proprio_dim: int = 32,
    seed: int = 0,
    leak_pose_into_proprio: bool = False,
    # realistic correlated-proprio mode: proprio[:, :7] = pose + N(0, sigma)
    # (an eef-pose-like signal that CORRELATES with the target without
    # copying it -- the robosuite situation; 0 = off)
    proprio_pose_noise: float = 0.0,
    # Per-camera occlusion (VERDICT r2 next-4: dual-camera must be shown
    # to HELP): when > 0, even-indexed cameras render the marker +
    # satellites only while pos_x < 0.5 + delta and odd-indexed only while
    # pos_x > 0.5 - delta (delta = this value). Each camera alone is then
    # blind on ~half the workspace; together they cover all of it.
    camera_occlusion: float = 0.0,
    # Velocity-extrapolated target (VERDICT r2 next-4: temporal stacking
    # must be shown to HELP): when > 0, the rendered marker follows a
    # smooth walk m[t] but the POSITION LABEL is
    #   pos_label[t] = m[t] + alpha * (m[t] - m[t-1])      (m[-1] = m[0])
    # with alpha = this value. A single frame reveals m[t] but not the
    # velocity term, so the best single-frame predictor has an
    # irreducible pos error of alpha * E|m[t]-m[t-1]|; a temporal model
    # sees consecutive frames and can recover the label exactly. The
    # orientation label stays single-frame-learnable (satellites render
    # the label quat itself).
    velocity_alpha: float = 0.0,
    # per-dim multiplier on the stored proprio vector (scalar or (D,) --
    # e.g. np.logspace(-2, 3, D) for mixed-unit raw robot state); the
    # model.proprio_normalize demonstration fixture. None/1.0 = off.
    proprio_scale=None,
    # Mislabeled-frame corruption (the failure mode train.pos_loss="huber"
    # exists for): this fraction of frames gets its stored POSITION label
    # replaced with a uniform-random point, AFTER rendering -- the image
    # still shows the true pose, only the label lies. Drawn from a
    # separate RNG stream, so a clean twin written with the same seed has
    # bit-identical images/proprio and differs only in the bad labels.
    label_outlier_frac: float = 0.0,
) -> Iterator[Dict]:
    """The demos of a tiny robomimic-layout demo file whose images are
    *informative*: a bright marker is drawn at the pixel projection of the
    target position, so a CNN can actually regress the pose -- this is what
    makes the image-path integration test a real learning test.

    Proprio is a smooth random walk UNRELATED to the target pose, so
    image-path accuracy numbers are attributable to the image path
    (VERDICT r1 weak-3: the r1 fixture copied pos/quat into proprio, which
    contaminated every accuracy artifact trained on it). Set
    `leak_pose_into_proprio=True` only for tests that specifically need a
    proprio-solvable task (e.g. proprio-branch learning smoke).

    Image->pose geometry of the fixture: the marker center column is
    pos_x * (W-1) and row is pos_y * (H-1), so a horizontal flip
    corresponds to mirroring pos about x=0.5 -- i.e.
    data.hflip_pose_mirror with hflip_mirror_axis=0,
    hflip_mirror_center=0.5 is the label-consistent flip for this data.
    ORIENTATION is fully pixel-encoded (r2: the r1 fixture encoded only
    quat_w^2, leaving rotation unlearnable and the rot-MAE artifact
    near-chance): two satellite dots at pos + 0.15*(R e_i), e_1=(0,1,0),
    e_2=(0,0,1), with (R e_i)_z in the green channel, determine R
    completely -- and remain label-consistent under the same mirror (the
    reflection maps R to MRM, so satellites of the mirrored quat are
    exactly the mirrored satellites; their z/color is unchanged).

    Yields, per demo and in order, {"name": "demo_<d>", "datasets":
    {path under the demo's group: array}, "attrs": {...}}: the arrays
    write_demo_fixture stores, in the order it stores them, images as raw
    (T, H, W, 3) uint8 frames. Plain numpy: a host without h5py serves
    them from memory (MemoryDemoStore)."""
    rs = np.random.RandomState(seed)
    rs_outlier = np.random.RandomState(seed + 90210)  # own stream: a clean
    # same-seed twin keeps bit-identical images/proprio (see param doc)
    for d in range(n_demos):
        name = f"demo_{d}"      # (d is reused for the satellites below)
        datasets: Dict[str, np.ndarray] = {}
        # smooth random-walk pose
        pos = np.empty((steps, 3), np.float32)
        pos[0] = rs.uniform(0.25, 0.75, 3)
        for t in range(1, steps):
            pos[t] = np.clip(pos[t - 1] + rs.randn(3) * 0.03, 0.05, 0.95)
        quat = rs.randn(steps, 4).astype(np.float32)
        quat[0] = [1, 0, 0, 0]
        for t in range(1, steps):
            quat[t] = quat[t - 1] + rs.randn(4) * 0.1
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

        # velocity-extrapolated label (see param doc): `pos` is the
        # RENDERED marker walk m; the label adds alpha * velocity on
        # the IMAGE-PLANE coordinates (x, y) only -- z is rendered as
        # a radius quantized to whole pixels (~0.17 resolution vs the
        # 0.03 walk step), so z-velocity would be unobservable and
        # merely add identical irreducible error to every model,
        # masking the single-frame vs temporal comparison the fixture
        # exists to make
        label_pos = pos
        if velocity_alpha > 0:
            prev = np.vstack([pos[0:1], pos[:-1]])
            label_pos = pos.copy()
            label_pos[:, :2] += velocity_alpha * (pos - prev)[:, :2]

        obj = np.zeros((steps, 14), np.float32)
        obj[:, :3] = label_pos
        obj[:, 3:7] = quat
        obj[:, 7:10] = rs.randn(steps, 3) * 0.1   # filler (gripper-to-obj)
        if label_outlier_frac > 0:
            bad = rs_outlier.rand(steps) < label_outlier_frac
            obj[bad, :3] = rs_outlier.uniform(
                0.0, 1.0, (int(bad.sum()), 3)).astype(np.float32)

        # smooth random walk, independent of the target pose
        proprio = np.empty((steps, proprio_dim), np.float32)
        proprio[0] = rs.randn(proprio_dim) * 0.3
        for t in range(1, steps):
            proprio[t] = proprio[t - 1] + rs.randn(proprio_dim) * 0.05
        if leak_pose_into_proprio:
            proprio[:, :3] = label_pos
            proprio[:, 3:7] = quat
        elif proprio_pose_noise > 0:
            sig = proprio_pose_noise
            proprio[:, :3] = label_pos + rs.randn(steps, 3) * sig
            qn = quat + rs.randn(steps, 4) * sig
            proprio[:, 3:7] = qn / np.linalg.norm(qn, axis=-1,
                                                  keepdims=True)

        # rotation matrices for the orientation satellites
        rots = _quat_to_mat(quat)           # (steps, 3, 3)

        for ci, cam in enumerate(cameras):
            imgs = rs.randint(0, 40, (steps, image_hw, image_hw, 3),
                              dtype=np.uint8)  # dark noise background
            for t in range(steps):
                if camera_occlusion > 0:
                    # even cameras see the left region, odd the right;
                    # the 2*delta overlap keeps a shared sliver
                    visible = (pos[t, 0] < 0.5 + camera_occlusion
                               if ci % 2 == 0
                               else pos[t, 0] > 0.5 - camera_occlusion)
                    if not visible:
                        continue   # background noise only this frame
                cy = int(pos[t, 1] * (image_hw - 1))
                cx = int(pos[t, 0] * (image_hw - 1))
                r = max(2, int(2 + pos[t, 2] * 6))
                y0, y1 = max(0, cy - r), min(image_hw, cy + r)
                x0, x1 = max(0, cx - r), min(image_hw, cx + r)
                color = (np.array([1, 0.2, 0.2]) * 255 * quat[t, 0] ** 2
                         + np.array([0.2, 0.2, 1]) * 255
                         * (1 - quat[t, 0] ** 2))
                imgs[t, y0:y1, x0:x1] = color.astype(np.uint8)
                # Orientation satellites: dots at pos + 0.15*(R e_i) for
                # e_1=(0,1,0), e_2=(0,0,1); the dot's green channel
                # encodes (R e_i)_z. Together they pin down R (the x
                # column is e_1' x e_2'), making ROTATION learnable from
                # pixels. Mirror-consistency (hflip_pose_mirror, axis=0,
                # center=0.5): reflection M=diag(-1,1,1) maps R to MRM,
                # so R'e_i = M(R e_i) for e_i with zero x-component --
                # exactly the satellite position mirrored, with its
                # z-component (the color) unchanged.
                for si, e in enumerate(((0.0, 1.0, 0.0),
                                        (0.0, 0.0, 1.0))):
                    d = rots[t] @ np.asarray(e)
                    sy = int(np.clip(pos[t, 1] + 0.15 * d[1], 0, 1)
                             * (image_hw - 1))
                    sx = int(np.clip(pos[t, 0] + 0.15 * d[0], 0, 1)
                             * (image_hw - 1))
                    sy0, sy1 = max(0, sy - 2), min(image_hw, sy + 2)
                    sx0, sx1 = max(0, sx - 2), min(image_hw, sx + 2)
                    ch = np.zeros(3)
                    ch[0 if si == 0 else 2] = 255   # satellite identity
                    ch[1] = (d[2] + 1) * 127.5      # z-component as green
                    imgs[t, sy0:sy1, sx0:sx1] = ch.astype(np.uint8)
            datasets[f"obs/{cam}_image"] = imgs
        if proprio_scale is not None:
            # ill-conditioned raw units (radians next to millimeters
            # next to raw encoder counts): per-dim multiplier on the
            # STORED vector only; labels and correlation structure are
            # untouched (the scaling is invertible). The
            # model.proprio_normalize artifact rows train on this.
            proprio = proprio * np.asarray(proprio_scale,
                                           np.float32).reshape(1, -1)
        datasets["obs/robot0_proprio-state"] = proprio
        datasets["obs/object"] = obj
        datasets["actions"] = rs.randn(steps, 7).astype(np.float32)
        yield {"name": name, "datasets": datasets,
               "attrs": {"num_samples": steps}}


def write_demo_fixture(
    path: str,
    n_demos: int = 3,
    steps: int = 20,
    cameras: Sequence[str] = ("agentview", "robot0_eye_in_hand"),
    image_hw: int = 84,
    proprio_dim: int = 32,
    seed: int = 0,
    leak_pose_into_proprio: bool = False,
    proprio_pose_noise: float = 0.0,
    encoding: str = "raw",   # "raw" | "jpeg" | "png" per-frame image storage
    camera_occlusion: float = 0.0,
    velocity_alpha: float = 0.0,
    proprio_scale=None,
    # robomimic filter keys: {"name": [demo indices]} written as
    # mask/<name> datasets of demo-name bytes (data.filter_key reads them)
    filter_keys=None,
    label_outlier_frac: float = 0.0,
) -> str:
    """Write the demos of demo_fixture_arrays (same arguments, documented
    there) to a robomimic-layout HDF5 file at ``path`` and return it;
    ``encoding`` "jpeg" or "png" stores each frame as encoded bytes in a
    (T,) vlen-uint8 dataset."""
    if encoding not in ("raw", "jpeg", "png"):
        raise ValueError(f"encoding must be raw/jpeg/png, got {encoding!r}")
    image_keys = {f"obs/{cam}_image" for cam in cameras}
    with _h5py().File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env"] = "Lift_fixture"
        data.attrs["repository_version"] = "rppe_tpu_fixture_v2"
        for demo in demo_fixture_arrays(
                n_demos, steps, cameras, image_hw, proprio_dim, seed,
                leak_pose_into_proprio, proprio_pose_noise,
                camera_occlusion, velocity_alpha, proprio_scale,
                label_outlier_frac):
            g = data.create_group(demo["name"])
            obs = g.create_group("obs")
            for key, arr in demo["datasets"].items():
                group, name = ((obs, key[len("obs/"):])
                               if key.startswith("obs/") else (g, key))
                if key in image_keys and encoding != "raw":
                    # robomimic-in-the-wild layout: per-frame encoded bytes
                    # in a (T,) vlen-uint8 dataset (VERDICT r1 missing-3)
                    ext = ".jpg" if encoding == "jpeg" else ".png"
                    ds = group.create_dataset(
                        name, (len(arr),),
                        dtype=_h5py().vlen_dtype(np.uint8))
                    for t in range(len(arr)):
                        ds[t] = aug.encode_image(arr[t], ext)
                else:
                    group.create_dataset(name, data=arr)
            for k, v in demo["attrs"].items():
                g.attrs[k] = v
        if filter_keys:
            mask = f.create_group("mask")
            for name, idxs in filter_keys.items():
                mask.create_dataset(name, data=np.array(
                    [f"demo_{i}".encode() for i in idxs]))
    return path


# ---------------------------------------------------------------------------
# In-memory stand-in for a fixture file (a host without h5py)
# ---------------------------------------------------------------------------


class _MemoryFile(dict):
    """The groups of one fixture file, as HDF5DemoStore reads them:
    {"data": {demo name: {path under the demo's group: array}}}."""

    def __init__(self, demos: Sequence[Dict]):
        super().__init__(data={d["name"]: d["datasets"] for d in demos})

    def close(self) -> None:
        pass


class MemoryDemoStore(HDF5DemoStore):
    """HDF5DemoStore over fixture demos held in memory: the stand-in for
    a write_demo_fixture file on a host without h5py. ``fixtures`` maps a
    name to the demos of demo_fixture_arrays; ``path`` names one or more
    of them (a comma list), as data.path names files. Every read goes
    through HDF5DemoStore's own code (the split, temporal windows, host
    augmentation, get_batch, proprio_stats and the device-cache
    interface); the demos are the file's, bit for bit. Raw frames only
    (no encoded images, no filter keys)."""

    def __init__(self, path: str, *, fixtures: Mapping[str, Sequence[Dict]],
                 **kwargs):
        self._fixtures = fixtures
        super().__init__(path, **kwargs)

    def _open(self, fi: int) -> _MemoryFile:
        name = self.paths[fi]
        if name not in self._fixtures:
            raise KeyError(f"no in-memory fixture {name!r}; have "
                           f"{sorted(self._fixtures)}")
        return _MemoryFile(self._fixtures[name])

    @staticmethod
    def _is_encoded(ds) -> bool:
        return False

    @staticmethod
    def _read_into(ds, out: np.ndarray) -> None:
        out[...] = ds


# ---------------------------------------------------------------------------
# Demo files as arrays, and their numpy-only carrier
# ---------------------------------------------------------------------------


def _attr_value(v):
    """An HDF5 attribute as a plain Python value (JSON-serializable)."""
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def demo_file_arrays(path: str) -> Tuple[List[Dict], Dict]:
    """The demos of a robomimic-layout HDF5 file, e.g. one written by
    playback.render_playback_dataset, as the per-demo dicts that
    MemoryDemoStore reads (demo_fixture_arrays' form: {"name",
    "datasets": {path under the demo's group: array}, "attrs"}), in
    natural demo order, and the data group's attributes. Raw image
    datasets only: encoded (vlen) frames raise ValueError."""
    h5py = _h5py()
    demos: List[Dict] = []
    with h5py.File(path, "r") as f:
        data = f["data"]
        attrs = {k: _attr_value(v) for k, v in data.attrs.items()}
        for name in sorted(data.keys(), key=_natural_key):
            group = data[name]
            datasets: Dict[str, np.ndarray] = {}

            def take(key, obj):
                if not isinstance(obj, h5py.Dataset):
                    return
                if h5py.check_vlen_dtype(obj.dtype) is not None:
                    raise ValueError(
                        f"{path}: {name}/{key} holds encoded frames; only "
                        "raw datasets are carried as arrays")
                datasets[key] = obj[()]

            group.visititems(take)
            demos.append({"name": name, "datasets": datasets,
                          "attrs": {k: _attr_value(v)
                                    for k, v in group.attrs.items()}})
    return demos, attrs


_NPZ_META = "__meta__"


def save_demos_npz(path: str, demos: Sequence[Dict],
                   attrs: Optional[Mapping] = None,
                   compress: bool = True) -> str:
    """Write ``demos`` (demo_file_arrays' dicts) and the data group's
    ``attrs`` to one ``.npz`` at ``path`` (atomically: a file under that
    name is complete) and return ``path``. Each dataset is the entry
    "<demo>/<key>"; the attributes travel as JSON in "__meta__"."""
    arrays = {f"{d['name']}/{k}": np.asarray(v)
              for d in demos for k, v in d["datasets"].items()}
    meta = {"attrs": dict(attrs or {}),
            "demos": [[d["name"], dict(d["attrs"])] for d in demos]}
    arrays[_NPZ_META] = np.array(json.dumps(meta))
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            (np.savez_compressed if compress else np.savez)(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_demos_npz(path: str) -> Tuple[List[Dict], Dict]:
    """The demos and data attributes save_demos_npz wrote, read with
    numpy alone (no h5py): what MemoryDemoStore and
    build_dataset(cfg, split, fixtures={name: demos}) take."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z[_NPZ_META]))
        keys: Dict[str, List[str]] = {}
        for entry in z.files:
            if entry != _NPZ_META:
                name, _, key = entry.partition("/")
                keys.setdefault(name, []).append(key)
        demos = [{"name": name,
                  "datasets": {k: z[f"{name}/{k}"] for k in keys.get(name, [])},
                  "attrs": dattrs}
                 for name, dattrs in meta["demos"]]
    return demos, meta["attrs"]

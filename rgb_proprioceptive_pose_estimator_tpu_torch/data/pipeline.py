"""Host -> device input pipeline (counterpart of the JAX package's
``data/pipeline.py``).

Stages:
  1. checkpointable index sampler (seeded per-epoch permutation),
  2. worker threads building uint8 numpy batches (decode/crop/flip/jitter;
     cv2/numpy release the GIL, or the native C++ engine),
  3. in-order emission (deterministic regardless of worker count),
  4. copies into pinned host buffers, then ``non_blocking`` copies to the
     model's device on the current stream, ``prefetch`` batches ahead (the
     host queues them behind the running step and does not wait);
     normalization happens on the device in the model.

The sampler and the per-batch seeds are the JAX package's, so for one
config and seed the batches are bit-identical. Fixed batch size; partial
batches are dropped. The sampler state {seed, consumed} goes into
checkpoints. Under data parallelism (``rank``/``world``, one process per
device) every rank draws the same global batch indices and builds only
its contiguous slice of them with the global batch's seed, as the JAX
package's processes do under multi-host: augmentation is drawn per sample,
so rank r's rows are rows ``r*B/world`` to ``(r+1)*B/world`` of the
global batch, bit for bit. Across hosts (``dist.multihost``) the global
ranks are process-major, so a host's ranks hold together the reference's
process slice. The sharded device cache is not ported.

Spans (``utils/prof``, recorded only while tracing): ``rppe.feed`` around
``__next__`` (counter ``ready``: ``queue_depth()`` at entry), with
``rppe.feed.wait`` (blocked on a worker's batch) and ``rppe.feed.h2d``
(pinning and queueing the copy to the device).
"""

from __future__ import annotations

import collections
import functools
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config, DataConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.data.synthetic import (
    SyntheticProprioDataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import prof


def build_dataset(cfg: Config, split: str = "all",
                  fixtures: Optional[Dict[str, Any]] = None):
    """Construct the dataset named by cfg.data.source.

    split: "all" | "train" | "val" -- "train"/"val" are only distinct when
    cfg.data.val_fraction > 0 (hdf5 splits by demo; synthetic by index) or
    cfg.data.val_path is set (hdf5: val = ALL of the separate file(s),
    train = ALL of data.path).

    fixtures: {name: demos of hdf5_store.demo_fixture_arrays}; given, the
    hdf5 source's data.path and data.val_path name entries of it, served
    from memory by hdf5_store.MemoryDemoStore instead of files."""
    d, m = cfg.data, cfg.model
    if d.source == "synthetic":
        return SyntheticProprioDataset(
            size=d.synthetic_size,
            proprio_dim=m.proprio_dim,
            noise=d.synthetic_noise,
            seed=d.seed,
            temporal_frames=m.temporal_frames,
            split=split,
            val_fraction=d.val_fraction,
        )
    if d.source == "hdf5":
        if not d.path:
            raise ValueError("cfg.data.path required for hdf5 source")
        if d.device_cache and m.backbone == "none":
            # fit only uploads the cache for image models; a proprio-only
            # model with device_cache would ship a dead image_idx array
            # every batch and silently train without images
            raise ValueError(
                "data.device_cache requires an image backbone "
                "(model.backbone != 'none'); a proprio-only model has no "
                "frames to cache")
        # the HDF5 store imports h5py where it opens a file; a host that
        # trains from memory never loads it
        from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
            HDF5DemoStore,
            MemoryDemoStore,
        )

        make_store = (HDF5DemoStore if fixtures is None else
                      functools.partial(MemoryDemoStore, fixtures=fixtures))

        # data.val_path: the val split is a SEPARATE held-out file
        # collection (whole file(s), no fraction split on either side);
        # max_demos / filter_key select the TRAIN set only
        path = d.path
        val_fraction = d.val_fraction
        max_demos = d.max_demos
        filter_key = d.filter_key
        if d.val_path:
            if split == "val":
                path = d.val_path
                max_demos = 0
                filter_key = ""
            split, val_fraction = "all", 0.0
        store = make_store(
            path,
            split=split,
            val_fraction=val_fraction,
            split_seed=d.split_seed,
            max_demos=max_demos,
            filter_key=filter_key,
            cameras=m.cameras if m.backbone != "none" else (),
            image_size=m.image_size,
            temporal_frames=m.temporal_frames,
            image_key_format=d.image_key_format,
            proprio_key=d.proprio_key,
            target_key=d.target_key,
            target_lookahead=d.target_lookahead,
            use_proprio=m.use_proprio,
            use_native=d.use_native,
            device_aug_hw=(m.image_size + 2 * d.crop_margin
                           if d.augment_device and d.augment else None),
            crop_scale=d.crop_scale,
            crop_ratio=d.crop_ratio,
            hflip_prob=d.hflip_prob,
            hflip_pose_mirror=d.hflip_pose_mirror,
            hflip_mirror_axis=d.hflip_mirror_axis,
            hflip_mirror_center=d.hflip_mirror_center,
            jitter_brightness=d.jitter_brightness,
            jitter_contrast=d.jitter_contrast,
            jitter_saturation=d.jitter_saturation,
            jitter_hue=d.jitter_hue,
            jitter_prob=d.jitter_prob,
            cache_images=(True if d.device_cache else None),
        )
        store.emit_image_indices = bool(d.device_cache) and bool(store.cameras)
        return store
    raise ValueError(f"unknown data source {d.source!r}")


def _to_device(tree: Any, device: torch.device) -> Any:
    """numpy leaves -> tensors on device; on CUDA through pinned host
    memory with a non_blocking copy on the current stream."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostPipeline:
    """Infinite (train) or single-epoch (eval) iterator of device batches:
    dicts of tensors on ``device`` shaped as the dataset's ``get_batch``
    returns them; ``batch_size`` is the global batch, of which rank
    ``rank`` of ``world`` gets its contiguous slice. ``shard_of_sample``
    (the sharded device cache's sample -> shard map) with ``n_shards`` > 1
    makes row block d of every global batch shard d's samples."""

    def __init__(self, dataset, cfg: DataConfig,
                 device: Union[str, torch.device] = "cpu",
                 train: bool = True, batch_size: Optional[int] = None,
                 rank: int = 0, world: int = 1,
                 shard_of_sample: Optional[np.ndarray] = None,
                 n_shards: int = 1):
        self.dataset = dataset
        self.cfg = cfg
        self.device = torch.device(device)
        self.train = train
        self.batch_size = batch_size or cfg.batch_size
        if self.batch_size % world != 0 or not 0 <= rank < world:
            raise ValueError(
                f"global batch {self.batch_size} not divisible by {world} "
                f"ranks, or rank {rank} not among them")
        self.rank, self.world = rank, world
        if len(dataset) < self.batch_size:
            raise ValueError(
                f"dataset size {len(dataset)} < batch size {self.batch_size}")
        self.batches_per_epoch = len(dataset) // self.batch_size
        self.augment = bool(cfg.augment) and train

        # data.cache_layout="sharded": batch segment d, rank d's slice when
        # n_shards == world, references only shard-d samples
        self._n_shards = max(int(n_shards), 1)
        self._samples_by_shard = None
        if shard_of_sample is not None and self._n_shards > 1:
            if self.batch_size % self._n_shards != 0:
                raise ValueError(
                    f"batch size {self.batch_size} not divisible by "
                    f"{self._n_shards} cache shards")
            shard_of_sample = np.asarray(shard_of_sample)
            if len(shard_of_sample) != len(dataset):
                raise ValueError(
                    f"shard_of_sample covers {len(shard_of_sample)} samples "
                    f"!= dataset size {len(dataset)}")
            self._samples_by_shard = [
                np.flatnonzero(shard_of_sample == d)
                for d in range(self._n_shards)]
            per = self.batch_size // self._n_shards
            # an epoch is bounded by the smallest shard; per-shard
            # reshuffles rotate any dropped tail across epochs
            self.batches_per_epoch = min(
                len(s) for s in self._samples_by_shard) // per
            if self.batches_per_epoch < 1:
                raise ValueError(
                    "smallest cache shard has "
                    f"{min(len(s) for s in self._samples_by_shard)} samples "
                    f"< {per} per-device batch; reduce data.batch_size or "
                    "device count (data.cache_layout='sharded')")

        self._consumed = 0            # global batch counter (checkpoint state)
        self._scheduled = 0
        self._perm_cache: Dict[int, np.ndarray] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        if cfg.num_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=cfg.num_workers,
                thread_name_prefix="rppe-data")
        self._inflight: "collections.deque[Future]" = collections.deque()
        self._device_q: "collections.deque" = collections.deque()
        self._max_inflight = max(cfg.num_workers * 2, 1)
        self._max_device = max(cfg.prefetch, 1)

    # -- sampler (the JAX package's, exactly) ----------------------------------

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        """Per-epoch permutation, memoized; a couple of epochs are kept
        (in-flight batches straddle at most two)."""
        perm = self._perm_cache.get(epoch)
        if perm is None:
            if self._samples_by_shard is not None:
                perm = self._sharded_perm(epoch)
            elif self.train and self.cfg.shuffle:
                perm = np.random.RandomState(
                    (self.cfg.seed + epoch) % (2 ** 31 - 1)
                ).permutation(len(self.dataset))
            else:
                perm = np.arange(len(self.dataset))
            self._perm_cache = {k: v for k, v in self._perm_cache.items()
                                if k >= epoch - 1}
            self._perm_cache[epoch] = perm
        return perm

    def _sharded_perm(self, epoch: int) -> np.ndarray:
        """Epoch index stream of the sharded cache layout: every shard's
        samples permuted independently (a stream per (seed, epoch, shard)),
        cut to the epoch's per-shard sample count, and interleaved
        shard-major, so that batch row block d is shard d's next ``per``
        samples. Eval pipelines (no shuffle) interleave the natural
        per-shard order."""
        per = self.batch_size // self._n_shards
        e = self.batches_per_epoch
        cols = []
        for d, samp in enumerate(self._samples_by_shard):
            if self.train and self.cfg.shuffle:
                rs = np.random.RandomState(
                    ((self.cfg.seed + epoch) * 9_973 + d) % (2 ** 31 - 1))
                samp = rs.permutation(samp)
            cols.append(samp[:e * per])
        return (np.stack(cols)                      # (D, e*per)
                .reshape(self._n_shards, e, per)
                .transpose(1, 0, 2)                 # (e, D, per)
                .reshape(-1))

    def _indices_for(self, global_batch: int) -> np.ndarray:
        epoch, pos = divmod(global_batch, self.batches_per_epoch)
        perm = self._epoch_perm(epoch)
        lo = pos * self.batch_size
        return perm[lo:lo + self.batch_size]

    def _build(self, global_batch: int) -> Dict[str, Any]:
        idx = self._indices_for(global_batch)
        per = self.batch_size // self.world
        idx = idx[self.rank * per:(self.rank + 1) * per]
        seed = (self.cfg.seed * 7_919 + global_batch) % (2 ** 31 - 1)
        return self.dataset.get_batch(idx, augment=self.augment, seed=seed)

    # -- pipeline mechanics ----------------------------------------------------

    def _schedule(self, limit: Optional[int] = None) -> None:
        while len(self._inflight) < self._max_inflight:
            if limit is not None and self._scheduled >= limit:
                return
            gb = self._scheduled
            self._scheduled += 1
            if self._pool is not None:
                self._inflight.append(self._pool.submit(self._build, gb))
            else:
                f: Future = Future()
                f.set_result(self._build(gb))
                self._inflight.append(f)

    def _fill_device_q(self, limit: Optional[int] = None) -> None:
        self._schedule(limit)
        while len(self._device_q) < self._max_device and self._inflight:
            with prof.span("rppe.feed.wait"):
                np_batch = self._inflight.popleft().result()
            with prof.span("rppe.feed.h2d"):
                self._device_q.append(_to_device(np_batch, self.device))
            self._schedule(limit)

    def queue_depth(self) -> int:
        """Host-side ready batches: the canary for a starving device."""
        return sum(f.done() for f in self._inflight) + len(self._device_q)

    # -- iteration -------------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        """Infinite stream of device batches (training)."""
        with prof.span("rppe.feed") as sp:
            if sp.active:
                sp.count("ready", self.queue_depth())
            self._fill_device_q()
            self._consumed += 1
            return self._device_q.popleft()

    def epoch(self, max_batches: int = 0, start: int = 0) -> Iterator:
        """One deterministic pass over the dataset (evaluation), optionally
        capped at max_batches, which bounds scheduling too. ``start``
        rotates a partial pass to begin at batch ``start %
        batches_per_epoch``, wrapping around the split; full passes ignore
        it."""
        if self.train:
            raise RuntimeError(
                "epoch() is for eval pipelines (train=False); a training "
                "pipeline's sampler state would be corrupted")
        n = self.batches_per_epoch
        limit = n
        if max_batches:
            limit = min(limit, max_batches)
        base = (start % n) if (start and limit < n) else 0
        self._reset(base)
        try:
            for _ in range(limit):
                self._fill_device_q(base + limit)
                yield self._device_q.popleft()
        finally:
            self._reset()

    def _reset(self, position: Optional[int] = None) -> None:
        for f in self._inflight:
            f.cancel()
        self._inflight.clear()
        self._device_q.clear()
        self._scheduled = self._consumed if position is None else position

    # -- checkpointable state ---------------------------------------------------

    STATE_FORMAT = 1

    def state_dict(self) -> Dict[str, Any]:
        return {"format": self.STATE_FORMAT, "consumed": int(self._consumed),
                "seed": int(self.cfg.seed),
                "batch_size": int(self.batch_size),
                # the sharded cache's index stream depends on the shard
                # partition, which depends on the device count
                "n_shards": (self._n_shards
                             if self._samples_by_shard is not None else 1)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        fmt = int(state.get("format", 1))
        if fmt != self.STATE_FORMAT:
            raise ValueError(
                f"checkpoint iterator state format {fmt} != supported "
                f"{self.STATE_FORMAT}")
        if int(state.get("batch_size", self.batch_size)) != self.batch_size:
            raise ValueError("cannot resume with a different batch size")
        saved_seed = int(state.get("seed", self.cfg.seed))
        if saved_seed != self.cfg.seed:
            raise ValueError(
                f"cannot resume: checkpoint sampler seed {saved_seed} != "
                f"config data.seed {self.cfg.seed}")
        cur_shards = (self._n_shards
                      if self._samples_by_shard is not None else 1)
        saved_shards = int(state.get("n_shards", 1))
        if saved_shards != cur_shards:
            raise ValueError(
                f"cannot resume: checkpoint sampler used {saved_shards} "
                f"cache shard(s), this run has {cur_shards} -- the sharded "
                "cache index stream depends on the device count "
                "(data.cache_layout='sharded'); resume on the same mesh "
                "size or start a fresh run")
        self._consumed = int(state["consumed"])
        self._reset()

    def close(self) -> None:
        self._reset()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

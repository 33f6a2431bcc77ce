"""Sharded device-resident frame cache (data.cache_layout="sharded"),
counterpart of the JAX package's ``data/cache_shard.py``; numpy only.

The replicated device cache (data.device_cache, engine/loop.py
upload_image_cache) puts one full copy of the resized frames in every
rank's device memory, so dataset capacity is capped by one card however
many cards train. Sharding the cache over the ranks multiplies capacity by
their count: rank d holds only shard d's frames, the sampler constrains
every global batch so that the rows rank d takes (its contiguous slice,
``data/pipeline.HostPipeline``) reference only shard-d frames, and the
in-step gather is a local ``index_select`` on the rank's shard, with no
collective: the same gather the replicated layout runs, without N-1
redundant copies.

Shard assignment is at demo granularity:
  * temporal windows are clamped inside one episode (hdf5_store.get_batch),
    so windows never straddle shards;
  * demos are packed into shards by greedy LPT (longest-processing-time)
    on frame counts, so shard row counts stay balanced without splitting
    episodes.
Every shard is padded to the common row count S = max_d rows_d; pad rows
duplicate the shard's first frame and are never referenced by the
sampler.

Sampling under the sharded layout: each epoch permutes every shard's
samples independently and interleaves them shard-major, so batch b =
[shard0's next per-rank samples | shard1's ... ]: per-shard stratified
sampling, where each rank samples its own data shard; an epoch covers
min_d(n_d) samples per shard (LPT keeps the shards within one demo of
each other, and a fresh per-shard permutation each epoch rotates any
dropped tail).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class CacheShardPlan:
    """Demo-granularity layout of cache rows across `n_shards` devices.

    row_of_frame: store flat-frame index -> GLOBAL cache row. Rows
        [d*rows_per_shard, (d+1)*rows_per_shard) live on rank d; a demo's
        frames stay contiguous so temporal windows remain local offsets.
    frame_of_row: global cache row -> store flat-frame index (pad rows
        point at their shard's first frame -- valid pixels, never sampled).
    shard_of_demo: demo index -> shard.
    """

    n_shards: int
    rows_per_shard: int
    row_of_frame: np.ndarray     # (n_frames,) int64
    frame_of_row: np.ndarray     # (n_shards * rows_per_shard,) int64
    shard_of_demo: np.ndarray    # (n_demos,) int64

    @property
    def local_row_of_frame(self) -> np.ndarray:
        """Store flat-frame index -> SHARD-LOCAL cache row (what get_batch
        emits as image_idx: each rank's gather indexes its own block, see
        engine/train_step.gather_cached_images)."""
        return self.row_of_frame % self.rows_per_shard

    def shard_of_sample(self, sample_demos: np.ndarray) -> np.ndarray:
        """Sample index -> shard, via the sample's demo
        (HDF5DemoStore.sample_demos())."""
        return self.shard_of_demo[np.asarray(sample_demos)]

    def per_device_bytes(self, hw: int, n_cameras: int) -> int:
        """Device memory the sharded cache costs EACH rank (uint8 RGB
        frames) -- the number the upload budget guard compares,
        total/n_shards-ish plus padding."""
        return int(self.rows_per_shard) * hw * hw * 3 * n_cameras


def build_shard_plan(frames_per_demo: np.ndarray,
                     n_shards: int) -> CacheShardPlan:
    """Pack demos into `n_shards` balanced bins (greedy LPT on frame
    counts, deterministic: ties break on demo index) and lay out cache
    rows shard-contiguously."""
    frames_per_demo = np.asarray(frames_per_demo, dtype=np.int64)
    n_demos = len(frames_per_demo)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_demos < n_shards:
        raise ValueError(
            f"data.cache_layout='sharded' needs at least one demo per "
            f"device: {n_demos} demos < {n_shards} devices")

    # LPT: biggest demos first, each into the currently-lightest shard.
    # np.argsort(-x, kind="stable") is deterministic across runs/processes
    # (every rank, on every host, builds the SAME plan from the same
    # dataset).
    order = np.argsort(-frames_per_demo, kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    shard_of_demo = np.empty(n_demos, dtype=np.int64)
    demos_by_shard = [[] for _ in range(n_shards)]
    for d in order:
        s = int(np.argmin(load))      # argmin ties break on lowest shard
        shard_of_demo[d] = s
        load[s] += frames_per_demo[d]
        demos_by_shard[s].append(int(d))

    rows_per_shard = int(load.max())
    demo_off = np.concatenate([[0], np.cumsum(frames_per_demo)])
    n_frames = int(demo_off[-1])
    row_of_frame = np.empty(n_frames, dtype=np.int64)
    frame_of_row = np.empty(n_shards * rows_per_shard, dtype=np.int64)
    for s, demos in enumerate(demos_by_shard):
        base = s * rows_per_shard
        pos = 0
        for d in demos:
            lo, hi = int(demo_off[d]), int(demo_off[d + 1])
            row_of_frame[lo:hi] = base + pos + np.arange(hi - lo)
            frame_of_row[base + pos:base + pos + (hi - lo)] = np.arange(
                lo, hi)
            pos += hi - lo
        # pad rows: duplicate the shard's first frame (sampler never emits
        # a pad row; the duplicate only keeps the upload well-defined)
        frame_of_row[base + pos:base + rows_per_shard] = frame_of_row[base]
    return CacheShardPlan(
        n_shards=n_shards,
        rows_per_shard=rows_per_shard,
        row_of_frame=row_of_frame,
        frame_of_row=frame_of_row,
        shard_of_demo=shard_of_demo,
    )


def build_sharded_cache(store, hw: int,
                        plan: CacheShardPlan) -> Dict[str, np.ndarray]:
    """{camera: (n_shards * rows_per_shard, hw, hw, 3) uint8} host arrays
    in shard-contiguous row order (rank d's block is rows
    [d*rows_per_shard, (d+1)*rows_per_shard)). Reorders the store's
    memoized resize cache; costs one transient extra camera-array of host
    RAM during the fancy-index copy."""
    base = store.build_resized_cache(hw)
    return {cam: arr[plan.frame_of_row] for cam, arr in base.items()}

"""The port's device-resident data path on the CPU, held against the JAX
package: the sharded cache's plan (``data/cache_shard.py``), the
shard-constrained sampler (``data.cache_layout="sharded"``), device
augmentation (``ops/image_augment_device.py``) fed the reference's own
draws, and fits with ``data.device_cache`` and ``data.augment_device``.

torch cannot draw ``jax.random``'s bits, so the comparisons replay the
reference's key splits in JAX (``jax.random.split(key, 10)`` and the same
``uniform``/``randint`` calls as its ``device_augment``) and feed those
draws to the port. Tolerances: crop, flip and brightness atol 1e-6 (the
crops and flips are exact), 1e-5 with contrast, saturation and hue (the
per-frame mean sums in another order). The fits run pr2 (CNNSmall) at 32
px on a demo fixture with SGD at lr 1e-3 from the JAX package's initial
weights, in f32 on one intra-op thread: losses rtol 1e-5, parameters rtol
2e-5 atol 2e-6, as tests/test_torch_extras.py holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data import cache_shard as ref_shard
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.data.pipeline import (
    HostPipeline as JaxHostPipeline,
)
from rgb_proprioceptive_pose_estimator_tpu.data.pipeline import (
    build_dataset as jax_build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.loop import fit as jax_fit
from rgb_proprioceptive_pose_estimator_tpu.engine.state import (
    create_state as jax_create_state,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.ops import (
    image_augment_device as ref_aug,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data import cache_shard
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import (
    train_step as port_step,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import (
    image_augment_device as ida,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    state_dict_from_jax,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
GEOMETRY_ATOL = 1e-6
JITTER_ATOL = 1e-5
BATCH = 8
FIT_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the shard plan and the sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,n_shards", [
    ([7, 3, 5, 2, 9, 4, 6, 8], 4),
    ([20, 20, 20], 2),
    ([1, 30, 2, 2, 11, 5, 5], 3),
    ([4], 1),
], ids=["ragged 8 into 4", "ties 3 into 2", "skewed 7 into 3", "one"])
def test_shard_plan_matches_the_reference(frames, n_shards):
    want = ref_shard.build_shard_plan(np.array(frames), n_shards)
    got = cache_shard.build_shard_plan(np.array(frames), n_shards)
    assert got.n_shards == want.n_shards
    assert got.rows_per_shard == want.rows_per_shard
    for name in ("row_of_frame", "frame_of_row", "shard_of_demo",
                 "local_row_of_frame"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    demos = np.arange(len(frames))[::-1]
    np.testing.assert_array_equal(got.shard_of_sample(demos),
                                  want.shard_of_sample(demos))
    assert got.per_device_bytes(16, 2) == want.per_device_bytes(16, 2)


def test_shard_plan_refuses_fewer_demos_than_shards():
    with pytest.raises(ValueError, match="at least one demo per"):
        cache_shard.build_shard_plan(np.array([3, 4]), 3)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        cache_shard.build_shard_plan(np.array([3, 4]), 0)


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    """Five demos of 12 steps (two shards hold 3 and 2 of them), two
    cameras, 40 px frames."""
    path = str(tmp_path_factory.mktemp("device_data") / "demo.hdf5")
    return write_demo_fixture(path, n_demos=5, steps=12, image_hw=40,
                              seed=3)


def _data_cfg(path, **overrides):
    """(JAX config, port config): pr2 (CNNSmall, one camera) at 32 px on
    the demo fixture, batch 8, SGD at lr 1e-3, in f32."""
    dotted = {"model.image_size": 32, "data.path": path,
              "data.batch_size": BATCH, "data.num_workers": 0,
              "data.augment": False, "train.optimizer": "sgd",
              "train.lr": 1e-3, "train.grad_clip": 0.0,
              "train.weight_decay": 0.0, "train.lr_schedule": "constant",
              "train.warmup_steps": 0, "dist.num_devices": 1, **overrides}
    jcfg = jax_preset("pr2").override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sharded_sampler_matches_the_reference(demo_h5, train):
    """Three epochs of global batches under a 2-shard plan: the same
    indices as the reference's sampler, row block d from shard d."""
    jcfg, cfg = _data_cfg(demo_h5, **{"data.device_cache": True})
    jstore, store = jax_build_dataset(jcfg), build_dataset(cfg)
    plan = cache_shard.build_shard_plan(store.frames_per_demo(), 2)
    jplan = ref_shard.build_shard_plan(jstore.frames_per_demo(), 2)
    jstore.cache_plan, store.cache_plan = jplan, plan
    shard = plan.shard_of_sample(store.sample_demos())
    jpipe = JaxHostPipeline(jstore, jcfg.data, train=train,
                            shard_of_sample=jplan.shard_of_sample(
                                jstore.sample_demos()), n_shards=2)
    pipe = HostPipeline(store, cfg.data, device="cpu", train=train,
                        shard_of_sample=shard, n_shards=2)
    assert pipe.batches_per_epoch == jpipe.batches_per_epoch >= 1
    for gb in range(3 * pipe.batches_per_epoch):
        idx = pipe._indices_for(gb)
        np.testing.assert_array_equal(idx, jpipe._indices_for(gb))
        np.testing.assert_array_equal(shard[idx],
                                      np.repeat([0, 1], BATCH // 2))
    if train:
        for _ in range(2):
            want, got = next(jpipe), next(pipe)
            np.testing.assert_array_equal(got["image_idx"].numpy(),
                                          np.asarray(want["image_idx"]))
        assert pipe.state_dict() == jpipe.state_dict()
    jpipe.close()
    pipe.close()


def test_sharded_sampler_refuses_a_resume_at_another_shard_count(demo_h5):
    _, cfg = _data_cfg(demo_h5, **{"data.device_cache": True})
    store = build_dataset(cfg)
    plan = cache_shard.build_shard_plan(store.frames_per_demo(), 2)
    pipe = HostPipeline(store, cfg.data, device="cpu", train=True,
                        shard_of_sample=plan.shard_of_sample(
                            store.sample_demos()), n_shards=2)
    next(pipe)
    state = pipe.state_dict()
    assert state["n_shards"] == 2
    plain = HostPipeline(store, cfg.data, device="cpu", train=True)
    with pytest.raises(ValueError, match="cache shard"):
        plain.load_state_dict(state)
    with pytest.raises(ValueError, match="cache shard"):
        pipe.load_state_dict(plain.state_dict())
    pipe.load_state_dict(state)
    pipe.close()
    plain.close()


def test_pipeline_rank_slices_are_the_sharded_segments(demo_h5):
    """Under the sharded layout rank d's slice of each global batch is
    row block d: the rows of its own shard, as local rows."""
    _, cfg = _data_cfg(demo_h5, **{"data.device_cache": True})
    store = build_dataset(cfg)
    plan = cache_shard.build_shard_plan(store.frames_per_demo(), 2)
    store.cache_plan = plan
    shard = plan.shard_of_sample(store.sample_demos())
    kw = dict(shard_of_sample=shard, n_shards=2)
    whole = HostPipeline(store, cfg.data, device="cpu", train=True, **kw)
    ranks = [HostPipeline(store, cfg.data, device="cpu", train=True,
                          rank=r, world=2, **kw) for r in range(2)]
    for _ in range(3):
        w = next(whole)["image_idx"]
        parts = [next(p)["image_idx"] for p in ranks]
        assert torch.equal(torch.cat(parts), w)
        for r, part in enumerate(parts):
            assert int(part.max()) < plan.rows_per_shard
    for p in [whole] + ranks:
        p.close()


def test_build_dataset_device_options(demo_h5):
    _, cfg = _data_cfg(demo_h5, **{"data.device_cache": True,
                                   "data.augment": True,
                                   "data.augment_device": True,
                                   "data.crop_margin": 4})
    store = build_dataset(cfg)
    assert store.emit_image_indices and store.device_aug_hw == 40
    batch = store.get_batch(np.arange(4), augment=True, seed=1)
    assert batch["image_idx"].dtype == np.int32 and "images" not in batch
    _, cfg = _data_cfg(demo_h5, **{"data.augment": True,
                                   "data.augment_device": True,
                                   "data.crop_margin": 4})
    store = build_dataset(cfg)
    assert not store.emit_image_indices
    # host resizes to image_size + 2 * margin and leaves the rest to the
    # device
    assert store.get_batch(np.arange(4), augment=True, seed=1)[
        "images"]["agentview"].shape == (4, 40, 40, 3)
    _, cfg = _data_cfg(demo_h5, **{"data.device_cache": True,
                                   "model.backbone": "none",
                                   "model.cameras": ()})
    with pytest.raises(ValueError, match="requires an image backbone"):
        build_dataset(cfg)


def test_only_configs_refusals_remain_for_the_device_options(demo_h5):
    for over in ({"data.device_cache": True},
                 {"data.device_cache": True, "data.augment": True,
                  "data.augment_device": True},
                 {"data.augment": True, "data.augment_device": True},
                 {"data.device_cache": True,
                  "data.cache_layout": "sharded"}):
        loop.check_fit_supported(_data_cfg(demo_h5, **over)[1])


# ---------------------------------------------------------------------------
# device augmentation against the reference, with the reference's draws
# ---------------------------------------------------------------------------


def jax_draws(key, b, h, w, out_hw, hflip_prob=0.0, jitter_brightness=0.2,
              jitter_contrast=0.2, jitter_saturation=0.2, jitter_hue=0.0,
              jitter_prob=0.8, crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0),
              flip_shared=False):
    """The draws the reference's device_augment makes from ``key``: its
    split into 10 keys and its uniform/randint calls, as port tensors."""
    (k_oy, k_ox, k_flip, k_jon, k_b, k_c, k_s, k_h, k_area,
     k_ar) = jax.random.split(key, 10)
    d = {}
    if ida.is_rrc(crop_scale, crop_ratio):
        area = jax.random.uniform(k_area, (b,), minval=crop_scale[0],
                                  maxval=crop_scale[1]) * (h * w)
        log_r = jax.random.uniform(k_ar, (b,), minval=jnp.log(crop_ratio[0]),
                                   maxval=jnp.log(crop_ratio[1]))
        ar = jnp.exp(log_r)
        cw = jnp.clip(jnp.sqrt(area * ar), 1.0, float(w))
        ch = jnp.clip(jnp.sqrt(area / ar), 1.0, float(h))
        d.update(ch=ch, cw=cw, oy=jax.random.uniform(k_oy, (b,)) * (h - ch),
                 ox=jax.random.uniform(k_ox, (b,)) * (w - cw))
    else:
        d["oy"] = jax.random.randint(k_oy, (b,), 0, h - out_hw + 1)
        d["ox"] = jax.random.randint(k_ox, (b,), 0, w - out_hw + 1)
    if hflip_prob > 0 and not flip_shared:
        d["flip"] = jax.random.uniform(k_flip, (b,)) < hflip_prob
    if jitter_prob > 0:
        d["on"] = (jax.random.uniform(k_jon, (b,))
                   < jitter_prob).astype(jnp.float32)
        for name, k, amount in (("brightness", k_b, jitter_brightness),
                                ("contrast", k_c, jitter_contrast),
                                ("saturation", k_s, jitter_saturation)):
            if amount > 0:
                d[name] = jax.random.uniform(k, (b,),
                                             minval=max(0.0, 1.0 - amount),
                                             maxval=1.0 + amount)
        if jitter_hue > 0:
            amp = min(jitter_hue, 0.5)
            d["hue"] = jax.random.uniform(k_h, (b,), minval=-amp, maxval=amp)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def jax_batch_draws(key, batch, cameras, out_hw, hflip_prob=0.0,
                    hflip_pose_mirror=False, **kwargs):
    """The reference's augment_batch_images draws: camera i from
    fold_in(key, i), the shared flip from fold_in(key, len(cameras))."""
    kwargs = {k: v for k, v in kwargs.items()
              if not k.startswith("hflip_mirror")}
    shared = hflip_pose_mirror and hflip_prob > 0
    out = {}
    for i, cam in enumerate(cameras):
        img = batch["images"][cam]
        out[cam] = jax_draws(jax.random.fold_in(key, i), img.shape[0],
                             img.shape[-3], img.shape[-2], out_hw,
                             hflip_prob=hflip_prob, flip_shared=shared,
                             **kwargs)
    if shared:
        b = batch["images"][cameras[0]].shape[0]
        flip = jax.random.uniform(jax.random.fold_in(key, len(cameras)),
                                  (b,)) < hflip_prob
        out["flip_mask"] = {"flip": torch.from_numpy(np.array(flip))}
    return out


AUG = dict(hflip_prob=0.5, jitter_brightness=0.3, jitter_contrast=0.3,
           jitter_saturation=0.3, jitter_prob=0.8)
RRC = dict(crop_scale=(0.5, 1.0), crop_ratio=(0.75, 1.333))


@pytest.mark.parametrize("t", [1, 3], ids=["T=1", "T=3"])
@pytest.mark.parametrize("crop", ["pad", "rrc"])
@pytest.mark.parametrize("hue", [0.0, 0.1], ids=["no hue", "hue"])
def test_device_augment_matches_the_reference(t, crop, hue):
    b, out, margin = 6, 24, 4
    h = out + 2 * margin
    rs = np.random.RandomState(t * 10 + len(crop))
    lead = (b, t) if t > 1 else (b,)
    img = rs.randint(0, 256, lead + (h, h, 3)).astype(np.uint8)
    kw = dict(AUG, jitter_hue=hue, **(RRC if crop == "rrc" else {}))
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key, b, h, h, out, **kw)
    # geometry and brightness, then the whole jitter
    for over, atol in (({"jitter_contrast": 0.0, "jitter_saturation": 0.0,
                         "jitter_hue": 0.0}, GEOMETRY_ATOL),
                       ({}, JITTER_ATOL)):
        args = dict(kw, **over)
        want = np.asarray(ref_aug.device_augment(key, jnp.asarray(img), out,
                                                 **args))
        got = ida.device_augment(torch.from_numpy(img), draws, out, **args)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # crop and flip alone are exact
    geo = dict(kw, jitter_prob=0.0)
    want = np.asarray(ref_aug.device_augment(key, jnp.asarray(img), out,
                                             **geo))
    got = ida.device_augment(torch.from_numpy(img), draws, out, **geo)
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_batch_images_mirrors_the_pose_as_the_reference():
    """Two cameras, one shared flip per sample, the label mirrored."""
    rs = np.random.RandomState(5)
    cams = ("agentview", "robot0_eye_in_hand")
    q = rs.randn(8, 4)
    batch = {"images": {c: rs.randint(0, 256, (8, 2, 32, 32, 3)).astype(
        np.uint8) for c in cams},
        "target_pos": rs.randn(8, 3).astype(np.float32),
        "target_quat": (q / np.linalg.norm(q, axis=1, keepdims=True)
                        ).astype(np.float32)}
    kw = dict(AUG, cameras=cams, out_hw=24, hflip_pose_mirror=True,
              hflip_mirror_axis=1, hflip_mirror_center=0.1, jitter_hue=0.05)
    key = jax.random.PRNGKey(11)
    want = ref_aug.augment_batch_images(
        key, jax.tree.map(jnp.asarray, batch), **kw)
    tbatch = {"images": {c: torch.from_numpy(v)
                         for c, v in batch["images"].items()},
              "target_pos": torch.from_numpy(batch["target_pos"]),
              "target_quat": torch.from_numpy(batch["target_quat"])}
    got = ida.augment_batch_images(
        tbatch, jax_batch_draws(key, batch, **kw), **kw)
    flips = jax_batch_draws(key, batch, **kw)["flip_mask"]["flip"]
    assert 0 < int(flips.sum()) < 8
    for k in ("target_pos", "target_quat"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for c in cams:
        np.testing.assert_allclose(got["images"][c].numpy(),
                                   np.asarray(want["images"][c]), rtol=0,
                                   atol=JITTER_ATOL)


def test_hue_rotate_matches_the_reference_at_sextant_boundaries():
    """Greys, primaries and the colours on each sextant's edge, shifted
    by amounts that land on and around the boundaries."""
    vals = np.array([0.0, 0.2, 0.5, 1.0], np.float32)
    rgb = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"),
                   -1).reshape(-1, 3)
    for shift in (0.0, 1 / 6, 0.5, -1 / 3, 0.25, -0.5):
        want = np.asarray(ref_aug.hue_rotate(jnp.asarray(rgb),
                                             jnp.float32(shift)))
        got = ida.hue_rotate(torch.from_numpy(rgb),
                             torch.tensor(shift, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=JITTER_ATOL, err_msg=str(shift))


def test_draws_on_a_rank_are_the_global_batchs_rows(monkeypatch):
    """On rank r of 2 the draws are rows r*b to (r+1)*b of the global
    batch's, so two ranks augment as one process does."""
    kw = dict(AUG, jitter_hue=0.1, **RRC)
    whole = ida.draw_device_aug(torch.Generator().manual_seed(3), 8, 40, 40,
                                32, **kw)
    for r in range(2):
        part = ida.draw_device_aug(torch.Generator().manual_seed(3), 4, 40,
                                   40, 32, first=4 * r, rows=8, **kw)
        assert part.keys() == whole.keys()
        for k, v in part.items():
            assert torch.equal(v, whole[k][4 * r:4 * r + 4]), k
    # the train step's wrapper reads the rank from the group
    batch = {"images": {"agentview": torch.zeros(4, 40, 40, 3,
                                                 dtype=torch.uint8)}}
    monkeypatch.setattr(dist, "rank", lambda: 1)
    monkeypatch.setattr(dist, "world", lambda: 2)
    seen = {}
    real = ida.draw_batch_aug

    def spy(generator, batch, first, rows, **kwargs):
        seen.update(first=first, rows=rows)
        return real(generator, batch, first=first, rows=rows, **kwargs)

    monkeypatch.setattr(ida, "draw_batch_aug", spy)
    aug = {"cameras": ("agentview",), "out_hw": 32, **AUG}
    out = port_step.augment_on_device(batch, aug,
                                      torch.Generator().manual_seed(0))
    assert seen == {"first": 4, "rows": 8}
    assert out["images"]["agentview"].shape == (4, 32, 32, 3)


def test_augmentation_streams_are_the_steps_and_apart_from_dropout():
    dev = torch.device("cpu")
    draws = [torch.rand(4, generator=g) for g in (
        port_step.aug_generator(0, 5, dev),
        port_step.aug_generator(0, 5, dev),
        port_step.aug_generator(0, 6, dev),
        port_step.dropout_generator(0, 5, dev),
        port_step.recal_aug_generator(0, 5, dev),
        port_step.recal_generator(0, 5, dev))]
    assert torch.equal(draws[0], draws[1])
    for other in draws[2:]:
        assert not torch.equal(draws[0], other)
    assert not torch.equal(draws[4], draws[5])


# ---------------------------------------------------------------------------
# the upload
# ---------------------------------------------------------------------------


def test_upload_budget_refusal_and_skipped_cameras(demo_h5):
    _, cfg = _data_cfg(demo_h5, **{"data.device_cache": True,
                                   "model.cameras": ("agentview",
                                                     "robot0_eye_in_hand")})
    store = build_dataset(cfg)
    frames = int(store.frames_per_demo().sum())
    cache = loop.upload_image_cache(store, 32, torch.device("cpu"))
    assert sorted(cache) == ["agentview", "robot0_eye_in_hand"]
    assert cache["agentview"].shape == (frames, 32, 32, 3)
    assert cache["agentview"].dtype == torch.uint8
    host = store.build_resized_cache(32)
    assert np.array_equal(cache["robot0_eye_in_hand"].numpy(),
                          host["robot0_eye_in_hand"])
    one = loop.upload_image_cache(store, 32, torch.device("cpu"),
                                  skip_cameras=("robot0_eye_in_hand",))
    assert sorted(one) == ["agentview"]
    need = 2 * frames * 32 * 32 * 3
    with pytest.raises(ValueError, match="data.device_cache: resized frames"):
        loop.upload_image_cache(store, 32, torch.device("cpu"),
                                budget_bytes=need - 1)
    # a skipped camera is out of the budget too
    loop.upload_image_cache(store, 32, torch.device("cpu"),
                            budget_bytes=need // 2,
                            skip_cameras=("agentview",))
    # a sharded rank uploads and budgets its shard alone
    plan = cache_shard.build_shard_plan(store.frames_per_demo(), 2)
    for r in range(2):
        part = loop.upload_image_cache(store, 32, torch.device("cpu"),
                                       plan=plan, rank=r,
                                       budget_bytes=plan.per_device_bytes(
                                           32, 2))
        rows = plan.frame_of_row[r * plan.rows_per_shard:
                                 (r + 1) * plan.rows_per_shard]
        assert np.array_equal(part["agentview"].numpy(),
                              host["agentview"][rows])
    assert loop.device_cache_budget() > 0


# ---------------------------------------------------------------------------
# fits against the JAX package's
# ---------------------------------------------------------------------------


def _fit_pair(demo_h5, tmp_path, **overrides):
    """jax fit and the port's train_on from the JAX package's initial
    weights on the same fixture, logging every step, one eval at the
    end; returns (JAX result, port result, JAX config, port config)."""
    over = {"train.steps": FIT_STEPS, "train.steps_per_call": 1,
            "train.log_every": 1, "train.eval_every": FIT_STEPS,
            "train.eval_steps": 2, "train.ckpt_every": 0, **overrides}
    jcfg, _ = _data_cfg(demo_h5, **over, **{
        "train.ckpt_dir": str(tmp_path / "jax")})
    _, cfg = _data_cfg(demo_h5, **over, **{
        "train.ckpt_dir": str(tmp_path / "port")})
    want = jax_fit(jcfg)
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    state = create_state(cfg, torch.device("cpu"), state_dict_from_jax(
        jax.tree.map(np.asarray, init), cfg.model))
    dataset = build_dataset(cfg)
    got = loop.train_on(cfg, state, dataset, dataset)
    return want, got, jcfg, cfg


def _metrics(ckpt_dir, key):
    import json
    import os

    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _assert_fit_close(want, got, jcfg, cfg):
    for key in ("train/loss", "eval/loss"):
        w = _metrics(jcfg.train.ckpt_dir, key)
        g = _metrics(cfg.train.ckpt_dir, key)
        assert len(g) == len(w) > 0, key
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, err_msg=key)
    st = want["state"]
    ref = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, st.params),
         "batch_stats": jax.tree.map(np.asarray, st.batch_stats)},
        cfg.model)
    for k, p in got["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_fit_with_the_device_cache_matches_the_reference(demo_h5, tmp_path,
                                                         monkeypatch):
    """Replicated cache, no augmentation: the steps gather the cached
    frames, and every step's batch equals the host pipeline's."""
    seen = []
    gather = loop.gather_cached_images

    def counted(cache, batch):
        seen.append(batch["image_idx"].shape)
        return gather(cache, batch)

    monkeypatch.setattr(port_step, "gather_cached_images", counted)
    monkeypatch.setattr(loop, "gather_cached_images", counted)
    want, got, jcfg, cfg = _fit_pair(demo_h5, tmp_path, **{
        "data.device_cache": True})
    # three train steps and two eval batches gathered from the cache
    assert len(seen) == FIT_STEPS + 2
    _assert_fit_close(want, got, jcfg, cfg)


AUG_FIT = {"data.device_cache": True, "data.augment": True,
           "data.augment_device": True, "data.crop_margin": 4,
           "data.hflip_prob": 0.5, "data.hflip_pose_mirror": True,
           "data.jitter_hue": 0.05}


@pytest.mark.parametrize("cache", [True, False],
                         ids=["device cache", "host frames"])
def test_fit_with_augment_device_matches_the_reference(demo_h5, tmp_path,
                                                       monkeypatch, cache):
    """The device augmentation's draws are replaced by the reference's
    own, fold_in(rng, step) for step 0, 1, 2: the same pixels and labels
    reach the same steps, from the cache or from host-resized frames."""
    jcfg, _ = _data_cfg(demo_h5, **AUG_FIT)
    rng = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                           seed=jcfg.train.seed).rng
    steps = []

    def reference_draws(generator, batch, first, rows, **kwargs):
        key = jax.random.fold_in(rng, len(steps))
        steps.append(first)
        return jax_batch_draws(key, batch, **kwargs)

    monkeypatch.setattr(ida, "draw_batch_aug", reference_draws)
    want, got, jcfg, cfg = _fit_pair(demo_h5, tmp_path, **{
        **AUG_FIT, "data.device_cache": cache})
    assert steps == [0] * FIT_STEPS
    _assert_fit_close(want, got, jcfg, cfg)


def test_resume_under_augment_device_equals_the_straight_run(demo_h5,
                                                             tmp_path):
    """A run cut at step 2 and resumed draws the straight run's
    augmentations: the same model and sampler state, bit for bit."""
    over = {**AUG_FIT, "train.steps": 4, "train.log_every": 1,
            "train.eval_every": 0, "train.ckpt_every": 2,
            "train.ema_decay": 0.5, "train.ema_bn_recal_batches": 1}
    _, cfg = _data_cfg(demo_h5, **over)
    straight = api.train(cfg.override(**{
        "train.ckpt_dir": str(tmp_path / "straight")}), device="cpu")
    cut = cfg.override(**{"train.ckpt_dir": str(tmp_path / "cut"),
                          "train.steps": 2, "train.ema_bn_recal_batches": 0})
    api.train(cut, device="cpu")
    resumed = api.train(cut.override(**{"train.steps": 4,
                                        "train.ema_bn_recal_batches": 1}),
                        device="cpu")
    _, sd_s, tr_s = checkpoint.load_training(straight["ckpt_path"])
    _, sd_r, tr_r = checkpoint.load_training(resumed["ckpt_path"])
    assert tr_s["step"] == tr_r["step"] == 4
    assert tr_s["pipeline"] == tr_r["pipeline"]
    for k in sd_s:
        assert torch.equal(sd_s[k], sd_r[k]), k


def test_recalibration_augments_from_its_own_stream(demo_h5, monkeypatch):
    """BN recalibration gathers and augments each batch on the device,
    from recal_aug_generator(seed, i), which restarts at 0 each time."""
    _, cfg = _data_cfg(demo_h5, **AUG_FIT)
    store = build_dataset(cfg)
    cache = loop.upload_image_cache(store, 40, torch.device("cpu"))
    pipe = HostPipeline(store, cfg.data, device="cpu", train=True)
    batches = [next(pipe) for _ in range(2)]
    pipe.close()
    made = []
    real = port_step.recal_aug_generator

    def spy(seed, i, device):
        made.append(i)
        return real(seed, i, device)

    monkeypatch.setattr(port_step, "recal_aug_generator", spy)
    model = create_state(cfg, torch.device("cpu")).model
    aug = port_step.device_aug_of(cfg)
    a = port_step.recalibrate_batch_stats(model, iter(batches), 0, cache, aug)
    b = port_step.recalibrate_batch_stats(model, iter(batches), 0, cache, aug)
    assert made == [0, 1, 0, 1]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # by hand: gather, augment with stream 2, train-mode forward
    prepared = port_step.prepare_batch(batches[0], cache, aug,
                                       real(0, 0, torch.device("cpu")))
    assert prepared["images"]["agentview"].dtype == torch.float32
    assert prepared["images"]["agentview"].shape == (BATCH, 32, 32, 3)


def test_evaluate_with_the_cache_equals_without(demo_h5, tmp_path):
    _, cfg = _data_cfg(demo_h5, **{"train.steps": 2,
                                   "train.eval_every": 0,
                                   "train.ckpt_dir": str(tmp_path)})
    api.train(cfg, device="cpu")
    want = api.evaluate(cfg, device="cpu", percentiles=True)
    cached = cfg.override(**{"data.device_cache": True})
    got = api.evaluate(cached, device="cpu", percentiles=True)
    assert got.keys() == want.keys()
    for k in ("loss", "pos_mae_cm", "rot_mae_deg"):
        assert got[k] == want[k], k
    assert got["pos_err_cm"] == want["pos_err_cm"]


def test_sharded_cache_on_two_ranks_matches_the_jax_two_device_mesh(
        demo_h5, tmp_path):
    """data.cache_layout="sharded" with two gloo ranks (api.train
    launches them), each holding its shard of the frames, against the
    JAX package's fit on a 2-device mesh with the same layout: the same
    global batches, losses and parameters. train.seed 1: at the default
    seed 0 one ReLU input of block 1 lies within rounding of 0 and takes
    the other side in one of the two (its channel's weights then differ
    by 4%, every other channel's by 1e-4 of its update)."""
    over = {"data.device_cache": True, "data.cache_layout": "sharded",
            "dist.num_devices": 2, "train.steps": FIT_STEPS,
            "train.seed": 1,
            "train.steps_per_call": 1, "train.log_every": 1,
            "train.eval_every": FIT_STEPS, "train.eval_steps": 2,
            "train.ckpt_every": 0}
    jcfg, _ = _data_cfg(demo_h5, **over, **{
        "train.ckpt_dir": str(tmp_path / "jax")})
    _, cfg = _data_cfg(demo_h5, **over, **{
        "train.ckpt_dir": str(tmp_path / "port")})
    want = jax_fit(jcfg)
    # the port starts from the JAX package's initial weights: a warm
    # start from a checkpoint of them
    init = jax_create_state(jcfg, jax_make_optimizer(jcfg.train),
                            seed=jcfg.train.seed).variables()
    sd = state_dict_from_jax(jax.tree.map(np.asarray, init), cfg.model)
    checkpoint.save_step(str(tmp_path / "init"), 0, 1, cfg, sd,
                         {"step": 0})
    got = api.train(cfg.override(**{"train.init_from": str(
        tmp_path / "init")}), device="cpu")
    _assert_fit_close(want, got, jcfg, cfg)
    rows = _metrics(cfg.train.ckpt_dir, "train/loss")
    assert len(rows) == FIT_STEPS

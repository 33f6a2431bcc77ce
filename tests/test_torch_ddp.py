"""Data parallelism of the port (``parallel/dist.py``) on the CPU: two gloo
ranks, one intra-op thread each, meeting at a ``file://`` store, against
the port's one-process step and the JAX package's step on a 2-device mesh
(the pattern of tests/test_distributed.py), with a tiny ResNet-18 at 32 px,
global batch 8, in f32.

The ranks are new processes started by ``parallel.dist.launch`` (spawn);
their target is the port's (``dist.run_steps``, ``engine/loop.fit``,
``api.evaluate``), so they import no JAX. A launch's results are shared by
the test workers of one pytest run through a locked file, so that each
runs once.

Tolerances are the reference's data-parallel ones
(tests/test_distributed.py): loss rtol 1e-5, parameters rtol 2e-5 atol
2e-6 after three SGD steps (SGD: the update is linear in the gradient,
so the comparison is well-conditioned at a small learning rate)."""

import fcntl
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.state import (
    create_state as jax_create_state,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_train_step as jax_make_train_step,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.parallel import mesh as pmesh
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import (
    check_fit_supported,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import native
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
# a gradient, as tests/test_torch_train.py holds one: 1e-4 of the tensor's
# largest magnitude (f32 sums in other orders, with cancellation in the
# stem's); the dgamma/dbeta trap would be off by 0.5 of it
GRAD_REL = 1e-4
# a running statistic: two f32 sums of the same values in other orders
STATS_REL = 1e-5
STEPS = 3
BATCH = 8
CPU2 = ["cpu", "cpu"]
ROUTES = ["reduce", "matmul"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here, and so one in each launched rank, from
    before the module's fixtures run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shared(tmp_path_factory, name, make):
    """``make()``, computed once per pytest run and shared by the xdist
    workers through a file under the run's base temporary directory. One
    lock serves every name, so that one worker at a time launches ranks:
    the ranks of several launches at once would crowd the CPU cores that
    the other workers' tests share (XLA:CPU's collectives abort when they
    wait too long)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return make()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"ddp_{name}.pt"
    with open(root / "ddp_launch.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            torch.save(make(), str(path) + ".tmp")
            os.replace(str(path) + ".tmp", path)
    return torch.load(path, weights_only=False)


def _cfgs(name="pr3", **overrides):
    """(JAX config, port config): ``name`` at 32 px, f32, global batch 8,
    SGD at lr 1e-3 without clipping, on 2 devices. (At lr 1e-2 three steps
    of ResNet-18 on 8 samples are chaotic: a relative change of 1e-7 in
    the initial weights of one process moves the stem's weights by 6% of
    their largest.)"""
    dotted = {"model.image_size": 32, "model.dtype": "float32",
              "data.batch_size": BATCH, "train.optimizer": "sgd",
              "train.lr": 1e-3, "train.grad_clip": 0.0,
              "train.weight_decay": 0.0, "train.lr_schedule": "constant",
              "train.warmup_steps": 0, "dist.num_devices": 2, **overrides}
    jcfg = jax_preset(name).override(**dotted)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _batches(model_cfg, seed, n=STEPS):
    """``n`` seeded numpy global batches of BATCH samples."""
    rs = np.random.RandomState(seed)
    t, hw = model_cfg.temporal_frames, model_cfg.image_size
    lead = (BATCH, t) if t > 1 else (BATCH,)
    out = []
    for _ in range(n):
        q = rs.randn(BATCH, 4)
        b = {"images": {c: rs.randint(0, 256, lead + (hw, hw, 3), np.uint8)
                        for c in model_cfg.cameras},
             "proprio": rs.randn(*lead, model_cfg.proprio_dim).astype(
                 np.float32),
             "target_pos": rs.uniform(-0.3, 0.3, (BATCH, 3)).astype(
                 np.float32),
             "target_quat": (q / np.linalg.norm(q, axis=1, keepdims=True)
                             ).astype(np.float32)}
        out.append(b)
    return out


def _case(name="pr3", seed=64, **overrides):
    """A step case: weights and batches from seeds at which no ReLU input
    of the three steps lies within rounding of 0. (One that does takes the
    other side in another implementation or partition of the batch, and
    moves its BatchNorm channel's gradients by percents: at three of five
    seed pairs tried for pr3, the JAX package's 1- and 2-device steps
    differ by more than the tolerance themselves.)"""
    jcfg, cfg = _cfgs(name, **overrides)
    variables = jax.tree.map(np.asarray, random_jax_variables(cfg.model,
                                                              seed=seed))
    return {"jcfg": jcfg, "cfg": cfg, "variables": variables,
            "batches": _batches(cfg.model, seed=seed + 1)}


def _step_runs():
    """Each case's steps on two ranks, all in one launch (a launch's
    processes take seconds to start), and in this process alone, here
    while the ranks run. The remat case's ranks recompute every block in
    the backward, BatchNorm all-reduces included; it is held against the
    plain one-process step, which takes the same values."""
    cases = {route: _case(**{"model.bn_stats": route}) for route in ROUTES}
    cases["reduce, remat"] = _case(**{"model.bn_stats": "reduce",
                                      "model.remat": True})
    # two cameras, T = 2 through ResNet-18 and an LSTM, camera dropout 0.5
    cases["pr5"] = _case("pr5", **{"model.temporal_frames": 2,
                                   "model.image_features": 32,
                                   "model.camera_dropout": 0.5})
    for c in cases.values():
        c["state_dict"] = state_dict_from_jax(c["variables"],
                                              c["cfg"].model)
    calls = [(dist.run_steps, c["cfg"], (c["state_dict"], c["batches"]))
             for c in cases.values()]
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(dist.launch, dist.run_each, calls, CPU2,
                               "gloo")
        one = {name: dist.run_steps(
            c["cfg"].override(**{"dist.num_devices": 1}), "cpu",
            c["state_dict"], c["batches"])
            for name, c in cases.items() if name != "reduce, remat"}
        ranks = launched.result()
    one["reduce, remat"] = one["reduce"]
    return {name: {**c, "name": name, "one": one[name],
                   "ranks": [r[i] for r in ranks]}
            for i, (name, c) in enumerate(cases.items())}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    return _shared(tmp_path_factory, "steps", _step_runs)


@pytest.fixture(params=ROUTES + ["reduce, remat"])
def pr3_runs(request, step_runs):
    return step_runs[request.param]


def _assert_params_close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {k}")


def _rel_err(got, want):
    return (np.abs(got - want).max()
            / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the step: 2 ranks against one process and against the JAX mesh
# ---------------------------------------------------------------------------


def test_two_ranks_match_one_process(pr3_runs):
    one, ranks = pr3_runs["one"], pr3_runs["ranks"]
    for r in ranks:
        for got, want in zip(r["losses"], one["losses"]):
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=LOSS_RTOL)
    params = dict(PoseEstimator(pr3_runs["cfg"].model).named_parameters())
    want = {k: v for k, v in one["state_dict"].items() if k in params}
    _assert_params_close(ranks[0]["state_dict"], want, pr3_runs["name"])
    # DDP keeps the replicas equal bit for bit
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


@pytest.mark.parametrize("route", ROUTES)
def test_two_ranks_match_jax_two_device_mesh(route, step_runs):
    pr3_runs = step_runs[route]
    jcfg = pr3_runs["jcfg"]
    variables = pr3_runs["variables"]
    tx = jax_make_optimizer(jcfg.train)
    step = jax_make_train_step(build_model(jcfg.model), tx, jcfg.train)
    mesh = pmesh.make_mesh(2)
    state = jax_create_state(jcfg, tx, seed=0)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    state = jax.device_put(state, pmesh.replicated_sharding(mesh))
    losses = []
    for b in pr3_runs["batches"]:
        db = pmesh.shard_batch(b, pmesh.batch_sharding(mesh))
        state, metrics = step(state, db)
        losses.append(float(metrics["loss"]))
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, state.params),
         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
        pr3_runs["cfg"].model)
    got = pr3_runs["ranks"][0]
    np.testing.assert_allclose([m["loss"] for m in got["losses"]], losses,
                               rtol=LOSS_RTOL)
    params = dict(PoseEstimator(pr3_runs["cfg"].model).named_parameters())
    _assert_params_close(got["state_dict"],
                         {k: v for k, v in want.items() if k in params},
                         f"{route} against JAX")


def test_two_ranks_gradients_before_the_update_match_one_process(pr3_runs):
    """The first step's gradients after DDP's average, before the
    optimizer: on the matmul route bn_train must return each rank's own
    dgamma and dbeta (global sums would come out twice as large)."""
    want = pr3_runs["one"]["grads"]
    for r in pr3_runs["ranks"]:
        got = r["grads"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            err = _rel_err(got[k].numpy(), w.numpy())
            assert err <= GRAD_REL, (pr3_runs["name"], k, err)


def test_running_stats_equal_on_ranks_and_the_global_batchs(pr3_runs):
    want = pr3_runs["one"]["state_dict"]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20           # ResNet-18's 20 BatchNorms
    r0, r1 = (r["state_dict"] for r in pr3_runs["ranks"])
    for k in stats:
        assert torch.equal(r0[k], r1[k]), k
        assert _rel_err(r0[k].numpy(), want[k].numpy()) <= STATS_REL, k


def test_pr5_like_step_with_camera_dropout_matches_one_process(step_runs):
    """Two cameras, T = 2 through ResNet-18 and an LSTM, camera dropout
    0.5: each rank draws the global batch's masks and keeps its rows, so
    the two ranks take the one-process steps."""
    runs = step_runs["pr5"]
    cfg, one, (r0, r1) = runs["cfg"], runs["one"], runs["ranks"]
    for got, want in zip(r0["losses"], one["losses"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    params = dict(PoseEstimator(cfg.model).named_parameters())
    assert any(k.startswith("lstm_") for k in params)
    _assert_params_close(r0["state_dict"],
                         {k: v for k, v in one["state_dict"].items()
                          if k in params}, "pr5")
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k


def test_camera_dropout_draws_the_global_mask_and_keeps_a_ranks_rows(
        monkeypatch):
    _, cfg = _cfgs("pr5", **{"model.temporal_frames": 2,
                             "model.image_features": 32,
                             "model.camera_dropout": 0.5,
                             "model.use_proprio": False})
    model = PoseEstimator(cfg.model)
    images = {c: None for c in model.cameras}
    # 0.5 and no proprio: rows whose cameras all drop get one back
    want = model._dropout_mask({}, images, BATCH,
                               torch.Generator().manual_seed(5))
    assert torch.all(want.sum(1) >= 1) and torch.any(want == 0)
    per = BATCH // 2
    for r in range(2):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        monkeypatch.setattr(dist, "world", lambda: 2)
        got = model._dropout_mask({}, images, per,
                                  torch.Generator().manual_seed(5))
        assert torch.equal(got, want[r * per:(r + 1) * per]), r


# ---------------------------------------------------------------------------
# the host pipeline: rank slices of the global batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dualcam_h5(tmp_path_factory):
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("ddp_demo") / "dualcam.hdf5"),
        n_demos=3, steps=20, cameras=("agentview", "robot0_eye_in_hand"),
        image_hw=40, seed=0)


def _pipeline_cfg(kind, path):
    if kind == "synthetic":
        return Config.from_dict(jax_preset("pr1").override(**{
            "data.synthetic_size": 64, "data.batch_size": BATCH,
            "data.num_workers": 2}).to_dict())
    over = {"data.path": path, "data.batch_size": BATCH,
            "data.num_workers": 2, "model.image_size": 32,
            "data.use_native": kind != "hdf5 numpy",
            "data.jitter_prob": 0.8, "data.crop_scale": (0.8, 1.0)}
    if kind == "hdf5 temporal":
        # pr5la's reader: two cameras of 3 frames, labels 6 steps ahead
        return Config.from_dict(jax_preset("pr5la").override(**over)
                                .to_dict())
    return Config.from_dict(jax_preset("pr3").override(
        **{**over, "model.cameras": ("agentview", "robot0_eye_in_hand"),
           "data.hflip_prob": 0.5, "data.hflip_pose_mirror": True})
        .to_dict())


def _leaves(batch, prefix=""):
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v.numpy()


@pytest.mark.parametrize("kind", ["synthetic", "hdf5 numpy", "hdf5 native",
                                  "hdf5 temporal"])
def test_pipeline_rank_slices_are_the_global_batchs_rows(kind, dualcam_h5,
                                                          request):
    cfg = _pipeline_cfg(kind, dualcam_h5)
    dataset = build_dataset(cfg)
    if kind != "synthetic":
        assert cfg.data.augment
        backend = "native" if native.available() and cfg.data.use_native \
            else "numpy"
        assert backend == ("numpy" if kind == "hdf5 numpy" else "native"), (
            f"augments with {backend}")
    pipes = [HostPipeline(dataset, cfg.data, train=True, rank=r, world=w)
             for r, w in ((0, 1), (0, 2), (1, 2))]
    try:
        for _ in range(5):                           # over an epoch boundary
            whole, *parts = (dict(_leaves(next(p))) for p in pipes)
            assert sorted(parts[0]) == sorted(whole)
            for k, w in whole.items():
                got = np.concatenate([p[k] for p in parts])
                assert got.dtype == w.dtype and got.shape == w.shape, k
                np.testing.assert_array_equal(got, w, err_msg=k)
        states = [p.state_dict() for p in pipes]
        assert states[0] == states[1] == states[2]
    finally:
        for p in pipes:
            p.close()


# ---------------------------------------------------------------------------
# fit, resume and evaluate at dist.num_devices=2
# ---------------------------------------------------------------------------


def _fit_cfg(path, ckpt_dir, steps, **overrides):
    """pr2 (CNNSmall) at 32 px on the demo fixture, global batch 8, SGD,
    an eval every 2 steps on a held-out demo, the best checkpoint kept."""
    return Config.from_dict(jax_preset("pr2").override(**{
        "model.image_size": 32, "data.path": path, "data.batch_size": BATCH,
        "data.num_workers": 2, "data.val_fraction": 0.34,
        "train.optimizer": "sgd", "train.lr": 1e-2, "train.steps": steps,
        "train.steps_per_call": 1, "train.log_every": 1,
        "train.eval_every": 2, "train.eval_steps": 2, "train.ckpt_every": 2,
        "train.ckpt_best_metric": "loss", "train.ckpt_dir": ckpt_dir,
        "dist.num_devices": 2, **overrides}).to_dict())


def _fit_runs(path, root):
    """api.train at N=2, straight for 4 steps; cut at 2 and resumed, in
    one launch of fit_rank (the ranks rebuild everything from the
    checkpoint); api.train at N=1."""
    cut = _fit_cfg(path, f"{root}/resumed", 2)
    out = {"straight": api.train(_fit_cfg(path, f"{root}/straight", 4),
                                 device="cpu")}
    out["cut"], out["resumed"] = dist.launch(
        dist.run_each, [(loop.fit_rank, cut, ()),
                        (loop.fit_rank, cut.override(**{"train.steps": 4}),
                         ())], CPU2, "gloo")[0]
    out["one"] = api.train(_fit_cfg(path, f"{root}/one", 4, **{
        "dist.num_devices": 1}), device="cpu")
    for k in ("straight", "one"):
        v = out[k]
        out[k] = {"metrics": v["metrics"], "ckpt_path": v["ckpt_path"],
                  "ckpt_dir": v["ckpt_dir"], "step": v["state"].step,
                  "state_dict": v["model"].state_dict()}
    return out


@pytest.fixture(scope="module")
def fits(dualcam_h5, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_fit"))
    return _shared(tmp_path_factory, "fits",
                   lambda: _fit_runs(dualcam_h5, root))


def _metric_rows(ckpt_dir):
    import json

    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_two_ranks_resume_equals_straight_and_rank0_writes(fits):
    s, r = fits["straight"], fits["resumed"]
    assert s["step"] == 4
    assert fits["cut"]["ckpt_path"].endswith("step_00000002.pt")
    assert s["ckpt_path"].endswith("step_00000004.pt")
    _, sd_s, tr_s = checkpoint.load_training(s["ckpt_path"])
    _, sd_r, tr_r = checkpoint.load_training(r["ckpt_path"])
    assert tr_s["step"] == tr_r["step"] == 4
    for k in sd_s:
        assert torch.equal(sd_s[k], sd_r[k]), k
        # the state returned is the final checkpoint's
        assert torch.equal(s["state_dict"][k], sd_s[k]), k
    assert tr_s["pipeline"] == tr_r["pipeline"]
    assert tr_s["pipeline"]["consumed"] == 4
    for i, st in tr_s["optimizer"]["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, tr_r["optimizer"]["inner"]["state"][i][k])
    # one writer: each step logged once, no temporary file left behind,
    # the best checkpoint alone in best/
    rows = _metric_rows(s["ckpt_dir"])
    train_steps = [row["step"] for row in rows if "train/loss" in row]
    assert train_steps == [1, 2, 3, 4]
    assert [row["step"] for row in rows if "eval/loss" in row] == [2, 4]
    assert sorted(os.listdir(s["ckpt_dir"])) == [
        "best", "metrics.jsonl", "step_00000002.pt", "step_00000004.pt"]
    assert len(os.listdir(os.path.join(s["ckpt_dir"], "best"))) == 1
    last = [row for row in rows if "train/loss" in row][-1]
    assert last["train/images_per_sec_per_chip"] == pytest.approx(
        last["train/images_per_sec"] / 2)


def test_fit_two_ranks_logs_the_one_device_losses(fits):
    """The global batch's losses: each rank's half averaged."""
    two = _metric_rows(fits["straight"]["ckpt_dir"])
    one = _metric_rows(fits["one"]["ckpt_dir"])
    assert len(two) == len(one)
    for a, b in zip(two, one):
        for k in ("train/loss", "eval/loss", "eval/pos_mae_cm"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                           err_msg=f"step {b['step']} {k}")


def test_evaluate_two_ranks_equals_one(fits, dualcam_h5, tmp_path_factory):
    cfg = _fit_cfg(dualcam_h5, fits["straight"]["ckpt_dir"], 4)
    got = _shared(tmp_path_factory, "evaluate",
                  lambda: api.evaluate(cfg, device="cpu"))
    want = api.evaluate(cfg.override(**{"dist.num_devices": 1}),
                        device="cpu")
    assert sorted(got) == sorted(want) and got["step"] == 4
    for k in ("loss", "pos_mae_cm", "rot_mae_deg"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# a launching process that trains pr1 at dist.num_devices=2 on the CPU
# for longer than any test waits, and prints what api.train returned
SIGTERM_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import preset
out = api.train(preset("pr1").override(**json.loads(sys.argv[1])),
                device="cpu")
print(json.dumps({"metrics": out["metrics"], "ckpt_path": out["ckpt_path"],
                  "step": out["state"].step}))
"""


def _train_until_sigterm(ckpt_dir):
    """Start SIGTERM_SCRIPT, send SIGTERM to it (the process a user or a
    scheduler started, not its ranks) once rank 0 has logged 3 steps, and
    return its exit code, its last line and its standard error. Whatever
    is left of its process group is killed."""
    import json
    import signal
    import subprocess
    import sys
    import time

    over = {"data.synthetic_size": 64, "data.batch_size": BATCH,
            "data.num_workers": 0, "train.steps": 1_000_000,
            "train.log_every": 1, "train.eval_every": 0,
            "train.ckpt_every": 0, "train.save_on_signal": True,
            "train.ckpt_dir": ckpt_dir, "dist.num_devices": 2}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", SIGTERM_SCRIPT, json.dumps(over)], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        metrics = os.path.join(ckpt_dir, "metrics.jsonl")
        deadline = time.monotonic() + 120
        while proc.poll() is None and time.monotonic() < deadline:
            if os.path.exists(metrics):
                with open(metrics) as f:
                    if len(f.readlines()) >= 3:
                        break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, (out.strip().splitlines() or [""])[-1], err


def test_sigterm_to_the_launching_process_checkpoints_one_step(
        tmp_path_factory):
    """train.save_on_signal at N=2: the launcher passes SIGTERM on to the
    ranks, which stop at one step, checkpoint it and return it."""
    import json

    ckpt_dir = str(tmp_path_factory.mktemp("ddp_sigterm") / "run")
    rc, last, err = _shared(tmp_path_factory, "sigterm",
                            lambda: _train_until_sigterm(ckpt_dir))
    assert rc == 0, err[-4000:]
    out = json.loads(last)
    stop = out["metrics"]["preempted_at"]
    assert 3 <= stop < 1_000_000 and out["step"] == stop
    assert out["ckpt_path"].endswith(f"step_{int(stop):08d}.pt")
    assert checkpoint.steps(os.path.dirname(out["ckpt_path"])) == [stop]
    assert checkpoint.load_training(out["ckpt_path"])[2]["step"] == stop
    rows = _metric_rows(os.path.dirname(out["ckpt_path"]))
    assert [r["step"] for r in rows if "train/preempted_at" in r] == [stop]


@pytest.mark.parametrize("raises", [False, True],
                         ids=["returns", "a rank raises"])
def test_launch_leaves_no_process_behind(raises):
    """Once launch returns or raises, the ranks are reaped and so is the
    resource tracker that spawning them starts (Python 3.12.3 stops it
    only at the launching process's exit, after that process ends)."""
    before = set(dist.child_processes())
    # both ranks first finish a collective (all_gather_object of their
    # devices), so each has joined the group before either raises; then
    # barrier, which takes no arguments, raises a TypeError on each rank
    calls = [(tdist.all_gather_object, [None, None], ()),
             (dist.barrier, None, ())] if raises else []
    if raises:
        with pytest.raises(Exception, match="TypeError"):
            dist.launch(dist.run_each, calls, ["cpu", "cpu"], "gloo")
    else:
        assert dist.launch(dist.run_each, calls, ["cpu", "cpu"],
                           "gloo") == [[], []]
    assert set(dist.child_processes()) <= before


# ---------------------------------------------------------------------------
# refusals and the device count
# ---------------------------------------------------------------------------


def test_pallas_statistics_on_two_devices_raise_the_references_error():
    _, cfg = _cfgs(**{"model.bn_stats": "pallas"})
    with pytest.raises(ValueError, match="single-device only .got "
                                         "2-device mesh"):
        check_fit_supported(cfg, 2)
    with pytest.raises(ValueError, match="single-device only"):
        api.train(cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        check_fit_supported(cfg.override(**{"model.bn_stats": "reduce"}), 3)


def test_multihost_is_refused_naming_its_roadmap_item():
    """Multihost (item 8g) is in the port; what it refuses, with a
    ValueError naming the field: a device count (the reference's
    make_mesh refusal), an empty coordinator, and a process_id outside
    [0, num_processes)."""
    _, cfg = _cfgs(**{"dist.multihost": True, "dist.num_processes": 2,
                      "dist.coordinator": "127.0.0.1:1"})
    with pytest.raises(ValueError, match="dist.num_devices is "
                                         "single-process only"):
        api.train(cfg, device="cpu")
    cfg = cfg.override(**{"dist.num_devices": 0})
    assert dist.resolve_num_devices(cfg, "cpu") == 2
    for field, value, match in (
            ("dist.coordinator", "", "dist.coordinator"),
            ("dist.process_id", 2, "dist.process_id=2 is outside")):
        bad = cfg.override(**{field: value})
        with pytest.raises(ValueError, match=match):
            dist.resolve_num_devices(bad, "cpu")
        with pytest.raises(ValueError, match=match):
            api.train(bad, device="cpu")


def test_more_devices_than_visible_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        dist.resolve_num_devices(cfg, "cuda")
    assert dist.resolve_num_devices(
        cfg.override(**{"dist.num_devices": 0}), "cuda") == 1
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        dist.launch(dist.run_steps, cfg, ["cuda:0", "cuda:0"], "nccl")


def test_zero_devices_means_one_on_the_cpu():
    _, cfg = _cfgs(**{"dist.num_devices": 0})
    assert dist.resolve_num_devices(cfg, "cpu") == 1
    assert dist.resolve_num_devices(
        cfg.override(**{"dist.num_devices": 2}), "cpu") == 2
    assert dist.world() == 1 and dist.rank() == 0

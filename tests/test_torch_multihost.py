"""Training across hosts (``dist.multihost``, ``parallel/dist.launch_host``)
on the CPU: two host processes, each the launcher of one gloo rank, meet
at a coordinator on ``tcp://127.0.0.1`` and train as global ranks 0 and
1. They are held bit for bit against the two-rank launch of one host
(``dist.num_devices=2``) and, within the data-parallel tolerance of
tests/test_torch_ddp.py (loss rtol 1e-5), against one process; every
global rank's rows are held against the JAX package's multi-process
pipeline branch, with ``jax.process_count``/``process_index`` patched in
the test.

The fits run pr2 (CNNSmall) at 32 px on a two-camera demo fixture, global
batch 8, ``train.grad_accum`` 2 with a checkpoint mid-accumulation, the
EMA, an eval every 2 steps and the best checkpoint."""

import fcntl
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.data import pipeline as jax_pipeline
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

LOSS_RTOL = 1e-5
BATCH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one host: trains per the config in argv[1] on the CPU, saves the state
# its api.train returned to argv[2], prints what it returned
HOST_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
out = api.train(Config.from_dict(json.loads(sys.argv[1])), device="cpu")
torch.save({"state_dict": out["model"].state_dict(), "ema": out["state"].ema},
           sys.argv[2])
print(json.dumps({"metrics": out["metrics"], "ckpt_path": out["ckpt_path"],
                  "step": out["state"].step}))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dualcam_h5(tmp_path_factory):
    return write_demo_fixture(
        str(tmp_path_factory.mktemp("mh_demo") / "dualcam.hdf5"),
        n_demos=3, steps=20, cameras=("agentview", "robot0_eye_in_hand"),
        image_hw=40, seed=0)


def _fit_cfg(path, ckpt_dir, **overrides):
    return Config.from_dict(jax_preset("pr2").override(**{
        "model.image_size": 32, "data.path": path, "data.batch_size": BATCH,
        "data.num_workers": 2, "data.val_fraction": 0.34,
        "train.optimizer": "sgd", "train.lr": 1e-2, "train.steps": 4,
        "train.steps_per_call": 1, "train.log_every": 1,
        "train.eval_every": 2, "train.eval_steps": 2, "train.ckpt_every": 3,
        "train.ckpt_best_metric": "loss", "train.grad_accum": 2,
        "train.ema_decay": 0.9, "train.ckpt_dir": ckpt_dir,
        "dist.num_devices": 2, **overrides}).to_dict())


def _runs(path, root):
    """Two host processes of one rank each; then, in this process, the
    two-rank launch and one process."""
    port = free_port()
    procs = []
    for p in range(2):
        cfg = _fit_cfg(path, f"{root}/hosts", **{
            "dist.multihost": True, "dist.num_devices": 0,
            "dist.num_processes": 2, "dist.process_id": p,
            "dist.coordinator": f"127.0.0.1:{port}"})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", HOST_SCRIPT, json.dumps(cfg.to_dict()),
             f"{root}/host{p}.pt"], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    try:
        two = api.train(_fit_cfg(path, f"{root}/two"), device="cpu")
        one = api.train(_fit_cfg(path, f"{root}/one", **{
            "dist.num_devices": 1}), device="cpu")
        hosts = []
        for p, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-4000:]
            hosts.append({**json.loads(stdout.strip().splitlines()[-1]),
                          **torch.load(f"{root}/host{p}.pt")})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, v in (("two", two), ("one", one)):
        out[k] = {"metrics": v["metrics"], "ckpt_path": v["ckpt_path"],
                  "ckpt_dir": v["ckpt_dir"]}
    out["hosts"] = hosts
    return out


@pytest.fixture(scope="module")
def runs(dualcam_h5, tmp_path_factory):
    """Computed once per pytest run and shared by the xdist workers, under
    the lock tests/test_torch_ddp.py's launches take (one launching
    worker at a time)."""
    root = str(tmp_path_factory.mktemp("mh_fit"))
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return _runs(dualcam_h5, root)
    base = tmp_path_factory.getbasetemp().parent
    path = base / "multihost_runs.pt"
    with open(base / "ddp_launch.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            torch.save(_runs(dualcam_h5, root), str(path) + ".tmp")
            os.replace(str(path) + ".tmp", path)
    return torch.load(path, weights_only=False)


def _metric_rows(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, (where, a, b)


def test_two_hosts_equal_the_two_rank_launch_bitwise(runs):
    """Global ranks 0 and 1 over two hosts are one host's ranks 0 and 1: the
    same checkpoints (the mid-accumulation one at step 3 included, which
    holds the ranks' mean gradient sum), the same metrics."""
    hosts_dir = os.path.dirname(runs["hosts"][0]["ckpt_path"])
    two_dir = runs["two"]["ckpt_dir"]
    for name in ("step_00000003.pt", "step_00000004.pt"):
        a = checkpoint.load_training(os.path.join(hosts_dir, name))
        b = checkpoint.load_training(os.path.join(two_dir, name))
        _assert_equal(a[1], b[1], name)
        _assert_equal(a[2], b[2], name)
    mid = checkpoint.load_training(os.path.join(two_dir, "step_00000003.pt"))
    assert mid[2]["optimizer"]["mini_step"] == 1
    rows = _metric_rows(hosts_dir)
    want = _metric_rows(two_dir)
    assert [r["step"] for r in rows] == [r["step"] for r in want]
    for a, b in zip(rows, want):
        for k in ("train/loss", "eval/loss"):
            if k in b:
                assert a[k] == b[k], (a["step"], k)


def test_two_hosts_log_the_one_process_losses(runs):
    hosts = _metric_rows(os.path.dirname(runs["hosts"][0]["ckpt_path"]))
    one = _metric_rows(runs["one"]["ckpt_dir"])
    assert len(hosts) == len(one)
    for a, b in zip(hosts, one):
        for k in ("train/loss", "eval/loss", "eval/pos_mae_cm"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                           err_msg=f"step {b['step']} {k}")


def test_global_rank_0_writes_and_every_host_restores_its_checkpoint(runs):
    hosts = runs["hosts"]
    path = hosts[0]["ckpt_path"]
    assert path.endswith("step_00000004.pt")
    assert [h["ckpt_path"] for h in hosts] == [path, path]
    assert [h["step"] for h in hosts] == [4, 4]
    d = os.path.dirname(path)
    assert sorted(os.listdir(d)) == ["best", "metrics.jsonl",
                                     "step_00000003.pt", "step_00000004.pt"]
    rows = _metric_rows(d)
    assert [r["step"] for r in rows if "train/loss" in r] == [1, 2, 3, 4]
    _, sd, tr = checkpoint.load_training(path)
    for h in hosts:
        _assert_equal(h["state_dict"], sd, "restored state")
        _assert_equal(h["ema"], tr["ema"], "restored EMA")
    assert hosts[0]["metrics"]["loss"] == hosts[1]["metrics"]["loss"]


def _pipeline_cfgs(path):
    jcfg = jax_preset("pr3").override(**{
        "data.path": path, "data.batch_size": BATCH, "data.num_workers": 2,
        "model.image_size": 32, "data.jitter_prob": 0.8,
        "data.crop_scale": (0.8, 1.0), "data.hflip_prob": 0.5,
        "model.cameras": ("agentview", "robot0_eye_in_hand")})
    return jcfg, Config.from_dict(jcfg.to_dict())


def _leaves(batch, prefix=""):
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("local", [1, 2], ids=["1 rank a host",
                                               "2 ranks a host"])
def test_global_ranks_rows_are_the_references_process_slices(
        local, dualcam_h5, monkeypatch):
    """Global rank p * L + i's rows, over a host's L ranks, are the rows
    the JAX package's process p builds in its multi-process branch."""
    from rgb_proprioceptive_pose_estimator_tpu.data.pipeline import (
        build_dataset as jax_build_dataset,
    )

    jcfg, cfg = _pipeline_cfgs(dualcam_h5)
    hosts = 2
    jds, ds = jax_build_dataset(jcfg), build_dataset(cfg)
    for p in range(hosts):
        monkeypatch.setattr(jax_pipeline.jax, "process_count", lambda: hosts)
        monkeypatch.setattr(jax_pipeline.jax, "process_index", lambda p=p: p)
        ref = jax_pipeline.HostPipeline(jds, jcfg.data, train=True)
        ranks = [HostPipeline(ds, cfg.data, train=True, rank=p * local + i,
                              world=hosts * local) for i in range(local)]
        try:
            for _ in range(4):                  # over an epoch boundary
                want = dict(_leaves(ref._build(ref._consumed)))
                ref._consumed += 1
                parts = [dict(_leaves(next(r))) for r in ranks]
                assert sorted(parts[0]) == sorted(want)
                for k, w in want.items():
                    got = np.concatenate([part[k] for part in parts])
                    assert got.dtype == w.dtype and got.shape == w.shape, k
                    np.testing.assert_array_equal(got, w, err_msg=f"{p} {k}")
        finally:
            ref.close()
            for r in ranks:
                r.close()


def test_hosts_with_other_device_counts_are_refused(dualcam_h5):
    """Each host's launcher checks every host's count at the coordinator
    before it starts a rank."""
    port = free_port()
    errors = [None, None]

    def host(p, devices):
        cfg = _fit_cfg(dualcam_h5, "unused", **{
            "dist.multihost": True, "dist.num_devices": 0,
            "dist.num_processes": 2, "dist.process_id": p,
            "dist.coordinator": f"127.0.0.1:{port}"})
        try:
            dist.launch_host(dist.run_each, cfg, devices, "gloo")
        except ValueError as e:
            errors[p] = e

    before = set(dist.child_processes())
    threads = [threading.Thread(target=host, args=(0, ["cpu"])),
               threading.Thread(target=host, args=(1, ["cpu", "cpu"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for e in errors:
        assert e is not None and "device counts differ ([1, 2]" in str(e)
    assert set(dist.child_processes()) <= before

"""The port's serving half on the CPU, held against the JAX package:
``utils/obs_buffer.ObsBuffer``, ``Predictor.warmup(dead_camera_sets=)``,
and the HTTP server (``utils/serve.py``, ``cli serve``) answering the same
requests as the JAX package's server over the same weights (the JAX
package's variables from a seed, converted with ``state_dict_from_jax``):
``/healthz``, single and batched requests, a temporal session through a
dead camera, coalesced concurrent clients, 413 and 400.

Models: pr2's CNNSmall at 32 px, one camera and one frame; and a temporal
two-camera variant (T = 3, channel-stacked frames, proprio, camera dropout
0.25) for sessions. Poses within rtol 1e-5 (atol 1e-6) of the JAX
server's; the port's HTTP answers equal its in-process Predictor's bit
for bit."""

import base64
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.engine.state import (
    create_state as jax_create_state,
)
from rgb_proprioceptive_pose_estimator_tpu.engine.train_step import (
    make_optimizer as jax_make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import build_model
from rgb_proprioceptive_pose_estimator_tpu.utils import serve as jax_serve
from rgb_proprioceptive_pose_estimator_tpu.utils.obs_buffer import (
    ObsBuffer as JaxObsBuffer,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch import cli
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import serve
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer import (
    ObsBuffer,
)

RTOL, ATOL = 1e-5, 1e-6
DEAD = "robot0_eye_in_hand"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(temporal):
    over = {"model.image_size": 32, "dist.num_devices": 1}
    if temporal:
        over.update({"model.temporal_frames": 3,
                     "model.cameras": ("agentview", DEAD),
                     "model.use_proprio": True,
                     "model.camera_dropout": 0.25})
    jcfg = jax_preset("pr2").override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


class _Pair:
    """The JAX package's server and the port's over the same weights at
    step 7 (the port's from a checkpoint file), each on a free port in a
    thread."""

    def __init__(self, temporal, coalesce_ms=0.0, max_body_mb=64.0):
        self.jcfg, self.cfg = _cfgs(temporal)
        variables = jax.tree.map(np.asarray, random_jax_variables(
            self.cfg.model, seed=5))
        tx = jax_make_optimizer(self.jcfg.train)
        jstate = jax_create_state(self.jcfg, tx, seed=0)
        jstate = jstate.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                step=7)
        self._dir = tempfile.TemporaryDirectory()
        path = checkpoint.save_step(
            self._dir.name, 7, 0, self.cfg,
            state_dict_from_jax(variables, self.cfg.model), {"step": 7})
        self.services = {
            "jax": jax_serve.PoseService(
                self.jcfg, state=jstate, model=build_model(self.jcfg.model),
                max_batch=4, coalesce_ms=coalesce_ms),
            "port": serve.PoseService(
                self.cfg, max_batch=4, coalesce_ms=coalesce_ms,
                ckpt_path=path, device="cpu")}
        self.ports, self._httpd = {}, []
        for name, svc in self.services.items():
            mod = jax_serve if name == "jax" else serve
            httpd = mod.make_server(svc, port=0, max_body_mb=max_body_mb)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            self._httpd.append(httpd)
            self.ports[name] = httpd.server_address[1]

    def both(self, method, path, payload=None, raw=None):
        return {name: _request(port, method, path, payload, raw)
                for name, port in self.ports.items()}

    def close(self):
        for httpd in self._httpd:
            httpd.shutdown()
            httpd.server_close()
        for svc in self.services.values():
            svc.close()
        self._dir.cleanup()


def _request(port, method, path, payload=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = raw if raw is not None else (
        json.dumps(payload) if payload is not None else None)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


@pytest.fixture(scope="module")
def single():
    pair = _Pair(temporal=False)
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def temporal():
    pair = _Pair(temporal=True)
    yield pair
    pair.close()


def _raw(img):
    return {"b64": base64.b64encode(np.ascontiguousarray(img).tobytes())
            .decode(), "encoding": "raw", "shape": list(img.shape)}


def _images(cfg, rs, lead=()):
    hw = cfg.model.image_size
    return {c: rs.randint(0, 256, lead + (hw, hw, 3)).astype(np.uint8)
            for c in cfg.model.cameras}


def _assert_poses_close(out, what):
    assert out["jax"][0] == out["port"][0] == 200, (what, out)
    for k in ("pos", "quat"):
        np.testing.assert_allclose(out["port"][1][k], out["jax"][1][k],
                                   rtol=RTOL, atol=ATOL, err_msg=what)
    assert out["port"][1]["quat_order"] == "wxyz"


def test_healthz_reports_what_the_jax_server_does(single):
    out = single.both("GET", "/healthz")
    (js, jh), (ps, ph) = out["jax"], out["port"]
    assert js == ps == 200
    assert ph.keys() == jh.keys()
    for k in ph:
        if k not in ("requests", "p50_ms"):
            assert ph[k] == jh[k], k
    assert ph["step"] == 7 and ph["cameras"] == ["agentview"]


def test_single_and_batched_requests_match_the_jax_server(single):
    rs = np.random.RandomState(0)
    cfg = single.cfg
    img = _images(cfg, rs)["agentview"]
    _assert_poses_close(single.both("POST", "/predict", {
        "images": {"agentview": _raw(img)}}), "single raw")
    _assert_poses_close(single.both("POST", "/predict", {
        "images": {"agentview": img.tolist()}}), "single nested list")
    batch = _images(cfg, rs, (5,))["agentview"]
    out = single.both("POST", "/predict", {
        "images": {"agentview": _raw(batch)}})
    _assert_poses_close(out, "batch of 5")
    assert np.shape(out["port"][1]["pos"]) == (5, 3)
    # HTTP answers are the in-process Predictor's, bit for bit
    pos, quat = single.services["port"].predictor(
        {"images": {"agentview": batch}})
    assert out["port"][1]["pos"] == pos.tolist()
    assert out["port"][1]["quat"] == quat.tolist()


def test_client_errors_are_the_jax_servers(single):
    for raw, payload in ((b"{not json", None), (None, [1, 2]),
                         (None, {"nothing": 1}),
                         (None, {"images": {"agentview": {"b64": "###"}}}),
                         (None, {"images": {"agentview": {
                             "b64": "AAAA", "encoding": "raw"}}}),
                         (None, {"images": {"agentview": {
                             "b64": "AAAA", "encoding": "raw",
                             "shape": [2, 2, 3]}}}),
                         (None, {"images": {"agentview": {
                             "b64": "AAAA", "encoding": "gif"}}})):
        out = single.both("POST", "/predict", payload, raw)
        assert out["port"] == out["jax"], (raw, payload, out)
        assert out["port"][0] == 400
    out = single.both("POST", "/nowhere", {})
    assert out["port"] == out["jax"] and out["port"][0] == 404


def _oversized(port, nbytes):
    """A POST that announces ``nbytes`` of body and sends none: the
    server answers from the header alone."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.putrequest("POST", "/predict")
    conn.putheader("Content-Length", str(nbytes))
    conn.endheaders()
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_body_over_the_limit_is_413_as_the_jax_server():
    pair = _Pair(temporal=False, max_body_mb=0.001)
    try:
        limit = int(0.001 * 1024 * 1024)
        out = {name: _oversized(port, limit + 1)
               for name, port in pair.ports.items()}
        assert out["port"] == out["jax"] and out["port"][0] == 413
        # an announced empty body is read, and refused as JSON
        out = {name: _oversized(port, 0) for name, port in pair.ports.items()}
        assert out["port"] == out["jax"] and out["port"][0] == 400
    finally:
        pair.close()


def _frame(cfg, rs, dead=()):
    hw = cfg.model.image_size
    return {"images": {c: rs.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
                       for c in cfg.model.cameras if c not in dead},
            "proprio": rs.randn(cfg.model.proprio_dim).astype(np.float32)}


def _payload(frame, session, reset=False):
    return {"session": session, "reset": reset,
            "proprio": frame["proprio"].tolist(),
            "images": {c: _raw(v) for c, v in frame["images"].items()}}


def test_session_through_a_dead_camera_matches_the_jax_server(temporal):
    """Five frames; robot0_eye_in_hand is lost on frame 3 and back on
    frame 4: the same poses and session fields as the JAX server, and the
    port's answers equal its in-process ObsBuffer + Predictor loop."""
    cfg = temporal.cfg
    rs = np.random.RandomState(1)
    frames = [_frame(cfg, rs, dead=(DEAD,) if i == 2 else ())
              for i in range(5)]
    buf = ObsBuffer(cfg.model)
    pred = temporal.services["port"].predictor
    for i, fr in enumerate(frames):
        out = temporal.both("POST", "/predict",
                            _payload(fr, "s1", reset=i == 0))
        _assert_poses_close(out, f"frame {i}")
        for k in ("window_fill", "window_size", "dead_cameras",
                  "session_restarted"):
            assert out["port"][1].get(k) == out["jax"][1].get(k), (i, k)
        pos, quat = pred(buf.push(fr))
        assert out["port"][1]["pos"] == pos.tolist()
        assert out["port"][1]["quat"] == quat.tolist()
        # dead from frame 3 for a whole window of 3 frames
        assert (DEAD in out["port"][1].get("dead_cameras", [])) == (i >= 2)
    out = temporal.both("POST", "/predict", _payload(frames[0], "fresh"))
    assert out["port"][1]["session_restarted"] is True
    assert out["jax"][1]["session_restarted"] is True


def test_coalesced_concurrent_clients_match_the_jax_server():
    """coalesce_ms 2 with 8 clients at once: every answer is the JAX
    server's, and the port's service ran batches of several."""
    pair = _Pair(temporal=False, coalesce_ms=2.0)
    try:
        rs = np.random.RandomState(2)
        imgs = [_images(pair.cfg, rs)["agentview"] for _ in range(8)]

        def ask(name, img):
            return _request(pair.ports[name], "POST", "/predict",
                            {"images": {"agentview": _raw(img)}})

        for _ in range(2):
            with ThreadPoolExecutor(8) as pool:
                port = list(pool.map(lambda im: ask("port", im), imgs))
                jax_ = list(pool.map(lambda im: ask("jax", im), imgs))
            for i, (p, j) in enumerate(zip(port, jax_)):
                _assert_poses_close({"port": p, "jax": j}, f"client {i}")
        h = _request(pair.ports["port"], "GET", "/healthz")[1]
        assert h["coalesce_ms"] == 2.0 and h["requests"] == 16
        assert h["coalesced_batches"] < 16
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# ObsBuffer and warmup
# ---------------------------------------------------------------------------


def test_obs_buffer_matches_the_reference_through_a_dead_camera():
    jcfg, cfg = _cfgs(temporal=True)
    rs = np.random.RandomState(3)
    ours, ref = ObsBuffer(cfg.model), JaxObsBuffer(jcfg.model)
    for i in range(7):
        fr = _frame(cfg, rs, dead=(DEAD,) if i in (2, 3) else ())
        if i == 5:
            ours.reset()
            ref.reset()
        got, want = ours.push(fr), ref.push(fr)
        assert len(ours) == len(ref)
        assert ours.dead_cameras() == ref.dead_cameras()
        assert got.keys() == want.keys()
        assert got["images"].keys() == want["images"].keys()
        for c in got["images"]:
            np.testing.assert_array_equal(got["images"][c],
                                          want["images"][c])
        np.testing.assert_array_equal(got["proprio"], want["proprio"])


def test_warmup_runs_dead_camera_sets_and_refuses_unknown_cameras(
        monkeypatch):
    _, cfg = _cfgs(temporal=True)
    variables = random_jax_variables(cfg.model, seed=5)
    pred = api.Predictor(cfg, max_batch=2, device="cpu",
                         state_dict=state_dict_from_jax(
                             jax.tree.map(np.asarray, variables), cfg.model))
    seen = []
    call = api.Predictor.__call__

    def spy(self, obs):
        seen.append(sorted(obs.get("images", {})))
        return call(self, obs)

    monkeypatch.setattr(api.Predictor, "__call__", spy)
    assert pred.warmup(dead_camera_sets=[(DEAD,), ("agentview",)]) is pred
    assert seen == [["agentview", DEAD], ["agentview"], [DEAD]]
    with pytest.raises(ValueError, match="not in model.cameras"):
        pred.warmup(dead_camera_sets=[("wrist",)])


def test_predictor_reports_the_checkpoints_step(tmp_path):
    _, cfg = _cfgs(temporal=False)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, random_jax_variables(
        cfg.model, seed=5)), cfg.model)
    path = checkpoint.save_step(str(tmp_path), 12, 0, cfg, sd, {"step": 12})
    assert api.Predictor(cfg, str(tmp_path), device="cpu").step == 12
    assert api.Predictor(cfg, ckpt_path=path, device="cpu").step == 12
    assert api.Predictor(cfg, state_dict=sd, device="cpu").step == 0


def test_cli_serve_answers_over_http(tmp_path):
    """``cli serve`` on a free port with the CPU: the first line names
    the address and health; a request gets the in-process Predictor's
    pose."""
    _, cfg = _cfgs(temporal=False)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, random_jax_variables(
        cfg.model, seed=5)), cfg.model)
    checkpoint.save_step(str(tmp_path), 3, 0, cfg, sd, {"step": 3})
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    assert "serve" in cli.COMMANDS
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rgb_proprioceptive_pose_estimator_tpu_torch.cli",
         "serve", "--config", str(cfg_path), "--device", "cpu", "--port",
         "0", "--set", f"train.ckpt_dir={tmp_path}", "--max-batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["status"] == "ok" and first["step"] == 3
        port = int(first["serving"].rsplit(":", 1)[1])
        img = np.random.RandomState(4).randint(0, 256, (32, 32, 3)).astype(
            np.uint8)
        status, out = _request(port, "POST", "/predict",
                               {"images": {"agentview": _raw(img)}})
        assert status == 200
        pos, quat = api.Predictor(cfg, str(tmp_path), device="cpu")(
            {"images": {"agentview": img}})
        np.testing.assert_allclose(out["pos"], pos, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["quat"], quat, rtol=RTOL, atol=ATOL)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()

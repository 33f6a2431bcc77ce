"""The port's serving artifacts (``utils/export.py``) on the CPU, held
against its Predictor and against the JAX package's ``utils/export.py``.

pr3 (ResNet-18) and the small ViT at 32 px, weights made from a numpy
seed in the JAX layout. The f32 artifact runs the model's own ops, so it
equals the Predictor within rtol 1e-5, atol 1e-6 (the reference's
tests/test_export.py); against the JAX package's artifact of the same
weights the tolerance is the model comparison's (tests/test_torch_model.py:
rtol 1e-3, atol 1e-4). int8 q and scale equal the reference's
``_quantize_params`` bit for bit. Torch runs on one intra-op thread.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
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
from rgb_proprioceptive_pose_estimator_tpu.utils.export import (
    _quantize_params as jax_quantize_params,
)
from rgb_proprioceptive_pose_estimator_tpu.utils.export import (
    export_predictor as jax_export_predictor,
)
from rgb_proprioceptive_pose_estimator_tpu.utils.export import (
    load_predictor as jax_load_predictor,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api, cli
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    jax_leaf,
    random_jax_variables,
    state_dict_from_jax,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
    MAGIC,
    export_predictor,
    load_predictor,
    quantized_weights,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4
MAX_BATCH = 4
MODELS = {
    "pr3": {"model.image_size": 32},
    "vit": {"model.image_size": 32, "model.backbone": "vit",
            "model.vit_patch": 8, "model.vit_dim": 32, "model.vit_depth": 2,
            "model.vit_heads": 4, "model.vit_pool": "cls"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(name, root, seed=0):
    """(JAX config, port config, JAX variables, port state_dict) with a
    port checkpoint of the weights at step 5 under ``root``."""
    jcfg = jax_preset("pr3").override(**{
        **MODELS[name], "train.ckpt_dir": str(root)})
    cfg = Config.from_dict(jcfg.to_dict())
    variables = jax.tree.map(np.asarray,
                             random_jax_variables(cfg.model, seed=seed))
    sd = state_dict_from_jax(variables, cfg.model)
    checkpoint.save_step(str(root), 5, 0, cfg, sd, {"step": 5})
    return jcfg, cfg, variables, sd


@pytest.fixture(scope="module", params=sorted(MODELS))
def exported(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"export_{request.param}")
    jcfg, cfg, variables, sd = _case(request.param, root / "ckpt")
    paths = {q: export_predictor(str(root / f"{q}.rppe"), cfg,
                                 max_batch=MAX_BATCH, quantize=q)
             for q in ("none", "int8")}
    return {"name": request.param, "jcfg": jcfg, "cfg": cfg,
            "variables": variables, "sd": sd, "paths": paths, "root": root}


def _obs(cfg, n, seed):
    rs = np.random.RandomState(seed)
    hw = cfg.model.image_size
    return {"images": {c: rs.randint(0, 256, (n, hw, hw, 3), np.uint8)
                       for c in cfg.model.cameras},
            "proprio": rs.randn(n, cfg.model.proprio_dim).astype(np.float32)}


def _program(path):
    with zipfile.ZipFile(path) as z:
        return torch.export.load(io.BytesIO(z.read("program.pt2")))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_int8_q_and_scale_equal_the_references(name, tmp_path):
    """Every >=2-D kernel (convolutions, dense layers, the ViT's per-head
    attention kernels) quantized per index of its flax layout's last axis,
    bit for bit with the reference's _quantize_params."""
    _, cfg, variables, sd = _case(name, tmp_path)
    want = jax_quantize_params(variables["params"])
    got = quantized_weights(sd)
    n = 0
    for key, (q, scale) in got.items():
        path, q_flax = jax_leaf(key, q.numpy())
        node = want
        for p in path[1:]:
            node = node[p]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q_flax, node["q"], err_msg=key)
        np.testing.assert_array_equal(scale.numpy(), node["scale"],
                                      err_msg=key)
        n += 1
    quantized = [p for p, leaf in _flat(want) if isinstance(leaf, dict)]
    assert n == len(quantized) > 0
    if name == "vit":
        q, scale = got["encoder_agentview.block0.attn.query.weight"]
        assert tuple(q.shape) == (32, 4, 8) and tuple(scale.shape) == (8,)
        q, scale = got["encoder_agentview.block0.attn.out.weight"]
        assert tuple(q.shape) == (4, 8, 32) and tuple(scale.shape) == (32,)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_exported_graph_holds_the_kernel_ops(exported):
    """The program keeps rppe::normalize_u8 (every encoder) and, for the
    ResNet, rppe::scale_bias_relu (9 BN-ReLU sites) as nodes; the int8
    program stores int8 weights and no f32 copy of them."""
    for quantize, path in exported["paths"].items():
        program = _program(path)
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("rppe.normalize_u8.default") == 1
        sbr = targets.count("rppe.scale_bias_relu.default")
        assert sbr == (9 if exported["name"] == "pr3" else 0)
        state = program.state_dict
        names = sorted(exported["sd"])
        kernels = quantized_weights(exported["sd"])
        if quantize == "int8":
            q = [k for k, v in state.items() if v.dtype == torch.int8]
            assert len(q) == len(kernels)
            assert sum(v.numel() for k, v in state.items()
                       if v.dtype == torch.float32) < sum(
                v.numel() for v in state.values()) / 4
        else:
            assert all(v.dtype == torch.float32 for v in state.values())
            assert sum(v.numel() for v in state.values()) == sum(
                exported["sd"][k].numel() for k in names)
        meta = json.loads(zipfile.ZipFile(path).read("meta.json"))
        assert meta["magic"] == MAGIC and meta["quantize"] == quantize
        assert meta["max_batch"] == MAX_BATCH


def test_artifact_equals_the_predictor_and_the_jax_export(exported):
    cfg, jcfg = exported["cfg"], exported["jcfg"]
    obs = _obs(cfg, 3, seed=1)
    pred = api.Predictor(cfg, state_dict=exported["sd"], device="cpu",
                         max_batch=MAX_BATCH)
    want = pred(obs)
    serve = load_predictor(exported["paths"]["none"], device="cpu")
    got = serve(obs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the JAX package's artifacts of the same weights, f32 and int8
    variables = exported["variables"]
    tx = jax_make_optimizer(jcfg.train)
    state = jax_create_state(jcfg, tx, seed=0).replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    root = exported["root"]
    for quantize in ("none", "int8"):
        jpath = jax_export_predictor(str(root / f"jax_{quantize}.rppe"),
                                     jcfg, state=state, max_batch=MAX_BATCH,
                                     quantize=quantize)
        jwant = jax_load_predictor(jpath)(obs)
        jgot = load_predictor(exported["paths"][quantize], device="cpu")(obs)
        for g, w in zip(jgot, jwant):
            np.testing.assert_allclose(g, w, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=quantize)


def test_int8_artifact_is_smaller_and_close(exported):
    """The reference's bounds: positions within 0.05 of the f32 artifact's,
    |<q8, q32>| within 0.01 of 1; a quarter of the bytes or less for the
    ResNet."""
    paths = exported["paths"]
    obs = _obs(exported["cfg"], MAX_BATCH, seed=2)
    pos32, quat32 = load_predictor(paths["none"], device="cpu")(obs)
    pos8, quat8 = load_predictor(paths["int8"], device="cpu")(obs)
    np.testing.assert_allclose(pos8, pos32, atol=0.05)
    np.testing.assert_allclose(np.abs(np.sum(quat8 * quat32, axis=-1)),
                               1.0, atol=0.01)
    assert not np.array_equal(pos8, pos32)
    ratio = os.path.getsize(paths["int8"]) / os.path.getsize(paths["none"])
    assert ratio < (0.3 if exported["name"] == "pr3" else 0.6), ratio


def test_padding_trimming_casting_and_refusals(exported, tmp_path):
    cfg = exported["cfg"]
    serve = load_predictor(exported["paths"]["none"], device="cpu")
    full = _obs(cfg, MAX_BATCH, seed=3)
    pos, quat = serve(full)
    for n in (1, 3):
        part = {"images": {c: v[:n] for c, v in full["images"].items()},
                "proprio": full["proprio"][:n]}
        p, q = serve(part)
        assert p.shape == (n, 3) and q.shape == (n, 4)
        np.testing.assert_allclose(p, pos[:n], rtol=RTOL, atol=ATOL)
    # lists and float64 are cast to the exported dtypes
    lists = {"images": {c: v[:2].tolist() for c, v in full["images"].items()},
             "proprio": full["proprio"][:2].astype(np.float64)}
    p, _ = serve(lists)
    np.testing.assert_allclose(p, pos[:2], rtol=RTOL, atol=ATOL)
    too_big = _obs(cfg, MAX_BATCH + 1, seed=4)
    with pytest.raises(ValueError, match="max_batch"):
        serve(too_big)
    bad = tmp_path / "bad.rppe"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("meta.json", json.dumps({"magic": "rppe-predictor-v1"}))
    with pytest.raises(ValueError, match="not a port predictor artifact"):
        load_predictor(str(bad), device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        export_predictor(str(tmp_path / "x.rppe"), cfg, quantize="int4")


def test_artifact_serves_the_ema_weights(tmp_path):
    """A checkpoint with an EMA exports the EMA's parameters, as the
    reference's eval_variables."""
    _, cfg, _, sd = _case("pr3", tmp_path / "raw")
    ema_src = state_dict_from_jax(random_jax_variables(cfg.model, seed=7),
                                  cfg.model)
    ema = {k: ema_src[k] for k, _ in
           torch.nn.Module.named_parameters(api._model_from(cfg, sd, "cpu"))}
    d = str(tmp_path / "ema")
    path = checkpoint.save_step(d, 6, 0, cfg, sd, {"step": 6, "ema": ema})
    art = export_predictor(str(tmp_path / "ema.rppe"),
                           cfg.override(**{"train.ckpt_dir": d}),
                           max_batch=MAX_BATCH)
    obs = _obs(cfg, 2, seed=8)
    got = load_predictor(art, device="cpu")(obs)
    want = api.Predictor(cfg, ckpt_path=path, device="cpu")(obs)
    raw = api.Predictor(cfg, state_dict=sd, device="cpu")(obs)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert not np.allclose(got[0], raw[0], rtol=RTOL, atol=ATOL)


_CHILD = r"""
import json, sys
import numpy as np
from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion


def refuse(*a, **k):
    raise AssertionError("the artifact built a PoseEstimator")


fusion.PoseEstimator.__init__ = refuse
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
    load_predictor,
)

serve = load_predictor(sys.argv[1], device="cpu")
obs = {k: (np.asarray(v, np.uint8) if k == "images" else np.asarray(v))
       for k, v in json.loads(sys.stdin.read()).items()}
obs["images"] = {"agentview": obs["images"]}
pos, quat = serve(obs)
print(json.dumps({"pos": pos.tolist(), "quat": quat.tolist()}))
"""


def test_artifact_serves_in_a_fresh_process_alone(tmp_path):
    """The artifact alone serves: in a new process, with the checkpoint
    and its directory gone and PoseEstimator unbuildable, the answers are
    those of this process's load."""
    root = tmp_path / "alone"
    _, cfg, _, _ = _case("pr3", root / "ckpt", seed=3)
    art = export_predictor(str(root / "a.rppe"), cfg, max_batch=MAX_BATCH)
    shutil.rmtree(root / "ckpt")
    obs = _obs(cfg, 2, seed=9)
    want = load_predictor(art, device="cpu")(obs)
    payload = json.dumps({"images": obs["images"]["agentview"].tolist(),
                          "proprio": obs["proprio"].tolist()})
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD, art], input=payload,
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    np.testing.assert_array_equal(np.asarray(got["pos"], np.float32),
                                  want[0])
    np.testing.assert_array_equal(np.asarray(got["quat"], np.float32),
                                  want[1])


def test_cli_export_writes_a_loadable_artifact(tmp_path, capsys):
    _, cfg, _, sd = _case("pr3", tmp_path / "ckpt")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    out = str(tmp_path / "cli.rppe")
    assert cli.main(["export", "--config", str(cfg_path), "--quantize",
                     "int8", "--max-batch", "2", "--out", out]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == {"exported": out, "bytes": os.path.getsize(out),
                      "max_batch": 2, "quantize": "int8"}
    serve = load_predictor(out, device="cpu")
    assert serve.meta["quantize"] == "int8" and serve.meta["max_batch"] == 2
    pos, quat = serve(_obs(cfg, 2, seed=10))
    assert pos.shape == (2, 3) and np.all(np.isfinite(quat))


def test_load_predictor_runs_on_cuda_unless_asked_for_the_cpu(exported,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(exported["paths"]["none"])

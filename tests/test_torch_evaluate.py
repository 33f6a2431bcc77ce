"""The port's ``evaluate`` and CLI against the JAX package's on the CPU.

``evaluate``: the same seeded weights, saved as a checkpoint by each
package, scored by both on one ``write_demo_fixture`` file at 64 px (pr2,
CNNSmall, with its proprio branch on). Tolerances: the mean metrics and
per-sample errors rtol 1e-4 (the same f32 math summed in other orders);
the reports' rounded numbers (3 decimals) within one unit of their last
place; predictions rtol 1e-3, atol 1e-4 (tests/test_torch_model.py).

CLI: ``config``, ``presets`` and ``info`` print what the JAX CLI prints;
``train``, ``eval`` and ``predict`` run with ``--device cpu``; the
subcommands not in the port exit non-zero naming their ROADMAP item."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgb_proprioceptive_pose_estimator_tpu as rppe
from rgb_proprioceptive_pose_estimator_tpu import cli as jax_cli
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
from rgb_proprioceptive_pose_estimator_tpu.utils.checkpoint import (
    CheckpointManager,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import cli
from rgb_proprioceptive_pose_estimator_tpu_torch import evaluate
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    random_jax_variables,
    state_dict_from_jax,
)

STEP = 7
METRIC_RTOL = 1e-4
ROUNDED = 1e-3
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """pr2 at 64 px with proprio, seeded weights saved at step STEP by both
    packages, and the demo fixture (3 demos of 20 steps)."""
    root = tmp_path_factory.mktemp("eval")
    path = write_demo_fixture(str(root / "demo64.hdf5"), n_demos=3,
                              steps=20, cameras=("agentview",),
                              image_hw=64, seed=3)
    jcfg = jax_preset("pr2").override(**{
        "model.use_proprio": True, "data.path": path,
        "data.batch_size": 16, "dist.num_devices": 1})
    cfg = Config.from_dict(jcfg.to_dict())
    variables = random_jax_variables(cfg.model, seed=11)
    jdir, pdir = str(root / "jax_ckpt"), str(root / "port_ckpt")
    state = jax_create_state(jcfg, jax_make_optimizer(jcfg.train), seed=0)
    state = state.replace(
        step=jnp.asarray(STEP, jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    mngr = CheckpointManager(jdir, keep=1, async_save=False)
    mngr.save(STEP, state)
    mngr.close()
    checkpoint.save_step(pdir, STEP, 0, cfg,
                         state_dict_from_jax(variables, cfg.model), {})
    return {"jcfg": jcfg, "cfg": cfg, "jdir": jdir, "pdir": pdir,
            "path": path, "root": root}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes are small, and the suite's test
    workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(scored, name, **kw):
    """(port report, JAX report) of evaluate with ``kw``; a
    dump_predictions name gets a per-package suffix."""
    def dump(side):
        return (str(scored["root"] / f"{name}_{side}")
                if kw.get("dump_predictions") else "")

    port = evaluate(scored["cfg"], ckpt_dir=scored["pdir"], device="cpu",
                    **dict(kw, dump_predictions=dump("port")))
    ref = rppe.evaluate(scored["jcfg"], ckpt_dir=scored["jdir"],
                        **dict(kw, dump_predictions=dump("jax")))
    return port, ref


def _close_rounded(a, b):
    np.testing.assert_allclose(a, b, rtol=METRIC_RTOL, atol=ROUNDED)


def test_evaluate_matches_jax_with_every_report(scored):
    port, ref = _pair(scored, "all", data_path=scored["path"], per_demo=True,
                      percentiles=True, success_at=((25.0, 60.0),
                                                    (40.0, 120.0)),
                      dump_predictions=True)
    assert sorted(port) == sorted(ref)
    assert port["step"] == ref["step"] == STEP
    assert port["n_samples"] == ref["n_samples"] == 60
    for k in ("loss", "pos_loss", "rot_loss", "pos_mae_cm", "rot_mae_deg"):
        np.testing.assert_allclose(port[k], ref[k], rtol=METRIC_RTOL,
                                   err_msg=k)
    for k in ("pos_err_cm", "rot_err_deg"):
        assert port[k].keys() == ref[k].keys()
        for q in port[k]:
            _close_rounded(port[k][q], ref[k][q])
    assert port["success"] == ref["success"]
    assert port["per_demo"].keys() == ref["per_demo"].keys()
    for demo, row in port["per_demo"].items():
        want = ref["per_demo"][demo]
        assert row["steps"] == want["steps"]
        _close_rounded(row["pos_mae_cm"], want["pos_mae_cm"])
        _close_rounded(row["rot_mae_deg"], want["rot_mae_deg"])
    got = np.load(port["predictions_path"])
    want = np.load(ref["predictions_path"])
    assert port["predictions_path"].endswith(".npz")
    assert sorted(got.files) == sorted(want.files)
    for k in ("target_pos", "target_quat", "demo_idx", "t", "demo_keys"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pred_pos", "pred_quat"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("pos_err_cm", "rot_err_deg"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   atol=ROUNDED, err_msg=k)


def test_evaluate_with_a_dead_camera_matches_jax(scored):
    port, ref = _pair(scored, "dead", drop_cameras=("agentview",
                                                    "agentview"),
                      max_batches=2)
    assert sorted(port) == sorted(ref)
    for k in ("loss", "pos_mae_cm", "rot_mae_deg"):
        np.testing.assert_allclose(port[k], ref[k], rtol=METRIC_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("kw,error", [
    ({"drop_cameras": ("wrist",)}, ValueError),
    ({"step": "latest"}, ValueError),
    ({"step": 99}, FileNotFoundError),
])
def test_evaluate_refuses_what_the_jax_package_refuses(scored, kw, error):
    with pytest.raises(error):
        evaluate(scored["cfg"], ckpt_dir=scored["pdir"], device="cpu", **kw)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("name", ["pr1", "pr2", "pr3", "pr4", "pr5", "pr5la"])
def test_cli_config_and_info_print_what_the_jax_cli_prints(name, capsys):
    for command in ("config", "info"):
        argv = [command, "--preset", name, "--set", "train.lr=0.002"]
        rc, port = _run(cli.main, argv, capsys)
        rc_j, ref = _run(jax_cli.main, argv, capsys)
        assert rc == rc_j == 0
        assert json.loads(port.out) == json.loads(ref.out), command


def test_cli_presets_print_what_the_jax_cli_prints(capsys):
    rc, port = _run(cli.main, ["presets"], capsys)
    rc_j, ref = _run(jax_cli.main, ["presets"], capsys)
    assert rc == rc_j == 0 and port.out == ref.out


def test_cli_train_eval_predict_on_the_cpu(scored, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    common = ["--preset", "pr2", "--device", "cpu", "--set",
              f"data.path={scored['path']}", "--set", "data.batch_size=16",
              "--set", f"train.ckpt_dir={ckpt}"]
    rc, out = _run(cli.main, ["train", *common, "--set", "train.steps=2",
                              "--set", "train.eval_every=2", "--set",
                              "train.eval_steps=1", "--set",
                              "data.num_workers=0"], capsys)
    assert rc == 0
    trained = json.loads(out.out)
    assert np.isfinite(trained["loss"]) and "eval_pos_mae_cm" in trained
    rc, out = _run(cli.main, ["eval", *common, "--percentiles",
                              "--success-at", "20:90,50:180"], capsys)
    assert rc == 0
    report = json.loads(out.out)
    assert report["step"] == 2 and len(report["success"]) == 2
    assert set(report["pos_err_cm"]) == {"p50", "p90", "p95", "max"}
    rc, out = _run(cli.main, ["predict", *common, "--demo", "1", "--step",
                              "2"], capsys)
    assert rc == 0
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert len(lines) == 21 and [r["t"] for r in lines[:-1]] == list(
        range(20))
    assert set(lines[-1]) == {"pos_mae_cm", "rot_mae_deg"}


def _outcome(main, argv, capsys):
    """What a CLI call ends with: (exit code or the exception's type,
    its message with the package's name taken out)."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    except Exception as e:  # noqa: BLE001 (the outcome is compared)
        rc = (type(e).__name__, str(e))
    capsys.readouterr()
    return (rc if not isinstance(rc, str) else
            rc.replace("rgb_proprioceptive_pose_estimator_tpu_torch",
                       "rgb_proprioceptive_pose_estimator_tpu"))


@pytest.mark.parametrize("command", ("export", "render", "repack", "sweep",
                                     "curves", "inspect"))
def test_cli_commands_not_in_the_port_exit_naming_their_item(
        command, capsys, tmp_path):
    """The six subcommands that the port's CLI once refused run in it: called without their inputs (no checkpoint, --src, --grid,
    metrics file or hdf5 data), each ends as the JAX package's CLI does,
    with the same message."""
    argv = [command, "--out", str(tmp_path / "x"), "--set",
            f"train.ckpt_dir={tmp_path / 'empty'}"]
    assert command in cli.COMMANDS
    port = _outcome(cli.main, argv, capsys)
    ref = _outcome(jax_cli.main, argv, capsys)
    assert port == ref and port != 0, (port, ref)


def test_cli_predict_plot_is_refused(scored, tmp_path, capsys):
    """predict --plot (once refused) writes the reference's
    trajectory figure for the demo and reports its path; with --t it is
    refused as in the reference."""
    common = ["predict", "--preset", "pr2", "--device", "cpu", "--set",
              f"data.path={scored['path']}", "--set",
              "model.use_proprio=true", "--ckpt-dir", scored["pdir"]]
    png = str(tmp_path / "traj.png")
    rc, out = _run(cli.main, [*common, "--plot", png], capsys)
    summary = json.loads(out.out.splitlines()[-1])
    assert rc == 0 and summary["plot"] == png
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit, match="drop --t"):
        cli.main([*common, "--plot", png, "--t", "0"])

"""The port's import surface and quaternion algebra, held against the JAX
package on the CPU.

Every name in the ``__all__`` of the reference's package and of each of
its subpackages resolves in the port's: under the same name, under the
port's own name (the subpackage's ``REFERENCE_NAMES``, a path from the
subpackage), or it stands on the subpackage's ``NOT_OWED`` list with the
reason. Each subpackage imports first in a fresh interpreter without a
cycle, and the render child (``_RPPE_RENDER_WORKER=1``) loads no torch.

The quaternion functions of ``ops/pose_math.py`` match the reference's
in f32 within 1e-6 on seeded numpy inputs; ``random_quaternion`` draws
from a ``torch.Generator``, so its Shoemake map is fed JAX's own draws to
match the reference bit for bit in distribution, and the torch draws are
checked for unit norm and a second moment of I/4.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.ops import pose_math as jax_pm
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import pose_math as pm

REF = "rgb_proprioceptive_pose_estimator_tpu"
PORT = "rgb_proprioceptive_pose_estimator_tpu_torch"
SUBPACKAGES = ["models", "data", "engine", "losses", "ops", "parallel",
               "runtime", "utils"]
ATOL = 1e-6
# draws of the torch sampler: the second moment's estimate has a standard
# error of 0.25 / sqrt(N) ~ 1e-3 an entry, a tenth of the limit
DRAWS = 2 ** 16
MOMENT_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _resolve(module, path):
    obj = module
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("sub", ["", *SUBPACKAGES])
def test_every_reference_export_resolves_or_is_not_owed(sub):
    ref = importlib.import_module(f"{REF}.{sub}".rstrip("."))
    port = importlib.import_module(f"{PORT}.{sub}".rstrip("."))
    renamed = getattr(port, "REFERENCE_NAMES", {})
    not_owed = getattr(port, "NOT_OWED", {})
    assert set(renamed).isdisjoint(not_owed)
    for name in ref.__all__:
        if name in not_owed:
            assert not hasattr(port, name), name
            assert not_owed[name].strip(), name
            continue
        got = _resolve(port, renamed.get(name, name))
        want = getattr(ref, name)
        if isinstance(want, type(os)):      # a module: the port's twin
            assert got.__name__ == f"{PORT}.{sub}.{name}", name
        elif name not in renamed:           # the same kind of object
            assert callable(got) == callable(want), name
    # the port's own exports resolve, and only names of the reference's
    # or their counterparts are listed
    for name in port.__all__:
        getattr(port, name)
    assert set(port.__all__) <= (set(ref.__all__) | {
        path.split(".")[0] for path in renamed.values()}), sub
    for name in renamed:
        assert name in ref.__all__ and not hasattr(port, name), name


def test_version_and_build_model():
    import rgb_proprioceptive_pose_estimator_tpu as rppe
    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
    from rgb_proprioceptive_pose_estimator_tpu_torch.models import (
        PoseEstimator,
        build_model,
    )

    assert rppt.__version__ == rppe.__version__ == "0.1.0"
    assert "__version__" in rppt.__all__
    model = build_model(rppt.preset("pr1").model)
    assert isinstance(model, PoseEstimator)
    assert model.cfg == rppt.preset("pr1").model


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_each_subpackage_imports_first_in_a_fresh_interpreter(sub):
    """With the package __init__'s api import skipped, the subpackage is
    the first of the port imported after the config: a cycle among the
    subpackages' __init__s fails here. The data package keeps the render
    child's guard, so there it loads no torch and no pipeline."""
    code = (
        "import json, sys\n"
        f"import {PORT}.{sub} as m\n"
        "print(json.dumps({'missing': [n for n in m.__all__\n"
        "                              if not hasattr(m, n)],\n"
        "                  'torch': 'torch' in sys.modules}))\n")
    env = {**os.environ, "_RPPE_RENDER_WORKER": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    if sub == "data":
        assert got == {"missing": ["HostPipeline", "build_dataset"],
                       "torch": False}
    else:
        assert got["missing"] == []


def test_render_child_imports_no_torch():
    code = (
        "import sys\n"
        f"import {PORT}.data.playback\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'h5py', 'cv2', 'mujoco', 'matplotlib')))\n")
    env = {**os.environ, "_RPPE_RENDER_WORKER": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# the quaternion algebra against the reference
# ---------------------------------------------------------------------------


def _unit(rs, shape):
    q = rs.randn(*shape, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


# (shape of a, shape of b): equal batches, one side broadcast, a batch of
# batches against a row
PAIRS = [((8,), (8,)), ((1,), (8,)), ((8,), ()), ((2, 5), (5,)),
         ((3, 1), (1, 4))]


@pytest.mark.parametrize("sa,sb", PAIRS)
def test_quat_multiply_and_conjugate_match_the_reference(sa, sb):
    rs = np.random.RandomState(1)
    a, b = _unit(rs, sa), _unit(rs, sb)
    _close(pm.quat_multiply(_t(a), _t(b)), jax_pm.quat_multiply(a, b))
    _close(pm.quat_conjugate(_t(a)), jax_pm.quat_conjugate(a))
    # q * conj(q) is the identity
    ident = pm.quat_multiply(_t(a), pm.quat_conjugate(_t(a)))
    _close(ident, np.broadcast_to([1.0, 0.0, 0.0, 0.0], ident.shape))


@pytest.mark.parametrize("sq,sv", PAIRS)
def test_quat_rotate_matches_the_reference(sq, sv):
    rs = np.random.RandomState(2)
    q = _unit(rs, sq)
    v = rs.randn(*sv, 3).astype(np.float32)
    got = pm.quat_rotate(_t(q), _t(v))
    want = jax_pm.quat_rotate(q, v)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("saxis,sangle", [((8,), (8,)), ((), (8,)),
                                          ((2, 5), (2, 5)), ((1,), (6,))])
def test_quat_from_axis_angle_matches_the_reference(saxis, sangle):
    rs = np.random.RandomState(3)
    axis = rs.randn(*saxis, 3).astype(np.float32)
    if axis.ndim > 1:
        axis.reshape(-1, 3)[0] = 0.0                 # a zero axis
    angle = rs.uniform(-np.pi, np.pi, sangle).astype(np.float32)
    got = pm.quat_from_axis_angle(_t(axis), _t(angle))
    want = jax_pm.quat_from_axis_angle(axis, angle)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    assert torch.isfinite(got).all()


def test_quat_from_axis_angle_of_a_zero_axis_is_the_identity_rotation():
    angle = np.float32(0.7)
    got = pm.quat_from_axis_angle(torch.zeros(3), torch.tensor(angle))
    _close(got, jax_pm.quat_from_axis_angle(jnp.zeros(3), jnp.array(angle)))
    _close(got[1:], np.zeros(3))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)])
def test_shoemake_map_of_jax_draws_is_the_references_random_quaternion(
        shape):
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (3,) + shape))
    got = pm.quat_from_uniform(_t(u))
    want = jax_pm.random_quaternion(key, shape)
    assert tuple(got.shape) == want.shape == shape + (4,)
    _close(got, want)


def test_random_quaternion_is_uniform_on_the_sphere():
    gen = torch.Generator().manual_seed(5)
    q = pm.random_quaternion((DRAWS,), generator=gen)
    assert q.dtype == torch.float32 and q.shape == (DRAWS, 4)
    assert float((q.norm(dim=-1) - 1).abs().max()) <= ATOL
    moment = (q.double().T @ q.double()) / DRAWS
    assert float((moment - torch.eye(4, dtype=torch.float64) / 4
                  ).abs().max()) <= MOMENT_TOL
    # the generator decides the draws
    again = pm.random_quaternion((DRAWS,),
                                 generator=torch.Generator().manual_seed(5))
    assert torch.equal(q, again)
    assert pm.random_quaternion().shape == (4,)

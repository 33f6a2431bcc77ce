"""The port's pr1, pr2 and pr4 models against the JAX package on the CPU:
the proprio-only model (backbone "none"), CNNSmall with flax "SAME"
padding, the Bottleneck ResNet, ResNet-34 and ResNet-50, and remat.

Both sides get the same weights, made from a seed with numpy
(``random_variables_for``) in the JAX layout and converted with
``port_arrays``; inputs are seeded numpy arrays. Tolerances: forwards
rtol 1e-3, atol 1e-4 (tests/test_torch_model.py); parameter gradients
within 1e-4 of their tensor's largest and running statistics rtol 1e-5
(tests/test_torch_train.py): the same f32 math summed in other orders.
Train-mode cases use seeds whose ReLU inputs have no tie at 0 (a tie
moves its BatchNorm channel's gradients by percents; see
tests/test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import preset as jax_preset
from rgb_proprioceptive_pose_estimator_tpu.models.cnn_small import (
    CNNSmall as JaxCNNSmall,
)
from rgb_proprioceptive_pose_estimator_tpu.models.fusion import (
    build_model,
    example_batch,
)
from rgb_proprioceptive_pose_estimator_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    ConvBNReLU,
    same_padding,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.cnn_small import CNNSmall
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import (
    ResNet,
    ResNet34,
    ResNet50,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
    port_arrays,
    random_jax_variables,
    random_variables_for,
    state_dict_from_jax,
)

RTOL, ATOL = 1e-3, 1e-4
GRAD_REL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes are small, and the suite's test
    workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _with_weights(port_module, seed):
    """(port module with seeded weights, the same variables in the JAX
    layout)."""
    shapes = {k: tuple(v.shape) for k, v in port_module.state_dict().items()}
    variables = random_variables_for(shapes, seed)
    port_module.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in port_arrays(variables).items()}, strict=True)
    return port_module, variables


def _same_tree(jax_module, x, variables):
    """The JAX module's own init has the tree of ``variables``."""
    init = jax.eval_shape(lambda: jax_module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    ref = jax.tree.map(lambda a: tuple(a.shape), init)
    assert jax.tree.map(lambda a: tuple(a.shape), variables) == ref


def _images(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL)


def _train_parity(jax_module, port_module, variables, x, seed):
    """One train-mode forward and backward of sum(out * g) on both sides:
    values, every parameter's gradient and the running statistics."""
    shape = jax_module.apply(variables, jnp.asarray(x), train=False).shape
    g = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def f(params):
        out, mut = jax_module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut)

    (_, (jout, jmut)), jgrads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    want_grads = port_arrays({"params": jax.tree.map(np.asarray, jgrads)})
    want_stats = port_arrays({"batch_stats": jax.tree.map(np.asarray,
                                                          jmut["batch_stats"])})

    port_module.train()
    out = port_module(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), jout)
    named = dict(port_module.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        w = want_grads[k]
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (k, err, np.abs(w).max())
    buffers = dict(port_module.named_buffers())
    assert set(buffers) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), w, rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (64, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (64, 3, 1, (1, 1)),
    (4, 1, 2, (0, 0)), (7, 7, 2, (3, 3))])
def test_same_padding_is_flax(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


def test_conv_bn_relu_same_padding_matches_flax_at_stride_2():
    from rgb_proprioceptive_pose_estimator_tpu.models.blocks import (
        ConvBNReLU as JaxConvBNReLU,
    )

    x = _images((2, 16, 16, 8), seed=1)
    m, variables = _with_weights(
        ConvBNReLU(8, 16, (3, 3), (2, 2), "SAME").to(
            memory_format=torch.channels_last), seed=1)
    jm = JaxConvBNReLU(16, (3, 3), (2, 2))
    _same_tree(jm, x, variables)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.is_contiguous(memory_format=torch.channels_last)
    _close(out.permute(0, 2, 3, 1), jm.apply(variables, jnp.asarray(x),
                                             train=False))
    # torch's symmetric padding is another function: the trap this avoids
    sym = ConvBNReLU(8, 16, (3, 3), (2, 2), (1, 1)).eval()
    sym.load_state_dict(m.state_dict())
    with torch.no_grad():
        other = sym(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not torch.allclose(other, out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cnn_small_matches_jax(mode):
    x = _images((4, 64, 64, 3), seed=2)
    port, variables = _with_weights(CNNSmall(features=256), seed=2)
    jm = JaxCNNSmall(features=256)
    _same_tree(jm, x, variables)
    if mode == "eval":
        with torch.no_grad():
            out = port.eval()(torch.from_numpy(x))
        assert out.shape == (4, 256)
        _close(out, jm.apply(variables, jnp.asarray(x), train=False))
    else:
        _train_parity(jm, port, variables, x, seed=3)


def _bottleneck_pair(remat=False):
    port = ResNet((1, 1, 1, 1), "bottleneck", features=64, remat=remat)
    return port, JaxResNet(stage_sizes=(1, 1, 1, 1), block="bottleneck",
                           features=64)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_bottleneck_resnet_matches_jax(mode):
    # batch 4: at batch 2 the 1x1 maps of stage 4 give BatchNorm two
    # values per channel, and E[x^2] - E[x]^2 then cancels to a few bits
    # on both sides (3e-3 apart)
    x = _images((4, 32, 32, 3), seed=4)
    port, jm = _bottleneck_pair()
    port, variables = _with_weights(port, seed=4)
    _same_tree(jm, x, variables)
    # every stage's first block has its shortcut, stage 1's at stride 1
    assert [n for n, _ in port.named_modules()
            if n.endswith("downsample")] == [
        f"stage{s}_block0.downsample" for s in (1, 2, 3, 4)]
    if mode == "eval":
        with torch.no_grad():
            out = port.eval()(torch.from_numpy(x))
        _close(out, jm.apply(variables, jnp.asarray(x), train=False))
    else:
        _train_parity(jm, port, variables, x, seed=5)


@pytest.mark.parametrize("depth", [34, 50])
def test_resnet_34_and_50_eval_forward_matches_jax(depth):
    x = _images((2, 32, 32, 3), seed=6)
    port_cls = {34: ResNet34, 50: ResNet50}[depth]
    block = "basic" if depth == 34 else "bottleneck"
    port, variables = _with_weights(port_cls(features=128), seed=6)
    jm = JaxResNet(stage_sizes=(3, 4, 6, 3), block=block, features=128)
    _same_tree(jm, x, variables)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    _close(out, jm.apply(variables, jnp.asarray(x), train=False))


def _cfgs(name, **overrides):
    jcfg = jax_preset(name).override(**overrides)
    return jcfg, Config.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("name,overrides", [
    ("pr1", {}),
    ("pr2", {"model.use_proprio": True}),
    ("pr4", {"model.image_size": 32, "model.dtype": "float32"}),
], ids=["pr1", "pr2", "pr4"])
def test_pose_estimator_matches_jax(name, overrides):
    jcfg, cfg = _cfgs(name, **overrides)
    variables = random_jax_variables(cfg.model, seed=7)
    batch = example_batch(jcfg.model, batch_size=2, rng=7)
    jpos, jquat = build_model(jcfg.model).apply(variables, batch, train=False)
    model = PoseEstimator(cfg.model).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg.model))
    tb = {"proprio": torch.from_numpy(batch["proprio"])} \
        if "proprio" in batch else {}
    if "images" in batch:
        tb["images"] = {c: torch.from_numpy(v)
                        for c, v in batch["images"].items()}
    with torch.no_grad():
        pos, quat = model(tb)
    _close(pos, jpos)
    _close(quat, jquat)


@pytest.mark.parametrize("name", ["pr1", "pr2", "pr4"])
def test_state_dict_from_jax_takes_the_jax_init_tree(name):
    # the tree the JAX package's own init makes (shapes only): the strict
    # converter fills every port key from it, with no leaf left over
    jcfg, cfg = _cfgs(name)
    model = build_model(jcfg.model)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), example_batch(jcfg.model, 1), train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros, cfg.model)
    assert sum(v.numel() for k, v in sd.items()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


def _remat_step(remat, seed=8):
    torch.manual_seed(0)
    port, _ = _bottleneck_pair(remat=remat)
    port, _ = _with_weights(port, seed=seed)
    x = torch.from_numpy(_images((2, 32, 32, 3), seed=seed))
    port.train()
    out = port(x)
    loss = (out * out).mean()
    loss.backward()
    return (loss.detach(),
            {k: p.grad.clone() for k, p in port.named_parameters()},
            {k: b.clone() for k, b in port.named_buffers()})


def test_remat_equals_no_remat_bit_for_bit():
    plain = _remat_step(False)
    remat = _remat_step(True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[1:], remat[1:]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_remat_without_frozen_statistics_updates_them_twice(monkeypatch):
    # the trap the recomputation context avoids: torch.utils.checkpoint
    # re-runs each block's forward, and with it the running update
    import contextlib

    from rgb_proprioceptive_pose_estimator_tpu_torch.models import resnet

    plain = _remat_step(False)
    monkeypatch.setattr(resnet, "running_stats_frozen",
                        lambda module: contextlib.nullcontext())
    twice = _remat_step(True)
    assert torch.equal(plain[0], twice[0])
    moved = [k for k in plain[2] if k.endswith("running_mean")
             and not torch.equal(plain[2][k], twice[2][k])]
    assert moved and all(k.startswith("stage") for k in moved)

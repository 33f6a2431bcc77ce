"""Weights between the JAX package's variable tree and the port's
``state_dict``.

The JAX tree is ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays, keyed by flax module names, which the port's modules share:

    params/.../conv/kernel (kh, kw, in, out)  -> .../conv.weight (out, in, kh, kw)
    params/.../<dense>/kernel (in, out)       -> .../<dense>.weight (out, in)
    params/.../bias                           -> .../bias
    params/.../bn/scale                       -> .../bn.weight
    batch_stats/.../bn/mean, var              -> .../bn.running_mean, running_var
    batch_stats/proprio/proprio_mean, _std    -> proprio.proprio_mean, _std

The conversion is strict: every JAX leaf is consumed and every port key is
filled, with the port's shape, or it raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import ModelConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import PoseEstimator

_STATS_TO_PORT = {"mean": "running_mean", "var": "running_var",
                  "proprio_mean": "proprio_mean", "proprio_std": "proprio_std"}
_STATS_TO_JAX = {v: k for k, v in _STATS_TO_PORT.items()}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def port_shapes(model_cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """{state_dict key: shape} of the port's PoseEstimator for model_cfg,
    built on the meta device (no memory, no init)."""
    with torch.device("meta"):
        model = PoseEstimator(model_cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def state_dict_from_jax(variables: Mapping[str, Any],
                        model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's variables for model_cfg -> the port's state_dict
    (f32 CPU tensors). Raises ValueError on a leaf the port has no place
    for, a port key no leaf fills, or a shape that differs."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections {sorted(unknown)}")
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: np.ndarray, path: Tuple[str, ...]) -> None:
        if key in out:
            raise ValueError(f"two leaves map to {key!r} (second: "
                             f"{'/'.join(path)})")
        out[key] = value

    for path, leaf in _leaves(variables.get("params", {})):
        *mods, name = path
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel" and a.ndim == 4:          # conv HWIO -> OIHW
            key, a = "weight", a.transpose(3, 2, 0, 1)
        elif name == "kernel" and a.ndim == 2:        # dense (in, out)
            key, a = "weight", a.T
        elif name == "scale" and a.ndim == 1:         # BN gamma
            key = "weight"
        elif name == "bias" and a.ndim == 1:
            key = "bias"
        else:
            raise ValueError(f"params/{'/'.join(path)} {a.shape}: no "
                             "counterpart in the port")
        put(".".join(mods + [key]), a, path)
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mods, name = path
        if name not in _STATS_TO_PORT:
            raise ValueError(f"batch_stats/{'/'.join(path)}: no counterpart "
                             "in the port")
        put(".".join(mods + [_STATS_TO_PORT[name]]),
            np.asarray(leaf, dtype=np.float32), path)

    shapes = port_shapes(model_cfg)
    missing = sorted(set(shapes) - set(out))
    extra = sorted(set(out) - set(shapes))
    wrong = sorted(k for k in set(shapes) & set(out)
                   if tuple(out[k].shape) != shapes[k])
    if missing or extra or wrong:
        raise ValueError(
            "JAX variables do not fit the port's model: "
            f"missing {missing}, extra {extra}, "
            f"shape differs {[(k, out[k].shape, shapes[k]) for k in wrong]}")
    return {k: torch.tensor(np.ascontiguousarray(out[k])) for k in shapes}


def _jax_leaf(key: str, value: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Port key and value -> (path in the JAX tree, value in JAX layout)."""
    *mods, name = key.split(".")
    if name in _STATS_TO_JAX:
        return ("batch_stats", *mods, _STATS_TO_JAX[name]), value
    if name == "weight" and value.ndim == 4:
        return ("params", *mods, "kernel"), value.transpose(2, 3, 1, 0)
    if name == "weight" and value.ndim == 2:
        return ("params", *mods, "kernel"), value.T
    if name == "weight":
        return ("params", *mods, "scale"), value
    return ("params", *mods, name), value


def random_jax_variables(model_cfg: ModelConfig, seed: int = 0
                         ) -> Dict[str, Any]:
    """Random variables in the JAX package's layout for model_cfg, made
    from ``seed`` with numpy: He-normal (fan out) convs, LeCun-normal
    dense kernels, and biases, BatchNorm affines and running statistics
    and proprio statistics far enough from identity that every folded
    scale and shift matters."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for key, shape in port_shapes(model_cfg).items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight" and len(shape) == 4:
            fan_out = shape[0] * shape[2] * shape[3]
            v = rng.normal(0.0, np.sqrt(2.0 / fan_out), shape)
        elif name == "weight" and len(shape) == 2:
            v = rng.normal(0.0, np.sqrt(1.0 / shape[1]), shape)
        elif name == "weight":                       # BN gamma
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "running_mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif name == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "proprio_mean":
            v = rng.normal(0.0, 1.0, shape)
        elif name == "proprio_std":
            v = rng.uniform(0.5, 2.0, shape)
        else:
            raise ValueError(f"no random init for {key}")
        path, v = _jax_leaf(key, v.astype(np.float32))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return tree

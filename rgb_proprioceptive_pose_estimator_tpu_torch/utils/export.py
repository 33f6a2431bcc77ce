"""Serving artifacts (counterpart of the JAX package's ``utils/export.py``):
a trained pose estimator as one self-contained file, a ``torch.export``
program with a fixed batch shape and its weights, which a serving process
loads and calls without the model code, the config system or a
checkpoint.

    # training side
    export_predictor("/models/pose.rppe", cfg, ckpt_dir=...)

    # serving side
    serve = load_predictor("/models/pose.rppe")           # on cuda
    pos, quat = serve({"images": {...}, "proprio": ...})  # batch <= max_batch

The artifact is a zip of ``meta.json`` (magic, max_batch, quantize, the
config and the input tree with its dtypes) and ``program.pt2``
(``torch.export.save``). The hand kernels stay in the program as the ops
``rppe::normalize_u8`` and ``rppe::scale_bias_relu`` (ops/fused.py), which
launch them on CUDA tensors and run their plain versions on CPU ones.

``quantize="int8"``: weight-only, symmetric, per output channel, as the
reference's ``_quantize_params``: every parameter that is a flax
``kernel`` of two or more dims (convolutions, dense layers, the ViT's
attention), with one scale per index of the *last* axis of its flax
layout (per E/H column of a (E, H, E/H) query kernel, shared by the
heads). The program stores the int8 weights and their scales, and
dequantizes them when it runs; nothing folds them back into f32.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config, ModelConfig

MAGIC = "rppe-predictor-torch-v1"
QUANTIZE = ("none", "int8")


def quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A flax kernel -> (int8 q, f32 scale): the reference's formula, one
    scale per index of the last axis."""
    w = np.asarray(w, np.float32)
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantized_weights(state_dict: Dict[str, torch.Tensor]
                      ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{state_dict key: (q, scale)} for every parameter that is a flax
    kernel of two or more dims, q int8 in the port's layout (so that
    q.float() times the scale along the output axis is the dequantized
    weight), scale f32."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        jax_leaf,
        port_kernel,
    )

    out = {}
    for key, value in state_dict.items():
        path, flax = jax_leaf(key, value.detach().cpu().numpy())
        if path[0] == "params" and path[-1] == "kernel" and flax.ndim >= 2:
            q, scale = quantize_kernel(flax)
            out[key] = (torch.from_numpy(np.ascontiguousarray(
                port_kernel(q))), torch.from_numpy(scale))
    return out


def _buffer_name(kind: str, key: str) -> str:
    return f"{kind}__{key.replace('.', '__')}"


class _Served(nn.Module):
    """``model`` (eval mode) without parameters of its own: each forward
    gives it the weights this module holds as buffers, int8 ones
    dequantized there (functional_call)."""

    def __init__(self, model: nn.Module, state_dict: Dict[str, torch.Tensor],
                 quantize: str):
        super().__init__()
        model.load_state_dict(state_dict, strict=True)
        self.model = model.eval()
        self.names = [n for n, _ in model.named_parameters()]
        for name in self.names:
            owner, leaf = name.rsplit(".", 1)
            del model.get_submodule(owner)._parameters[leaf]
        self.quantized = (quantized_weights({n: state_dict[n]
                                             for n in self.names})
                          if quantize == "int8" else {})
        for name in self.names:
            if name in self.quantized:
                q, scale = self.quantized[name]
                self.register_buffer(_buffer_name("q", name), q)
                self.register_buffer(_buffer_name("scale", name), scale)
            else:
                self.register_buffer(_buffer_name("w", name),
                                     state_dict[name].detach().float()
                                     .clone())

    def weights(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.names:
            if name in self.quantized:
                q = getattr(self, _buffer_name("q", name))
                scale = getattr(self, _buffer_name("scale", name))
                # the scale runs along the flax layout's last axis: the
                # port's first for convolutions and dense layers
                shape = ((-1,) + (1,) * (q.ndim - 1) if q.ndim in (2, 4)
                         else (-1,))
                w = q.float() * scale.view(shape)
            else:
                w = getattr(self, _buffer_name("w", name))
            if w.ndim == 4:
                w = w.contiguous(memory_format=torch.channels_last)
            out[name] = w
        return out

    def forward(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        return torch.func.functional_call(self.model, self.weights(),
                                          (batch,), strict=False)


def example_inputs(model_cfg: ModelConfig, batch_size: int
                   ) -> Dict[str, Any]:
    """A zero batch of the model's inputs (the serving tree, no targets)
    on the CPU: images uint8 (B, [T,] H, W, 3) per camera, proprio f32
    (B, [T,] D)."""
    t = (model_cfg.temporal_frames,) if model_cfg.temporal_frames > 1 \
        else ()
    batch: Dict[str, Any] = {}
    if model_cfg.backbone != "none":
        hw = model_cfg.image_size
        batch["images"] = {c: torch.zeros((batch_size, *t, hw, hw, 3),
                                          dtype=torch.uint8)
                           for c in model_cfg.cameras}
    if model_cfg.use_proprio:
        batch["proprio"] = torch.zeros((batch_size, *t,
                                        model_cfg.proprio_dim))
    return batch


def _dtype_tree(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_dtype_tree(v) if isinstance(v, dict)
                else str(v.numpy().dtype)) for k, v in batch.items()}


def export_predictor(path: str, cfg: Config, state=None,
                     ckpt_dir: Optional[str] = None, step=None,
                     max_batch: int = 8, quantize: str = "none") -> str:
    """Export the weights a checkpoint serves (that ``step`` names in
    ``ckpt_dir``, default train.ckpt_dir's latest; or those of a training
    ``state``), the EMA's where train.ema_decay kept one, as an artifact
    at ``path`` with batch ``max_batch``. The program is traced on the
    CPU and moved to the serving device when loaded."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be 'none' or 'int8', got "
                         f"{quantize!r}")
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if state is not None:
        weights = state.serving_state_dict()
    else:
        ckpt, _ = checkpoint.resolve(ckpt_dir or cfg.train.ckpt_dir, step)
        weights = checkpoint.load(ckpt)[1]
    weights = {k: v.detach().cpu() for k, v in weights.items()}
    served = _Served(PoseEstimator(cfg.model), weights, quantize)
    batch = example_inputs(cfg.model, max_batch)
    with torch.no_grad():
        program = torch.export.export(served, (batch,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "magic": MAGIC,
        "max_batch": max_batch,
        "quantize": quantize,
        "quantized": sorted(served.quantized),
        "config": cfg.to_dict(),
        "input_tree": {k: (sorted(v) if isinstance(v, dict) else None)
                       for k, v in batch.items()},
        "dtypes": _dtype_tree(batch),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=2))
        z.writestr("program.pt2", buf.getvalue())
    return path


def _cast(b: Any, d: Any) -> Any:
    """Lists and other dtypes (float64 robot states) as the exported
    input's dtype, walking dicts (not as pytrees: a list is an array)."""
    if isinstance(b, dict):
        return {k: _cast(v, d.get(k) if isinstance(d, dict) else None)
                for k, v in b.items()}
    return np.asarray(b, dtype=np.dtype(d) if isinstance(d, str) else None)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_predictor(path: str,
                   device: Union[str, torch.device, None] = None
                   ) -> Callable[[Dict[str, Any]],
                                 Tuple[np.ndarray, np.ndarray]]:
    """Load an artifact onto ``device`` (CUDA by default; the CPU only when
    asked); returns ``fn(batch) -> (pos, quat)`` (f32 numpy), with the
    artifact's meta under ``fn.meta``. The batch may be any size up to
    max_batch: it is padded with its last row to the program's shape and
    the answers trimmed; a larger one raises ValueError. Neither the model
    nor a checkpoint is read."""
    # registers rppe::normalize_u8 and rppe::scale_bias_relu, which the
    # program calls
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused  # noqa: F401
    from torch.export.passes import move_to_device_pass

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_predictor runs on CUDA by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the kernels' plain versions on the CPU")
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path} is not a port predictor artifact "
                             f"(magic {meta.get('magic')!r}, want {MAGIC!r})")
        program = torch.export.load(io.BytesIO(z.read("program.pt2")))
    module = move_to_device_pass(program, dev).module()
    max_batch = int(meta["max_batch"])
    dtypes = meta["dtypes"]

    def fn(batch: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        arrs = _cast({k: batch[k] for k in dtypes}, dtypes)
        n = next(_leaves(arrs)).shape[0]
        if n > max_batch:
            raise ValueError(f"batch {n} > exported max_batch {max_batch}")

        def pad(x: np.ndarray) -> torch.Tensor:
            if x.shape[0] < max_batch:
                x = np.concatenate(
                    [x, np.repeat(x[-1:], max_batch - x.shape[0], axis=0)])
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        with torch.inference_mode():
            pos, quat = module(_map(pad, arrs))
        return (pos[:n].float().cpu().numpy(),
                quat[:n].float().cpu().numpy())

    fn.meta = meta  # type: ignore[attr-defined]
    return fn

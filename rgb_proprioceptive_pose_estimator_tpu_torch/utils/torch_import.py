"""torchvision ResNet weights into the port's camera encoders
(``train.init_from_torch``; counterpart of the ResNet part of the JAX
package's ``utils/torch_import.py``).

Give it a torchvision resnet18/34/50 ``state_dict()`` (torch tensors or
numpy arrays, from an ``.npz`` archive of its keys or a torch-pickled
file) and it fills one ``encoder_<camera>`` of a PoseEstimator's
state_dict. The port's encoders already keep torch's layouts, so the
mapping renames and does not transpose:

    conv1.weight                  -> stem.conv.weight
    bn1.*                         -> stem.bn.*
    layer{L}.{B}.conv{K}.weight   -> stage{L}_block{B}.conv{K}.conv.weight
    layer{L}.{B}.bn{K}.*          -> stage{L}_block{B}.conv{K}.bn.*
    layer{L}.{B}.downsample.0/1.* -> stage{L}_block{B}.downsample.conv/bn.*
    fc.*                          -> dropped (the pose projection replaces
                                     the classifier, as in the reference)

(``bn.*`` is weight, bias, running_mean and running_var.) The encoder's
``proj`` keeps its own initialization. The ViT mapping comes with the ViT
backbone (ROADMAP.md queue A, item 10).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping

import numpy as np
import torch

_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
           "resnet50": (3, 4, 6, 3)}
_CONVS = {"resnet18": 2, "resnet34": 2, "resnet50": 3}
_BN = ("weight", "bias", "running_mean", "running_var")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A backbone state_dict from disk: an ``.npz`` whose entry names are
    the torch state_dict keys, or a torch-pickled file
    (``.pt``/``.pth``/``.bin``/``.ckpt``; another suffix warns and is
    tried all the same), read with ``torch.load(weights_only=True)``; a
    container whose weights sit under ``"state_dict"`` is unwrapped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if not path.endswith((".pt", ".pth", ".bin", ".ckpt")):
        warnings.warn(
            f"{path}: unrecognized state_dict extension; attempting "
            "torch.load(weights_only=True) anyway. Expected .npz (numpy "
            "archive) or a torch-pickled .pt/.pth/.bin/.ckpt.",
            stacklevel=2)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: _np(v) for k, v in sd.items()}


def import_torch_resnet(state_dict: Mapping[str, Any], arch: str
                        ) -> Dict[str, np.ndarray]:
    """torchvision resnet state_dict -> {encoder state_dict key: f32
    array} for the port's ResNet of ``arch`` (the backbone only)."""
    if arch not in _STAGES:
        raise ValueError(f"arch must be one of {sorted(_STAGES)}, got "
                         f"{arch!r}")
    out: Dict[str, np.ndarray] = {}

    def conv_bn(torch_conv: str, torch_bn: str, port: str) -> None:
        out[f"{port}.conv.weight"] = _np(
            state_dict[f"{torch_conv}.weight"]).astype(np.float32)
        for name in _BN:
            out[f"{port}.bn.{name}"] = _np(
                state_dict[f"{torch_bn}.{name}"]).astype(np.float32)

    conv_bn("conv1", "bn1", "stem")
    for stage, n_blocks in enumerate(_STAGES[arch], start=1):
        for b in range(n_blocks):
            t, port = f"layer{stage}.{b}", f"stage{stage}_block{b}"
            for k in range(1, _CONVS[arch] + 1):
                conv_bn(f"{t}.conv{k}", f"{t}.bn{k}", f"{port}.conv{k}")
            if f"{t}.downsample.0.weight" in state_dict:
                conv_bn(f"{t}.downsample.0", f"{t}.downsample.1",
                        f"{port}.downsample")
    return out


def load_pretrained_backbone(model: torch.nn.Module, camera: str,
                             state_dict: Mapping[str, Any], arch: str
                             ) -> None:
    """Copy torchvision ResNet weights into ``model``'s
    ``encoder_<camera>`` in place, running statistics included; raises
    KeyError for a key the encoder lacks and ValueError for a shape that
    differs (another architecture, or T frames stacked on channels)."""
    enc = f"encoder_{camera}"
    if not hasattr(model, enc):
        raise KeyError(f"no encoder {enc!r}; have "
                       f"{sorted(n for n, _ in model.named_children())}")
    target = getattr(model, enc).state_dict()
    weights = import_torch_resnet(state_dict, arch)
    for k, v in weights.items():
        if k not in target:
            raise KeyError(f"backbone key {k!r} missing in {enc} "
                           "(arch mismatch?)")
        if tuple(target[k].shape) != v.shape:
            raise ValueError(f"shape mismatch at {enc}.{k}: "
                             f"{tuple(target[k].shape)} vs {v.shape}")
    with torch.no_grad():
        for k, v in weights.items():
            target[k].copy_(torch.from_numpy(v))

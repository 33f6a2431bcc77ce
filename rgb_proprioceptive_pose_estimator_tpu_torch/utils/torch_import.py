"""torchvision ResNet and VisionTransformer weights into the port's camera
encoders (``train.init_from_torch``; counterpart of the JAX package's
``utils/torch_import.py``).

Give it a torchvision resnet18/34/50 or vit_b_16-style ``state_dict()`` (torch tensors or
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

(``bn.*`` is weight, bias, running_mean and running_var.) The ViT's
(``model.vit_pool="cls"``) splits torch's packed attention projections
into flax's per-head kernels, which the port's ViT keeps:

    conv_proj.*                          -> patch_embed.*
    class_token                          -> cls_token
    encoder.pos_embedding                -> pos_embed (class token first)
    encoder.layers.encoder_layer_{i}.
      ln_1.*, ln_2.*                     -> block{i}.ln1.*, .ln2.*
      self_attention.in_proj_weight (3E, E) rows [q; k; v]
                                         -> block{i}.attn.{query,key,value}
                                            .weight (E, H, E/H): each (E, E)
                                            slice transposed, then split
      self_attention.in_proj_bias        -> .bias (H, E/H)
      self_attention.out_proj.weight     -> block{i}.attn.out.weight
                                            (H, E/H, E), transposed
      mlp.0.*, mlp.3.*                   -> block{i}.mlp1.*, .mlp2.*
    encoder.ln.*                         -> ln_out.*
    heads.*                              -> dropped

The encoder's ``proj`` keeps its own initialization.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional

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


def import_torch_vit(state_dict: Mapping[str, Any], depth: int,
                     heads: int) -> Dict[str, np.ndarray]:
    """torchvision VisionTransformer state_dict -> {encoder state_dict key:
    f32 array} for the port's ViT with pool="cls" of ``depth`` blocks and
    ``heads`` heads (the backbone only)."""
    dim = _np(state_dict["class_token"]).shape[-1]
    hd = dim // heads

    def f32(key: str) -> np.ndarray:
        return _np(state_dict[key]).astype(np.float32)

    out = {"patch_embed.weight": f32("conv_proj.weight"),
           "patch_embed.bias": f32("conv_proj.bias"),
           "cls_token": f32("class_token"),
           "pos_embed": f32("encoder.pos_embedding"),
           "ln_out.weight": f32("encoder.ln.weight"),
           "ln_out.bias": f32("encoder.ln.bias")}
    for i in range(depth):
        t, port = f"encoder.layers.encoder_layer_{i}", f"block{i}"
        w = f32(f"{t}.self_attention.in_proj_weight")
        b = f32(f"{t}.self_attention.in_proj_bias")
        for j, name in enumerate(("query", "key", "value")):
            rows = slice(j * dim, (j + 1) * dim)
            out[f"{port}.attn.{name}.weight"] = np.ascontiguousarray(
                w[rows].T.reshape(dim, heads, hd))
            out[f"{port}.attn.{name}.bias"] = b[rows].reshape(heads, hd)
        out[f"{port}.attn.out.weight"] = np.ascontiguousarray(
            f32(f"{t}.self_attention.out_proj.weight").T.reshape(
                heads, hd, dim))
        out[f"{port}.attn.out.bias"] = f32(
            f"{t}.self_attention.out_proj.bias")
        for tn, pn in (("ln_1", "ln1"), ("ln_2", "ln2"), ("mlp.0", "mlp1"),
                       ("mlp.3", "mlp2")):
            for leaf in ("weight", "bias"):
                out[f"{port}.{pn}.{leaf}"] = f32(f"{t}.{tn}.{leaf}")
    return out


def load_pretrained_backbone(model: torch.nn.Module, camera: str,
                             state_dict: Mapping[str, Any], arch: str,
                             depth: Optional[int] = None,
                             heads: Optional[int] = None) -> None:
    """Copy torchvision weights into ``model``'s ``encoder_<camera>`` in
    place, running statistics included. ``arch``: resnet18/34/50, or
    "vit" (the torchvision VisionTransformer layout; ``depth`` and
    ``heads`` default to the encoder's, and an import of fewer blocks than
    the encoder has raises ValueError). Raises KeyError for a key the
    encoder lacks and ValueError for a shape that differs (another
    architecture, an image size with another token count, or T frames
    stacked on channels)."""
    enc = f"encoder_{camera}"
    if not hasattr(model, enc):
        raise KeyError(f"no encoder {enc!r}; have "
                       f"{sorted(n for n, _ in model.named_children())}")
    encoder = getattr(model, enc)
    target = encoder.state_dict()
    if arch == "vit":
        blocks = getattr(encoder, "blocks", [])
        depth = len(blocks) if depth is None else depth
        heads = (getattr(encoder, blocks[0]).attn.query.heads
                 if heads is None and blocks else heads)
        weights = import_torch_vit(state_dict, depth, heads)
        missing = sorted(b for b in blocks
                         if f"{b}.attn.query.weight" not in weights)
        if missing:
            raise ValueError(
                f"imported ViT covers {depth} blocks but {enc} has "
                f"{len(blocks)}; blocks left uninitialized: {missing} "
                "(pass the encoder's actual depth)")
    else:
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

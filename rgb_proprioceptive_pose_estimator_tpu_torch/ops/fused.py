"""Wrappers of the hand-written CUDA kernels in ``csrc/fused.cu``, and
their plain PyTorch versions.

- ``normalize_u8``: uint8 image -> f32/bf16 ``x * (1/(255 std)) - mean/std``
  in one pass (the JAX package's ``pallas_normalize_u8``).
- ``scale_bias_relu``: ``relu(x * scale + bias)`` per channel, the
  eval-mode BatchNorm + ReLU epilogue (the forward of the JAX package's
  ``scale_bias_relu``).

A wrapper checks its inputs the same way on every device. A tensor on the
CPU then goes to the plain version (``*_reference``); a CUDA tensor goes
to the kernel, or the wrapper raises: it never falls back. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops import _build

# most per-channel constants normalize_u8 takes (kMaxStats in csrc/fused.cu)
MAX_STATS = 64
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.rppe_normalize_u8.argtypes = [ptr, ptr, i64, i32, fptr, fptr, i32,
                                      i32, ptr]
    lib.rppe_normalize_u8.restype = i32
    lib.rppe_scale_bias_relu.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                         i32, ptr]
    lib.rppe_scale_bias_relu.restype = i32
    lib.rppe_error_string.argtypes = [i32]
    lib.rppe_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.rppe_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} "
                           f"(cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got one on "
                         f"{t.device}")


# ---------------------------------------------------------------------------
# normalize_u8
# ---------------------------------------------------------------------------


def _normalize_constants(mean: Sequence[float], std: Sequence[float]
                         ) -> Tuple[List[float], List[float]]:
    # the host-side constants of pallas_fused.py:87-88, in double precision
    scale = [1.0 / (255.0 * s) for s in std]
    shift = [-m / s for m, s in zip(mean, std)]
    return scale, shift


def normalize_u8_reference(images: torch.Tensor, mean: Sequence[float],
                           std: Sequence[float],
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of normalize_u8: the same f32 constants and op order."""
    scale, shift = _normalize_constants(mean, std)
    reps = images.shape[-1] // len(mean)
    s = torch.tensor(scale, dtype=torch.float32, device=images.device)
    b = torch.tensor(shift, dtype=torch.float32, device=images.device)
    return (images.float() * s.repeat(reps) + b.repeat(reps)).to(dtype)


def normalize_u8(images: torch.Tensor, mean: Sequence[float],
                 std: Sequence[float],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., C) -> ``dtype`` (f32 or bf16), ``(x/255 - mean)/std``
    computed as ``x * (1/(255 std)) + (-mean/std)`` in f32.

    ``mean``/``std`` have one entry per channel of a period that C is a
    multiple of (3 for RGB; C = 3T for T stacked frames). ``images`` must
    be contiguous: the wrapper never copies."""
    if images.dtype != torch.uint8:
        raise TypeError(f"normalize_u8 expects uint8 images, got {images.dtype}")
    if dtype not in _FLOAT_TYPES:
        raise TypeError(f"normalize_u8 writes float32 or bfloat16, not {dtype}")
    nstats = len(mean)
    if len(std) != nstats or not 1 <= nstats <= MAX_STATS:
        raise ValueError(f"mean ({len(mean)}) and std ({len(std)}) must have "
                         f"the same length, between 1 and {MAX_STATS}")
    if images.ndim == 0 or images.shape[-1] % nstats:
        raise ValueError(f"channel dim of {tuple(images.shape)} is not a "
                         f"multiple of the stats length {nstats}")
    if not images.is_contiguous():
        raise ValueError("normalize_u8 expects contiguous images")
    if images.device.type == "cpu":
        return normalize_u8_reference(images, mean, std, dtype)
    _require_cuda(images, "normalize_u8")
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if out.numel() == 0:
        return out
    scale, shift = _normalize_constants(mean, std)
    lib = _lib()
    err = lib.rppe_normalize_u8(
        images.data_ptr(), out.data_ptr(), out.numel(), nstats,
        (ctypes.c_float * nstats)(*scale), (ctypes.c_float * nstats)(*shift),
        int(dtype == torch.bfloat16), images.device.index, _stream(images))
    _check_launch(lib, err, "normalize_u8")
    normalize_u8.launches += 1
    return out


normalize_u8.launches = 0


# ---------------------------------------------------------------------------
# scale_bias_relu
# ---------------------------------------------------------------------------


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of scale_bias_relu: f32 math, output in x's dtype."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = x.float() * scale.view(shape) + bias.view(shape)
    return torch.clamp_min(y, 0.0).to(x.dtype)


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """relu(x * scale + bias) with f32 per-channel scale and bias, in f32,
    written in x's dtype (f32 or bf16).

    x is NCHW in ``channels_last`` memory or (M, C) contiguous, so that
    channels are innermost; C = x.shape[1]. The output keeps x's layout.
    Forward only: a tensor that needs grad raises."""
    if x.dtype not in _FLOAT_TYPES:
        raise TypeError(f"scale_bias_relu expects float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale_bias_relu expects float32 scale and bias")
    if x.ndim == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("scale_bias_relu expects a 4-D x in "
                             "channels_last memory (channels innermost)")
    elif x.ndim == 2:
        if not x.is_contiguous():
            raise ValueError("scale_bias_relu expects a contiguous 2-D x")
    else:
        raise ValueError(f"scale_bias_relu expects a 4-D or 2-D x, got "
                         f"{x.ndim}-D")
    c = x.shape[1]
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale_bias_relu expects contiguous scale and bias")
    if not (scale.device == bias.device == x.device):
        raise ValueError("x, scale and bias must be on one device")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError(
            "scale_bias_relu is forward-only in this port; its backward "
            "kernel comes with the training slice (run under "
            "torch.no_grad() or torch.inference_mode())")
    if x.device.type == "cpu":
        return scale_bias_relu_reference(x, scale, bias)
    _require_cuda(x, "scale_bias_relu")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.rppe_scale_bias_relu(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.numel(), c, int(x.dtype == torch.bfloat16), x.device.index,
        _stream(x))
    _check_launch(lib, err, "scale_bias_relu")
    scale_bias_relu.launches += 1
    return out


scale_bias_relu.launches = 0

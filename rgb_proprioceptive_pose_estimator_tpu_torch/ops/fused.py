"""Wrappers of the hand-written CUDA kernels in ``csrc/fused.cu``, and
their plain PyTorch versions.

- ``normalize_u8``: uint8 image -> f32/bf16 ``x * (1/(255 std)) - mean/std``
  in one pass (the JAX package's ``pallas_normalize_u8``).
- ``scale_bias_relu``: ``relu(x * scale + bias)`` per channel, the
  BatchNorm + ReLU epilogue (the JAX package's ``scale_bias_relu``),
  whose gradient is the kernel ``scale_bias_relu_backward`` (the JAX
  package's ``_sbr_bwd``).
- ``channel_stats``: per-channel f32 (sum x, sum x^2) in one read of x,
  the BatchNorm training statistics (the JAX package's ``channel_stats``).
- ``bn_affine_act``, ``bn_act_sums``, ``bn_act_dx``: the epilogue of
  training BatchNorm (``ops/fused_bn.py``), with or without its ReLU: the
  forward ``act(x * scale + bias)``, then the closed-form backward's two
  passes, the per-channel sums ``sum(gm)`` and ``sum(gm * x)`` of the
  gradient the ReLU passes, and ``dx = gm*a + x*b + c`` (XLA in the JAX
  package, so a design for the card rather than a port).

A wrapper checks its inputs the same way on every device. A tensor on the
CPU then goes to the plain version (``*_reference``); a CUDA tensor goes
to the kernel, or the wrapper raises: it never falls back. Each wrapper
counts its kernel launches in ``<wrapper>.launches``; every call is one
launch. The kernels move 16 bytes per access; a launch that moves one
element per access instead (C not a multiple of 16 bytes' worth, or a
pointer not 16-byte aligned) is also counted in
``<wrapper>.scalar_launches``. normalize_u8, scale_bias_relu,
bn_affine_act and bn_act_dx equal their plain versions exactly (NaN where
they have NaN; bn_act_dx given the same sums); the three reductions are
deterministic: the same input gives bitwise-equal sums.

normalize_u8 and scale_bias_relu are the torch ops ``rppe::normalize_u8``
and ``rppe::scale_bias_relu`` (``torch.library`` custom ops with a fake
kernel for tracing, the second with its gradient registered), which the
wrappers call after their checks. ``torch.export`` keeps them as nodes of
the graph, so an exported model launches the same kernels; the choice
between kernel and plain version is made where the op runs, by the device
of its input.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

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
    # blocks, n_vec, vec_stride, scalar_stride
    lib.rppe_normalize_u8.argtypes = [ptr, ptr, i64, i32, fptr, fptr, i32,
                                      i32, i64, i32, i32, i32, ptr]
    lib.rppe_normalize_u8.restype = i32
    plan = [i32] * 5                  # vec, tx, tiles, groups, rows
    lib.rppe_scale_bias_relu.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                         *plan, i32, ptr]
    lib.rppe_scale_bias_relu.restype = i32
    lib.rppe_channel_stats.argtypes = [ptr, i64, i32, i32, *plan, ptr, ptr,
                                       ptr, ptr, i32, ptr]
    lib.rppe_channel_stats.restype = i32
    lib.rppe_scale_bias_relu_backward.argtypes = [ptr, ptr, ptr, ptr, i64,
                                                  i32, i32, *plan, ptr, ptr,
                                                  ptr, ptr, ptr, i32, ptr]
    lib.rppe_scale_bias_relu_backward.restype = i32
    lib.rppe_bn_affine_act.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                       *plan, i32, ptr]
    lib.rppe_bn_affine_act.restype = i32
    lib.rppe_bn_act_sums.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                     *plan, ptr, ptr, ptr, ptr, i32, ptr]
    lib.rppe_bn_act_sums.restype = i32
    lib.rppe_bn_act_dx.argtypes = [ptr] * 9 + [ctypes.c_float, i64, i32, i32,
                                               i32, *plan, ptr, i32, ptr]
    lib.rppe_bn_act_dx.restype = i32
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


def _check_channels_innermost(x: torch.Tensor, name: str) -> None:
    """x must be 4-D NCHW in channels_last memory or 2-D (M, C)
    contiguous, f32 or bf16: channels innermost, C = x.shape[1]."""
    if x.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{name} expects float32 or bfloat16 x, got {x.dtype}")
    if x.ndim == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} expects a 4-D x in channels_last "
                             "memory (channels innermost)")
    elif x.ndim == 2:
        if not x.is_contiguous():
            raise ValueError(f"{name} expects a contiguous 2-D x")
    else:
        raise ValueError(f"{name} expects a 4-D or 2-D x, got {x.ndim}-D")


def _same_layout(x: torch.Tensor, g: torch.Tensor) -> bool:
    """g is laid out as the channels-innermost x is."""
    fmt = torch.channels_last if x.ndim == 4 else torch.contiguous_format
    return g.shape == x.shape and g.is_contiguous(memory_format=fmt)


def _check_pair(x: torch.Tensor, g: torch.Tensor, name: str) -> None:
    """g has x's dtype, device and channels-innermost layout."""
    if g.dtype != x.dtype or not _same_layout(x, g):
        raise ValueError(f"{name}: g must have x's dtype, shape and layout "
                         f"(x {x.dtype} {tuple(x.shape)} {x.stride()}, g "
                         f"{g.dtype} {tuple(g.shape)} {g.stride()})")
    if g.device != x.device:
        raise ValueError(f"{name}: x and g must be on one device")


def _check_channel_vectors(x: torch.Tensor, name: str,
                           *vectors: torch.Tensor) -> None:
    c = x.shape[1]
    for v in vectors:
        if v.dtype != torch.float32:
            raise TypeError(f"{name} expects float32 scale and bias")
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name}: scale and bias must be ({c},), got "
                             f"{tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name} expects contiguous scale and bias")
        if v.device != x.device:
            raise ValueError(f"{name}: x, scale and bias must be on one "
                             "device")


def channel_rows(x: torch.Tensor) -> torch.Tensor:
    """The (M, C) view of x with channels at dim 1: no copy when channels
    are innermost (NCHW in channels_last memory, or 2-D contiguous)."""
    if x.ndim == 4:
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    return x


# threads of a block that walks rows (kRowThreads in csrc/fused.cu); the
# rows a reduction thread takes per loop trip at most (U: 8 in
# channel_stats, 4 in the backward); reduction blocks per SM the plan aims
# for; partials a thread of the folding block reads at most; CUDA's grid.y
# limit
_ROW_THREADS, _RED_UNROLL, _RED_BLOCKS_PER_SM = 512, 8, 2
_FOLD_LOADS, _MAX_GROUPS = 32, 65535
# channels of a tile at most: a wide C is cut into more tiles, each folded
# by its own last block, so that more blocks run without a longer fold (a
# warp still reads whole rows of a tile: two rows of 512 bytes of f32 at
# C = 64, four of 128 bytes of bf16)
_RED_TILE_CHANNELS = 64
# K2's forward: rows of loads in flight per thread (U in csrc/fused.cu), and
# blocks per SM (kSbrBlocksPerSm: its __launch_bounds__ holds that many
# resident, so the planned grid runs in one wave)
_SBR_UNROLL, _SBR_BLOCKS_PER_SM = 4, 2
# bn_act_dx's blocks per SM (kDxBlocksPerSm: its per-channel constants and
# loads in flight leave room for one block of 512 per SM); its rows of
# loads in flight are _SBR_UNROLL
_DX_BLOCKS_PER_SM = 1
_INT32_MAX = 2 ** 31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class RowPlan(NamedTuple):
    """The launch of a kernel that walks x (m, c) by rows (scale_bias_relu,
    channel_stats, scale_bias_relu_backward): each thread moves ``vec``
    neighbouring channels per access, a block is ``block`` = (tx, ty)
    threads, the grid ``grid`` = (tiles, groups), and group g owns rows
    [g * rows_per_group, (g + 1) * rows_per_group) of m."""
    vec: int
    block: Tuple[int, int]
    grid: Tuple[int, int]
    rows_per_group: int

    @property
    def tiles(self) -> int:
        return self.grid[0]

    @property
    def groups(self) -> int:
        return self.grid[1]


def _vector_width(c: int, dtype: torch.dtype, data_ptrs: Sequence[int]) -> int:
    """16 bytes of ``dtype`` (4 f32 or 8 bf16 channels) where C is a
    multiple of them and every pointer is 16-byte aligned, else 1."""
    vec = 16 // dtype.itemsize
    return 1 if c % vec or any(p % 16 for p in data_ptrs) else vec


def _most_rows(c: int, trip: int) -> int:
    """The most rows of a group whose offsets fit in 32 bits, a multiple of
    ``trip``."""
    most = _INT32_MAX // c // trip * trip
    if most < trip:
        raise ValueError(f"a kernel over rows takes C up to "
                         f"{_INT32_MAX // trip}, got {c}")
    return most


def _check_groups(groups: int, rows: int, m: int, c: int) -> None:
    if groups > _MAX_GROUPS:
        raise ValueError(f"a kernel over rows takes up to {_MAX_GROUPS * rows} "
                         f"rows of {c} channels, got {m}")


def _sbr_forward_plan(m: int, c: int, dtype: torch.dtype,
                      data_ptrs: Sequence[int], sms: int,
                      blocks_per_sm: int = _SBR_BLOCKS_PER_SM) -> RowPlan:
    """The launch of scale_bias_relu's kernel over x (m, c) of ``dtype``,
    with x and the output at ``data_ptrs``, on a card of ``sms`` SMs (and
    of bn_affine_act's, and of bn_act_dx's with ``blocks_per_sm`` its own).

    - 16-byte accesses where C and the pointers allow them
      (_vector_width), else one element.
    - tx threads cover the chunks of a row (a power of two, at most a
      warp: a warp reads 512 contiguous bytes where a row is narrower), the
      other 512 / tx threads of a block take rows.
    - At most ``blocks_per_sm`` blocks per SM, one wave (unless the tiles
      of one row group are more), so that the large sites fill the card;
      but every thread gets at least one full loop trip of _SBR_UNROLL
      rows, so a small site gets fewer blocks and no block without rows
      (spreading a small site over more blocks with fewer rows each was
      slower on an H100). A group's rows are a multiple of the rows a block
      takes per trip, and its offsets fit in 32 bits."""
    if m < 1 or c < 1:
        raise ValueError(f"a kernel over rows needs m, c >= 1, got ({m}, {c})")
    vec = _vector_width(c, dtype, data_ptrs)
    chunks = c // vec
    tx = min(32, 1 << (chunks - 1).bit_length())
    ty = _ROW_THREADS // tx
    tiles = _cdiv(chunks, tx)
    trip = ty * _SBR_UNROLL
    groups = min(max(1, sms * blocks_per_sm // tiles), _cdiv(m, trip))
    rows = min(_cdiv(_cdiv(m, groups), trip) * trip, _most_rows(c, trip))
    groups = _cdiv(m, rows)
    _check_groups(groups, rows, m, c)
    return RowPlan(vec, (tx, ty), (tiles, groups), rows)


def _reduction_plan(m: int, c: int, dtype: torch.dtype,
                    data_ptrs: Sequence[int], sms: int) -> RowPlan:
    """The launch of a reduction over x (m, c) of ``dtype``, whose tensors
    (x, and g and dx for the backward) start at ``data_ptrs``, on a card
    of ``sms`` SMs.

    - 16-byte accesses where C and the pointers allow them
      (_vector_width), else one element.
    - tx threads cover the chunks of a tile of channels (a power of two, at
      most a warp and _RED_TILE_CHANNELS channels), the other (512 / tx)
      threads of a block take rows.
    - About _RED_BLOCKS_PER_SM blocks per SM in all, so that the large
      sites fill the card; but every thread gets at least one full loop
      trip of rows, so the small sites get few blocks with many rows each,
      and no thread of the block that folds the partials reads more than
      _FOLD_LOADS of them (each read waits on L2, after every other block
      has finished). A group's rows are a multiple of the rows a block
      takes per trip, and its offsets fit in 32 bits."""
    if m < 1 or c < 1:
        raise ValueError(f"a reduction needs m, c >= 1, got ({m}, {c})")
    vec = _vector_width(c, dtype, data_ptrs)
    chunks = c // vec
    tx = min(32, _RED_TILE_CHANNELS // vec, 1 << (chunks - 1).bit_length())
    ty = _ROW_THREADS // tx
    tiles = _cdiv(chunks, tx)
    trip = ty * _RED_UNROLL
    most_rows = _most_rows(c, trip)
    # the folding block's threads are (2 sums x tile channels) x slices,
    # and each reads the partials of groups / slices groups
    slices = _ROW_THREADS // (2 * tx * vec)
    groups = min(_cdiv(sms * _RED_BLOCKS_PER_SM, tiles), _cdiv(m, trip),
                 _FOLD_LOADS * slices)
    rows = min(_cdiv(_cdiv(m, groups), trip) * trip, most_rows)
    groups = _cdiv(m, rows)
    _check_groups(groups, rows, m, c)
    return RowPlan(vec, (tx, ty), (tiles, groups), rows)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# one zeroed int32 ticket buffer per (device, stream): launches on one
# stream run in order and each leaves its tickets at 0 (csrc/fused.cu)
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(device: torch.device, stream: int,
                   tiles: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


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


# threads of a normalize_u8 block (kNormThreads in csrc/fused.cu), blocks
# per SM (kNormBlocksPerSm: its __launch_bounds__ holds that many resident)
_NORM_THREADS, _NORM_BLOCKS_PER_SM = 256, 3


class NormalizePlan(NamedTuple):
    """The launch of normalize_u8's kernel over n uint8 values with
    ``nstats`` constants: ``blocks`` blocks of _NORM_THREADS threads. The
    first ``n_vec`` 16-byte chunks go through the vector loop, thread t
    reading chunks t, t + vec_stride, ... (a warp's lanes 32 neighbouring
    chunks); the other elements one at a time, the thread t-th from the
    grid's end taking 16 n_vec + t, + scalar_stride, ... (so that the tail
    falls to threads the vector loop leaves idle). ``vec`` is 16 (the bytes
    a thread reads per access) or 1 (the whole tensor one element at a
    time)."""
    vec: int
    blocks: int
    n_vec: int
    vec_stride: int
    scalar_stride: int


def _normalize_plan(n: int, nstats: int, data_ptrs: Sequence[int],
                    sms: int) -> NormalizePlan:
    """The launch of normalize_u8 over n values, with the input and output
    at ``data_ptrs``, on a card of ``sms`` SMs.

    - 16-byte reads where both pointers are 16-byte aligned: the n // 16
      whole chunks, and the n % 16 elements after them one at a time in
      the same launch; else every element one at a time.
    - As many blocks as one chunk (or element) per thread needs, at most
      _NORM_BLOCKS_PER_SM per SM (one wave); beyond that a thread takes 4
      per loop trip (U).
    - The vector loop's stride is all threads rounded down to a multiple
      of 32 (whole warps) and of nstats / gcd(16, nstats) (3 for RGB), the
      one-element loop's to a multiple of nstats: each thread's constants
      are then fixed."""
    if n < 1 or not 1 <= nstats <= MAX_STATS:
        raise ValueError(f"normalize_u8 needs n >= 1 and 1 <= nstats <= "
                         f"{MAX_STATS}, got n {n}, nstats {nstats}")
    vec = 16 if n >= 16 and not any(p % 16 for p in data_ptrs) else 1
    n_vec = n // 16 if vec == 16 else 0
    accesses = n_vec if vec == 16 else n
    period = math.lcm(32, nstats // math.gcd(16, nstats))
    blocks = max(1, min(_cdiv(accesses, _NORM_THREADS),
                        sms * _NORM_BLOCKS_PER_SM))
    if vec == 16:
        blocks = max(blocks, _cdiv(period, _NORM_THREADS))
    threads = blocks * _NORM_THREADS
    return NormalizePlan(vec, blocks, n_vec, threads - threads % period,
                         threads - threads % nstats)


@torch.library.custom_op("rppe::normalize_u8", mutates_args=())
def _normalize_u8_op(images: torch.Tensor, mean: List[float],
                     std: List[float], dtype: torch.dtype) -> torch.Tensor:
    if images.device.type == "cpu":
        return normalize_u8_reference(images, mean, std, dtype)
    return _normalize_u8_launch(images, mean, std, dtype)


@_normalize_u8_op.register_fake
def _(images, mean, std, dtype):
    return images.new_empty(images.shape, dtype=dtype)


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
    return torch.ops.rppe.normalize_u8(images, [float(m) for m in mean],
                                       [float(s) for s in std], dtype)


def _normalize_u8_launch(images: torch.Tensor, mean: Sequence[float],
                         std: Sequence[float],
                         dtype: torch.dtype) -> torch.Tensor:
    _require_cuda(images, "normalize_u8")
    nstats = len(mean)
    out = torch.empty(images.shape, dtype=dtype, device=images.device)
    if out.numel() == 0:
        return out
    scale, shift = _normalize_constants(mean, std)
    plan = _normalize_plan(out.numel(), nstats,
                           (images.data_ptr(), out.data_ptr()),
                           _sm_count(images.device))
    lib = _lib()
    err = lib.rppe_normalize_u8(
        images.data_ptr(), out.data_ptr(), out.numel(), nstats,
        (ctypes.c_float * nstats)(*scale), (ctypes.c_float * nstats)(*shift),
        int(dtype == torch.bfloat16), plan.blocks, plan.n_vec,
        plan.vec_stride, plan.scalar_stride, images.device.index,
        _stream(images))
    _check_launch(lib, err, "normalize_u8")
    normalize_u8.launches += 1
    normalize_u8.scalar_launches += plan.vec == 1
    return out


normalize_u8.launches = 0
normalize_u8.scalar_launches = 0


# ---------------------------------------------------------------------------
# scale_bias_relu and its backward
# ---------------------------------------------------------------------------


def _channel_view(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.ndim - 2))


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of scale_bias_relu: f32 math, output in x's dtype."""
    y = x.float() * _channel_view(x, scale) + _channel_view(x, bias)
    return torch.clamp_min(y, 0.0).to(x.dtype)


def _sbr_forward(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return scale_bias_relu_reference(x, scale, bias)
    _require_cuda(x, "scale_bias_relu")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    c = x.shape[1]
    m = x.numel() // c
    plan = _sbr_forward_plan(m, c, x.dtype, (x.data_ptr(), out.data_ptr()),
                             _sm_count(x.device))
    lib = _lib()
    err = lib.rppe_scale_bias_relu(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(), m, c,
        int(x.dtype == torch.bfloat16), plan.vec, plan.block[0], plan.tiles,
        plan.groups, plan.rows_per_group, x.device.index, _stream(x))
    _check_launch(lib, err, "scale_bias_relu")
    scale_bias_relu.launches += 1
    scale_bias_relu.scalar_launches += plan.vec == 1
    return out


def scale_bias_relu_backward_reference(
        x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of scale_bias_relu_backward, line by line the JAX
    package's ``_sbr_bwd``: (dx in x's dtype, dscale f32, dbias f32)."""
    xf = x.float()
    gf = g.float()
    pre = xf * _channel_view(x, scale) + _channel_view(x, bias)
    mask = (pre > 0).float()
    gm = gf * mask
    dx = (gm * _channel_view(x, scale)).to(x.dtype)
    dims = tuple(d for d in range(x.ndim) if d != 1)
    dscale = torch.sum(gm * xf, dim=dims)
    dbias = torch.sum(gm, dim=dims)
    return dx, dscale, dbias


def scale_bias_relu_backward(
        x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of relu(x * scale + bias) for the output cotangent g:
    with mask = x * scale + bias > 0 (f32), dx = g * mask * scale in x's
    dtype, dscale = sum(g * mask * x) and dbias = sum(g * mask) per
    channel in f32, in one read of x and g.

    x and g have one dtype and one layout, channels innermost (as
    scale_bias_relu's x); dx keeps it."""
    name = "scale_bias_relu_backward"
    _check_channels_innermost(x, name)
    _check_pair(x, g, name)
    _check_channel_vectors(x, name, scale, bias)
    if x.device.type == "cpu":
        return scale_bias_relu_backward_reference(x, g, scale, bias)
    _require_cuda(x, name)
    c = x.shape[1]
    dx = torch.empty_like(x)
    m = x.numel() // c if c else 0
    if m == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    plan = _reduction_plan(m, c, x.dtype,
                           (x.data_ptr(), g.data_ptr(), dx.data_ptr()),
                           _sm_count(x.device))
    part = torch.empty((2, plan.groups, c), dtype=torch.float32,
                       device=x.device)
    stream = _stream(x)
    lib = _lib()
    err = lib.rppe_scale_bias_relu_backward(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(), m, c,
        int(x.dtype == torch.bfloat16), plan.vec, plan.block[0], plan.tiles,
        plan.groups, plan.rows_per_group, dx.data_ptr(), part.data_ptr(),
        _ticket_buffer(x.device, stream, plan.tiles).data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), x.device.index, stream)
    _check_launch(lib, err, name)
    scale_bias_relu_backward.launches += 1
    scale_bias_relu_backward.scalar_launches += plan.vec == 1
    return dx, dscale, dbias


scale_bias_relu_backward.launches = 0
scale_bias_relu_backward.scalar_launches = 0


@torch.library.custom_op("rppe::scale_bias_relu", mutates_args=())
def _sbr_op(x: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    return _sbr_forward(x, scale, bias)


@_sbr_op.register_fake
def _(x, scale, bias):
    return torch.empty_like(x)


def _sbr_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _sbr_backward(ctx, g):
    """The backward kernel (jax.custom_vjp in the JAX package); it is not
    differentiable again."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            "scale_bias_relu has no second derivative (its backward is "
            "a kernel); do not differentiate through its gradient")
    x, scale, bias = ctx.saved_tensors
    if not _same_layout(x, g):
        # the layout of a gradient is not the caller's to choose (max
        # pooling, residual adds and convolutions may hand back
        # NCHW-contiguous memory): copy, and count the copy
        g = g.contiguous(memory_format=(torch.channels_last
                                        if x.ndim == 4
                                        else torch.contiguous_format))
        scale_bias_relu.grad_layout_copies += 1
    return scale_bias_relu_backward(x, g, scale, bias)


_sbr_op.register_autograd(_sbr_backward, setup_context=_sbr_setup_context)


def scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """relu(x * scale + bias) with f32 per-channel scale and bias, in f32,
    written in x's dtype (f32 or bf16).

    x is NCHW in ``channels_last`` memory or (M, C) contiguous, so that
    channels are innermost; C = x.shape[1]. The output keeps x's layout.
    Differentiable in x, scale and bias through scale_bias_relu_backward;
    a gradient that arrives in another layout than x's is copied into
    x's, and counted in ``scale_bias_relu.grad_layout_copies``."""
    _check_channels_innermost(x, "scale_bias_relu")
    _check_channel_vectors(x, "scale_bias_relu", scale, bias)
    return torch.ops.rppe.scale_bias_relu(x, scale, bias)


scale_bias_relu.launches = 0
scale_bias_relu.scalar_launches = 0
scale_bias_relu.grad_layout_copies = 0


# ---------------------------------------------------------------------------
# channel_stats
# ---------------------------------------------------------------------------


def channel_stats_reference(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of channel_stats: f32 (sum, sum of squares) per
    channel (dim 1) over every other dim."""
    xf = x.float()
    dims = tuple(d for d in range(x.ndim) if d != 1)
    return torch.sum(xf, dim=dims), torch.sum(xf * xf, dim=dims)


def channel_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (sum x, sum x^2) in one read of x (f32 or bf16),
    with x laid out as scale_bias_relu's (channels innermost, C =
    x.shape[1]). Any C and any number of rows: the JAX kernel's
    lcm(C, 128) tiling limit does not apply."""
    _check_channels_innermost(x, "channel_stats")
    if x.device.type == "cpu":
        return channel_stats_reference(x)
    _require_cuda(x, "channel_stats")
    c = x.shape[1]
    m = x.numel() // c if c else 0
    if m == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return zeros, zeros.clone()
    s = torch.empty(c, dtype=torch.float32, device=x.device)
    ss = torch.empty(c, dtype=torch.float32, device=x.device)
    plan = _reduction_plan(m, c, x.dtype, (x.data_ptr(),),
                           _sm_count(x.device))
    part = torch.empty((2, plan.groups, c), dtype=torch.float32,
                       device=x.device)
    stream = _stream(x)
    lib = _lib()
    err = lib.rppe_channel_stats(
        x.data_ptr(), m, c, int(x.dtype == torch.bfloat16), plan.vec,
        plan.block[0], plan.tiles, plan.groups, plan.rows_per_group,
        part.data_ptr(), _ticket_buffer(x.device, stream, plan.tiles)
        .data_ptr(), s.data_ptr(), ss.data_ptr(), x.device.index, stream)
    _check_launch(lib, err, "channel_stats")
    channel_stats.launches += 1
    channel_stats.scalar_launches += plan.vec == 1
    return s, ss


channel_stats.launches = 0
channel_stats.scalar_launches = 0


# ---------------------------------------------------------------------------
# the epilogue of training BatchNorm: bn_affine_act, bn_act_sums, bn_act_dx
# ---------------------------------------------------------------------------


def channels_innermost(x: torch.Tensor) -> torch.Tensor:
    """x where its channels are already innermost (4-D channels_last or 2-D
    contiguous), as the kernels over rows take it, else a copy of it laid
    out so."""
    if x.ndim == 4:
        return x.contiguous(memory_format=torch.channels_last)
    if x.ndim == 2:
        return x.contiguous()
    raise ValueError(f"expects a 4-D or 2-D x, got {x.ndim}-D")


def bn_affine_act_reference(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, act: bool) -> torch.Tensor:
    """Plain version of bn_affine_act: f32 math, output in x's dtype."""
    y = x.float() * _channel_view(x, scale) + _channel_view(x, bias)
    if act:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def bn_affine_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  act: bool) -> torch.Tensor:
    """``x * scale + bias``, then ReLU if ``act``, with f32 per-channel scale
    and bias, in f32, written in x's dtype: the forward of training
    BatchNorm. x is laid out as scale_bias_relu's (channels innermost, C =
    x.shape[1]), and the output keeps it. Not differentiable itself: its
    gradient is bn_act_sums, then bn_act_dx."""
    name = "bn_affine_act"
    _check_channels_innermost(x, name)
    _check_channel_vectors(x, name, scale, bias)
    if x.device.type == "cpu":
        return bn_affine_act_reference(x, scale, bias, act)
    _require_cuda(x, name)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    c = x.shape[1]
    m = x.numel() // c
    plan = _sbr_forward_plan(m, c, x.dtype, (x.data_ptr(), out.data_ptr()),
                             _sm_count(x.device))
    lib = _lib()
    err = lib.rppe_bn_affine_act(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(), m, c,
        int(x.dtype == torch.bfloat16), int(act), plan.vec, plan.block[0],
        plan.tiles, plan.groups, plan.rows_per_group, x.device.index,
        _stream(x))
    _check_launch(lib, err, name)
    bn_affine_act.launches += 1
    bn_affine_act.scalar_launches += plan.vec == 1
    return out


bn_affine_act.launches = 0
bn_affine_act.scalar_launches = 0


def _act_grad(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, act: bool) -> torch.Tensor:
    """g in f32 where the ReLU passed it, 0 where it did not (a select, as
    torch.relu's gradient is), or all of g without ``act``."""
    gf = g.float()
    if not act:
        return gf
    pre = x.float() * _channel_view(x, scale) + _channel_view(x, bias)
    return torch.where(pre > 0, gf, 0.0)


def bn_act_sums_reference(x: torch.Tensor, g: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          act: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of bn_act_sums: (sum(gm), sum(gm * x)) in f32."""
    gm = _act_grad(x, g, scale, bias, act)
    dims = tuple(d for d in range(x.ndim) if d != 1)
    return torch.sum(gm, dim=dims), torch.sum(gm * x.float(), dim=dims)


def bn_act_sums(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, act: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first pass of training BatchNorm's backward, in one read of x
    and g: with gm = g where ``x * scale + bias > 0`` (f32, rounded as
    bn_affine_act rounds it) and 0 elsewhere if ``act``, else gm = g, the
    per-channel f32 sums ``sum(gm)`` and ``sum(gm * x)``.

    x and g have one dtype and one layout, channels innermost (as
    scale_bias_relu_backward's)."""
    name = "bn_act_sums"
    _check_channels_innermost(x, name)
    _check_pair(x, g, name)
    _check_channel_vectors(x, name, scale, bias)
    if x.device.type == "cpu":
        return bn_act_sums_reference(x, g, scale, bias, act)
    _require_cuda(x, name)
    c = x.shape[1]
    m = x.numel() // c if c else 0
    if m == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return zeros, zeros.clone()
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    plan = _reduction_plan(m, c, x.dtype, (x.data_ptr(), g.data_ptr()),
                           _sm_count(x.device))
    part = torch.empty((2, plan.groups, c), dtype=torch.float32,
                       device=x.device)
    stream = _stream(x)
    lib = _lib()
    err = lib.rppe_bn_act_sums(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(), m, c,
        int(x.dtype == torch.bfloat16), int(act), plan.vec, plan.block[0],
        plan.tiles, plan.groups, plan.rows_per_group, part.data_ptr(),
        _ticket_buffer(x.device, stream, plan.tiles).data_ptr(),
        sums[0].data_ptr(), sums[1].data_ptr(), x.device.index, stream)
    _check_launch(lib, err, name)
    bn_act_sums.launches += 1
    bn_act_sums.scalar_launches += plan.vec == 1
    return sums[0], sums[1]


bn_act_sums.launches = 0
bn_act_sums.scalar_launches = 0


def bn_dx_coefficients(sum_g: torch.Tensor, sum_gx: torch.Tensor,
                       gamma: torch.Tensor, mean: torch.Tensor,
                       inv: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed form's per-channel (a, b, c) of ``dx = gm*a + x*b + c``:
    ``dx = (gamma*inv/n) * (n*gm - sum(gm) - xhat * sum(gm * xhat))`` with
    ``xhat = (x - mean) * inv`` and ``sum(gm * xhat) = (sum(gm * x) - mean *
    sum(gm)) * inv``, over the ``n`` elements of a channel. bn_act_dx's
    kernel computes each in this order, every operation rounded once; n
    divides as an f32 tensor (a true quotient on the card too, where a
    Python number would become a product with its reciprocal)."""
    nf = torch.full_like(sum_g, float(n))
    sum_g_xhat = (sum_gx - mean * sum_g) * inv
    a = gamma * inv
    b = -gamma * (inv * inv) * sum_g_xhat / nf
    c = -(a * sum_g / nf) - b * mean
    return a, b, c


def bn_act_dx_reference(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, act: bool, sum_g: torch.Tensor,
                        sum_gx: torch.Tensor, gamma: torch.Tensor,
                        mean: torch.Tensor, inv: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Plain version of bn_act_dx: f32 math, dx in x's dtype."""
    gm = _act_grad(x, g, scale, bias, act)
    a, b, c = bn_dx_coefficients(sum_g, sum_gx, gamma, mean, inv, n)
    return (gm * _channel_view(x, a) + x.float() * _channel_view(x, b)
            + _channel_view(x, c)).to(x.dtype)


def bn_act_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, act: bool, sum_g: torch.Tensor,
              sum_gx: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
              inv: torch.Tensor, n: int) -> torch.Tensor:
    """The second pass of training BatchNorm's backward, in one read of x
    and g: ``dx = gm*a + x*b + c`` in f32, written in x's dtype and layout,
    with gm as bn_act_sums takes it, and (a, b, c) from bn_dx_coefficients
    of the sums (the global batch's on a rank of a data-parallel group),
    gamma, the batch mean, inv = rsqrt(var + eps) and the count n, computed
    in the kernel.

    x and g as bn_act_sums takes them; scale, bias, the sums, gamma, mean
    and inv are f32 (C,)."""
    name = "bn_act_dx"
    _check_channels_innermost(x, name)
    _check_pair(x, g, name)
    _check_channel_vectors(x, name, scale, bias, sum_g, sum_gx, gamma, mean,
                           inv)
    if x.device.type == "cpu":
        return bn_act_dx_reference(x, g, scale, bias, act, sum_g, sum_gx,
                                   gamma, mean, inv, n)
    _require_cuda(x, name)
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    c = x.shape[1]
    m = x.numel() // c
    plan = _sbr_forward_plan(m, c, x.dtype,
                             (x.data_ptr(), g.data_ptr(), dx.data_ptr()),
                             _sm_count(x.device), _DX_BLOCKS_PER_SM)
    lib = _lib()
    err = lib.rppe_bn_act_dx(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        sum_g.data_ptr(), sum_gx.data_ptr(), gamma.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), float(n), m, c,
        int(x.dtype == torch.bfloat16), int(act), plan.vec, plan.block[0],
        plan.tiles, plan.groups, plan.rows_per_group, dx.data_ptr(),
        x.device.index, _stream(x))
    _check_launch(lib, err, name)
    bn_act_dx.launches += 1
    bn_act_dx.scalar_launches += plan.vec == 1
    return dx


bn_act_dx.launches = 0
bn_act_dx.scalar_launches = 0

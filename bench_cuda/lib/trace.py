"""The traced part of a run: a bounded number of steps under
``torch.profiler``, reduced to device intervals, host spans and kernel
groups.

Only the device's kernels and copies count as busy; the traced window
runs from the start of the first traced step to the end of the last
device operation. The kernel groups are ``chip_smoke.py``'s (its
``_kernel_group``), with NCCL's kernels taken out of "other".
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import torch


OTHER_GROUP = "other elementwise/reduction"
CONV_GROUP = "convolution (cuDNN)"
NCCL_GROUP = "nccl"


def kernel_group(name: str) -> str:
    """The group of a device operation, by its name."""
    if "normalize_u8_kernel" in name:
        return "normalize_u8"
    if "scale_bias_relu_kernel" in name:
        return "scale_bias_relu"
    if "sbr_backward_kernel" in name:
        return "scale_bias_relu_backward"
    if "channel_stats_kernel" in name:
        return "channel_stats"
    if "fold_partials_kernel" in name:
        return "reduction fold (stage 2)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    low = name.lower()
    if "nccl" in low:
        return NCCL_GROUP
    if any(k in low for k in ("flash", "fmha", "attention", "sdpa")):
        return "attention (SDPA)"
    if any(k in low for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    if any(k in low for k in ("conv", "fprop", "implicit", "dgrad", "wgrad",
                              "nhwc", "nchw")):
        return CONV_GROUP
    if any(k in low for k in ("gemm", "gemv", "nvjet")):
        return "matmul"
    if "xmma" in low or "cudnn" in low:
        return CONV_GROUP
    return OTHER_GROUP


def short_name(name: str) -> str:
    """A device operation's name cut to its function, without template
    arguments, at most 80 characters."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void ", "", base)
    base = re.sub(r"[<(].*", "", base).strip()
    return (base or name)[:80]


def profile(step: Callable[[], None], steps: int,
            spans: List[Tuple[str, int, int]]) -> Dict:
    """``steps`` calls of ``step`` with the device traced (CUDA activity
    only: recording every host operation would slow the host that the
    idle share is about), then a device synchronise. ``step`` appends
    its host spans (name, start ns, end ns on ``time.time_ns``'s clock,
    which the profiler's timestamps share) to ``spans``. Returns the
    device operations and the host spans as (name, start s, end s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    del spans[:]
    with torch_profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            step()
        if cuda:
            torch.cuda.synchronize()
    device = [(e.name(), e.start_ns() * 1e-9,
               (e.start_ns() + e.duration_ns()) * 1e-9)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    return {"device": device, "steps": steps,
            "spans": [(n, a * 1e-9, b * 1e-9) for n, a, b in spans]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarise(raw: Dict) -> Dict:
    """Busy and window seconds, device seconds by kernel group and by
    operation, and the idle gaps with the host span each fell in."""
    steps = [s for s in raw["spans"] if s[0] == "step"]
    if not raw["device"] or not steps:
        return {}
    t0 = min(s[1] for s in steps)
    t1 = max(max(e for _, _, e in raw["device"]), max(s[2] for s in steps))
    busy_iv = _merge([(max(s, t0), min(e, t1)) for _, s, e in raw["device"]
                      if e > t0 and s < t1])
    busy = sum(e - s for s, e in busy_iv)
    groups: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for name, s, e in raw["device"]:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + (e - s)
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + (e - s)
    inner = [s for s in raw["spans"] if s[0] != "step"]
    gaps = []
    edges = [t0] + [x for iv in busy_iv for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        host = [(a, n) for n, a, b in inner if a <= s < b]
        gaps.append((max(host)[1] if host else "between spans",
                     e - s))
    return {"busy_s": busy, "window_s": t1 - t0, "steps": raw["steps"],
            "groups": groups,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])[:10]}

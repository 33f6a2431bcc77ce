#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one or more lines each, and the last line is the result:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of csrc/, built with nvcc from the checkout;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs, at the shapes of a pr3 forward at batch 128, in f32
   and bf16, with its time, the plain version's time and its bound;
4. serving: the pr3 Predictor at full width (128x128 ResNet-18 + proprio
   MLP, seeded random weights through state_dict_from_jax) answers
   requests of batch 1, 8 and 128; launch counters show the kernels ran,
   and the poses agree with the same weights run on the CPU; then once
   more in bf16; latency per batch size, and the device time by kernel
   group and the device's idle share from torch.profiler;
5. a JSON line of per-kernel numbers, the card's name and power limit,
   and ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no
result. It fails without CUDA. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BATCH = 128                      # pr3's batch size (data.batch_size)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published memory rate
F32_OPS_PER_S = 67e12            # H100 SXM published f32 rate (no tensor cores)
# the nine scale_bias_relu sites of one ResNet-18 forward at 128x128, as
# (NCHW shape, how many sites have it): the stem and each block's conv1
K2_SITES = [((BATCH, 64, 64, 64), 1), ((BATCH, 64, 32, 32), 2),
            ((BATCH, 128, 16, 16), 2), ((BATCH, 256, 8, 8), 2),
            ((BATCH, 512, 4, 4), 2)]
K2_RAGGED = (100003, 64)         # an M that is a multiple of no block size
K1_SHAPES = [(BATCH, 128, 128, 3), (8, 128, 128, 9), (3, 37, 41, 3)]
TIMED_LAUNCHES = 100
L2_BYTES = 50 * 2 ** 20
# Whole-path tolerances. f32: the card and the CPU run the same f32 math
# (TF32 off) in other orders, as tests/parity/test_e2e_model_parity.py
# allows. bf16 against f32: bf16 keeps 8 significant bits and rounds at
# every layer; 5e-2 of the pose's scale is about 3x the 1.4e-2 that the
# port's bf16 and f32 paths differ by on the CPU for these weights.
F32_RTOL, F32_ATOL = 1e-3, 1e-4
BF16_REL = 5e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_tolerance(dtype: torch.dtype, magnitude: float) -> float:
    """The kernel fuses x*s+b into one FMA where the plain version rounds
    twice: about one f32 ulp of the largest intermediate M; in bf16 that
    can flip the output's rounding by one bf16 ulp."""
    return (1e-6 if dtype == torch.float32 else 2.0 ** -7) * (1.0 + magnitude)


def device_ms(fn, arg_sets) -> float:
    """Device time of one call of fn, in ms: CUDA events around
    TIMED_LAUNCHES calls queued behind a sleep kernel, so that host-side
    overhead between launches is hidden and only device time is measured.
    The calls rotate over arg_sets, whose total size exceeds the L2 cache,
    so every call reads its inputs from device memory."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)       # ~0.1 s: time to queue the calls
    start.record()
    for i in range(TIMED_LAUNCHES):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED_LAUNCHES


def copies_beyond_l2(nbytes: int) -> int:
    return max(2, min(64, math.ceil(4 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: int, ops: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(fused, dev):
    """K1 and K2 against their plain versions, timed; returns the per-kernel
    summary of the main-path shapes in f32 (pr3's dtype)."""
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    # K1 normalize_u8
    for shape in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            n = math.prod(shape)
            copies = copies_beyond_l2(n * (1 + dtype.itemsize))
            imgs = [torch.randint(0, 256, shape, generator=g, device=dev,
                                  dtype=torch.uint8) for _ in range(copies)]
            out = fused.normalize_u8(imgs[0], MEAN, STD, dtype)
            ref = fused.normalize_u8_reference(imgs[0], MEAN, STD, dtype)
            err = (out.float() - ref.float()).abs().max().item()
            magnitude = 255 * max(1 / (255 * s) for s in STD) + max(
                m / s for m, s in zip(MEAN, STD))
            tol = kernel_tolerance(dtype, magnitude)
            arg_sets = [(im, MEAN, STD, dtype) for im in imgs]
            ms = device_ms(fused.normalize_u8, arg_sets)
            plain = device_ms(fused.normalize_u8_reference, arg_sets)
            b_ms, b_by = bound(n * (1 + dtype.itemsize), 2 * n)
            print(f"kernel normalize_u8 {shape} -> {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms "
                  f"plain {plain:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
                  "library none",
                  flush=True)
            check(err <= tol, f"normalize_u8 {shape} {dtype}: error {err} "
                              f"above {tol}")
            if shape == K1_SHAPES[0] and dtype == torch.float32:
                summary["normalize_u8"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by)
            del imgs, arg_sets

    # K2 scale_bias_relu: the nine sites, then a ragged 2-D shape
    for dtype in (torch.float32, torch.bfloat16):
        totals = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for shape, sites in K2_SITES + [(K2_RAGGED, 0)]:
            n = math.prod(shape)
            c = shape[1]
            copies = copies_beyond_l2(2 * n * dtype.itemsize)
            xs = []
            for _ in range(copies):
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                if x.ndim == 4:
                    x = x.contiguous(memory_format=torch.channels_last)
                xs.append(x)
            s = torch.rand(c, generator=g, device=dev) + 0.5
            b = torch.randn(c, generator=g, device=dev) * 0.5
            out = fused.scale_bias_relu(xs[0], s, b)
            ref = fused.scale_bias_relu_reference(xs[0], s, b)
            check(out.stride() == xs[0].stride(),
                  f"scale_bias_relu {shape}: output layout differs")
            err = (out.float() - ref.float()).abs().max().item()
            magnitude = (xs[0].float().abs().max() * s.abs().max()
                         + b.abs().max()).item()
            tol = kernel_tolerance(dtype, magnitude)
            arg_sets = [(x, s, b) for x in xs]
            ms = device_ms(fused.scale_bias_relu, arg_sets)
            plain = device_ms(fused.scale_bias_relu_reference, arg_sets)
            nbytes = 2 * n * dtype.itemsize + 2 * c * 4
            b_ms, b_by = bound(nbytes, 3 * n)
            where = f"x{sites} site(s)" if sites else "ragged"
            print(f"kernel scale_bias_relu {shape} {str(dtype)[6:]} {where}: "
                  f"max_abs_err {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms "
                  f"plain {plain:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
                  "library none",
                  flush=True)
            check(err <= tol, f"scale_bias_relu {shape} {dtype}: error {err} "
                              f"above {tol}")
            if sites:
                totals["max_abs_err"] = max(totals["max_abs_err"], err)
            totals["ms"] += sites * ms
            totals["plain_ms"] += sites * plain
            totals["nbytes"] += sites * nbytes
            totals["ops"] += sites * 3 * n
            del xs, arg_sets
        b_ms, b_by = bound(totals["nbytes"], totals["ops"])
        print(f"kernel scale_bias_relu all nine sites {str(dtype)[6:]}: "
              f"kernel {totals['ms']:.4f} ms plain {totals['plain_ms']:.4f} "
              f"ms bound {b_ms:.4f} ms ({b_by}, {totals['nbytes']} bytes)",
              flush=True)
        if dtype == torch.float32:
            summary["scale_bias_relu"] = dict(
                max_abs_err=totals["max_abs_err"], ms=totals["ms"],
                plain_ms=totals["plain_ms"], bound_ms=b_ms, bound_by=b_by)
    return summary


def requests(model_cfg, seed):
    """Observations of batch 1 (unbatched), 8 and 128."""
    rs = np.random.RandomState(seed)
    hw = model_cfg.image_size

    def obs(n):
        shape = () if n is None else (n,)
        return {"images": {c: rs.randint(0, 256, shape + (hw, hw, 3),
                                         np.uint8)
                           for c in model_cfg.cameras},
                "proprio": rs.randn(*shape, model_cfg.proprio_dim)
                .astype(np.float32)}

    return {1: obs(None), 8: obs(8), BATCH: obs(BATCH)}


def drive(pred, reqs, fused, label):
    """Answer every request once with the counters set to 0 just before;
    check one normalize_u8 and nine scale_bias_relu launches per forward
    chunk. Returns ({batch: (pos, quat)}, {kernel: launches})."""
    fused.normalize_u8.launches = 0
    fused.scale_bias_relu.launches = 0
    answers = {}
    chunks = 0
    for n, obs in reqs.items():
        k1, k2 = fused.normalize_u8.launches, fused.scale_bias_relu.launches
        answers[n] = pred(obs)
        chunk = math.ceil(n / pred.max_batch)
        chunks += chunk
        d1 = fused.normalize_u8.launches - k1
        d2 = fused.scale_bias_relu.launches - k2
        print(f"serving {label} batch {n}: {chunk} forward(s), launches "
              f"normalize_u8 {d1}, scale_bias_relu {d2}", flush=True)
        check(d1 == chunk and d2 == 9 * chunk,
              f"{label} batch {n}: expected {chunk} and {9 * chunk} kernel "
              f"launches, saw {d1} and {d2}")
    counts = {"normalize_u8": fused.normalize_u8.launches,
              "scale_bias_relu": fused.scale_bias_relu.launches}
    check(counts["normalize_u8"] == chunks
          and counts["scale_bias_relu"] == 9 * chunks,
          f"{label}: launch counts {counts} for {chunks} forwards")
    return answers, counts


def check_shapes(answers, label):
    for n, (pos, quat) in answers.items():
        lead = () if n == 1 else (n,)
        check(pos.shape == lead + (3,) and quat.shape == lead + (4,),
              f"{label} batch {n}: shapes {pos.shape} {quat.shape}")
        check(pos.dtype == quat.dtype == np.float32,
              f"{label} batch {n}: dtypes {pos.dtype} {quat.dtype}")
        check(bool(np.isfinite(pos).all() and np.isfinite(quat).all()),
              f"{label} batch {n}: non-finite output")


def latency_ms(pred, obs, iters=30):
    """(p50, p90) host-clock time of one request, in ms: inputs to the
    card, the forward, the poses back (which synchronizes)."""
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        pred(obs)
        times.append((time.perf_counter() - t) * 1e3)
    return tuple(float(v) for v in np.percentile(times, [50, 90]))


def _kernel_group(name: str) -> str:
    if "normalize_u8_kernel" in name:
        return "normalize_u8"
    if "scale_bias_relu_kernel" in name:
        return "scale_bias_relu"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    low = name.lower()
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "dgrad",
                              "wgrad", "nhwc", "nchw", "cudnn")):
        return "convolution (cuDNN)"
    if "gemm" in low or "gemv" in low:
        return "matmul"
    return "other elementwise/reduction"


def device_breakdown(pred, obs, iters=5):
    """Device time per request, by kernel group and in all, from
    torch.profiler; None if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred(obs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            pred(obs)
    groups = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        return None
    per_req = {g: round(us / iters / 1e3, 4) for g, us in
               sorted(groups.items(), key=lambda kv: -kv[1])}
    return per_req, busy / iters / 1e3


def phase_serving(rppt, fused, smi):
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        random_jax_variables,
        state_dict_from_jax,
    )

    cfg = rppt.preset("pr3")
    m = cfg.model
    print(f"serving pr3: {m.backbone} {m.image_size}x{m.image_size} "
          f"cameras {list(m.cameras)}, proprio {m.proprio_dim} -> "
          f"{list(m.proprio_hidden)} -> {m.proprio_features}, head "
          f"{m.image_features + m.proprio_features} -> {list(m.head_hidden)} "
          f"-> 7", flush=True)
    t = time.perf_counter()
    state_dict = state_dict_from_jax(random_jax_variables(m, seed=0), m)
    print(f"serving weights from seed 0 via state_dict_from_jax: "
          f"{sum(v.numel() for v in state_dict.values())} values, "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    reqs = requests(m, seed=1)

    cpu = rppt.Predictor(cfg, state_dict=state_dict, max_batch=BATCH,
                         device="cpu")
    want = {n: cpu(obs) for n, obs in reqs.items()}

    launches = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.override(**{"model.dtype": dtype})
        pred = rppt.Predictor(c, state_dict=state_dict, max_batch=BATCH)
        pred.warmup()
        answers, counts = drive(pred, reqs, fused, dtype)
        if dtype == "float32":
            launches = counts
        check_shapes(answers, dtype)
        for n, (pos, quat) in answers.items():
            wpos, wquat = want[n]
            err_p = float(np.abs(pos - wpos).max())
            err_q = float(np.abs(quat - wquat).max())
            if dtype == "float32":
                ok = (np.allclose(pos, wpos, rtol=F32_RTOL, atol=F32_ATOL)
                      and np.allclose(quat, wquat, rtol=F32_RTOL,
                                      atol=F32_ATOL))
                rule = f"rtol {F32_RTOL} atol {F32_ATOL}"
            else:
                tol_p = BF16_REL * max(1.0, float(np.abs(wpos).max()))
                ok = err_p <= tol_p and err_q <= BF16_REL
                rule = f"pos {tol_p:.3g}, quat {BF16_REL}"
            print(f"serving {dtype} batch {n} card vs CPU f32: max_abs_err "
                  f"pos {err_p:.3g} quat {err_q:.3g} ({rule})", flush=True)
            check(ok, f"{dtype} batch {n}: card and CPU disagree")
        for n, obs in reqs.items():
            p50, p90 = latency_ms(pred, obs)
            print(f"serving {dtype} batch {n}: latency p50 {p50:.3f} ms "
                  f"p90 {p90:.3f} ms ({smi})", flush=True)
            prof = device_breakdown(pred, obs)
            if prof is None:
                print(f"profile {dtype} batch {n}: the profiler saw no "
                      "device time (not measured)", flush=True)
            else:
                # idle share of the p50 request time, taken unprofiled
                groups, busy_ms = prof
                print(f"profile {dtype} batch {n}: device busy {busy_ms:.4f} "
                      f"ms per request, idle share {1 - busy_ms / p50:.3f}; "
                      f"ms per request by kernel group {json.dumps(groups)}",
                      flush=True)
        del pred
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import _build, fused

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name}, {torch.cuda.device_count()} visible; nvidia-smi: "
          f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    # every f32 number below is full f32: cuDNN would otherwise use TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for convolutions and matmuls", flush=True)

    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} with nvcc in {time.perf_counter() - t:.2f} s",
          flush=True)

    summary = phase_kernels(fused, dev)
    launches = phase_serving(rppt, fused, smi)

    source = "rgb_proprioceptive_pose_estimator_tpu_torch/csrc/fused.cu"
    replaces = {
        "normalize_u8": "rgb_proprioceptive_pose_estimator_tpu/ops/"
                        "pallas_fused.py:57",
        "scale_bias_relu": "rgb_proprioceptive_pose_estimator_tpu/ops/"
                           "pallas_fused.py:225",
    }
    kernels = []
    for k in ("normalize_u8", "scale_bias_relu"):
        check(launches[k] > 0, f"{k} was not launched on the main path")
        s = summary[k]
        kernels.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces[k], "launches": launches[k],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

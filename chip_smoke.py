#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA
card and check them.

    python3 chip_smoke.py

Phases, one or more lines each, and the last line is the result:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of csrc/, built with nvcc from the checkout,
   with ptxas' registers and spills of each (no spills allowed); then the
   import surface: a fresh process imports every subpackage of the port
   and resolves its exports and the names of the reference's
   subpackages' ``__all__`` (read from their files as text; the port's
   name where its ``REFERENCE_NAMES`` maps one), loading none of jax,
   flax, optax, h5py, cv2, matplotlib, mujoco or the JAX package; the
   render child's import loads no torch; the quaternion algebra of
   ops/pose_math.py on the card against the CPU, and random_quaternion
   from a CUDA generator (unit norm, second moment I/4 at 2^20 draws);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same inputs, at the shapes of a pr3 step at batch 128, then at
   those of a pr4 step at batch 256 (ResNet-50 at 224x224: 33 BN-ReLU
   sites, 53 BatchNorms) and at pr5's stem site (3072 frames of one
   camera), in f32 and bf16: normalize_u8 and
   scale_bias_relu (the serving path), channel_stats and
   scale_bias_relu_backward (the training path). One line per site:
   agreement (normalize_u8 and scale_bias_relu exactly, NaN included), the
   bytes moved, time against the bound and its share, the vector width
   the plan chose, the kernel launches of one call (must be 1), the plain
   version's time and, where one PyTorch call computes the same function,
   that call's time. Each also takes shapes off the main path: a ragged M,
   C = 3 or 100, a misaligned view; the three directions of BN-ReLU
   (forward, backward dx, backward dscale and dbias) take NaN, +inf and
   -inf and must place them as the plain versions do; the reductions
   repeat REPEATS launches at the stem shape bit for bit;
4. serving: the pr3 Predictor at full width (128x128 ResNet-18 + proprio
   MLP, seeded random weights through state_dict_from_jax) answers
   requests of batch 1, 8 and 128; launch counters show the kernels ran,
   and the poses agree with the same weights run on the CPU; then once
   more in bf16; latency per batch size, and the device time by kernel
   group and the device's idle share from torch.profiler;
5. training: the pr3 trainer (engine/loop.train_on, what fit runs after
   building its datasets) at full width on an in-memory dataset made from
   a seed, with bn_stats="reduce" and with bn_stats="pallas": one train
   step on the card against the same step on the CPU, 16 f32 steps with
   one eval pass, launch counters per step, step time, images/s, the
   device's busy time by kernel group (no second reduction launch, the
   old fold group), idle share and peak memory, then 8 bf16 steps;
6. pr4 (ResNet-50 at 224x224, bf16, batch 256, AdamW with cosine warmup):
   serving at batch 1, 8 and 256 as in 4 (f32 against the CPU at batch
   8), then training on both routes as in 5: one f32 step against the
   CPU at batch 8, 16 bf16 steps at batch 256 with one eval pass;
7. pr2 (CNNSmall at 64x64, batch 64): 16 steps with one eval pass;
8. resume: with deterministic cuDNN, pr3 trains 16 steps straight, then
   8 steps to a checkpoint, and resume="auto" goes on to 16 from the saved
   step, optimizer count and sampler state, ending with the straight
   run's model, optimizer and sampler state bit for bit;
9. evaluate: api.evaluate_on of that checkpoint, with percentiles and
   success rates, on the card against the CPU;
10. pr5 (two cameras, 3 frames each through ResNet-18 at 128x128 and an
   LSTM, camera dropout 0.15, the quaternion head, bf16, global
   batch 1024 on one card): the four kernels at its stem site (3072 frames
   per camera), serving at batch 1 and 8 and at batch 8 with
   robot0_eye_in_hand left out (a dead camera), f32 against the CPU and
   bf16; training on both BN routes (one f32 step against the CPU at
   batch 4 with the same injected camera keep mask; its bf16 training at
   batch 1024 is 15's host augmentation route); and a resume with camera
   dropout on,
   bit for bit with the straight run, dropout masks included;
11. data parallelism (``parallel/dist.py``), two ranks sharing the card
   over gloo (NCCL refuses two ranks on one device; this checks the
   step, not NVLink or NCCL speed): pr3 at batch 128 in f32, three SGD
   steps against one process (losses, updates, running statistics equal
   on the ranks bit for bit, launches per rank); pr5 with
   dist.num_devices cut 8 -> 2 through ``api.train`` on each rank at
   batch 1024 in bf16 (step p50/p90, samples/s, peak memory per rank,
   the profiler's collective time), rank 0's final checkpoint restored
   here on the card as ``api.train``'s launcher returns it (equal to
   both ranks' final models), and a resume with camera dropout at batch
   64 bit for bit; bn_stats="pallas" on 2 devices raises the reference's
   ValueError;
12. the training extras: pr5 at full width in bf16 with the preset's
   batch of 1024 as 4 micro-batches of 256 (train.grad_accum), EMA 0.999
   and 2 batches of BN recalibration, 8 updates on each BN route (p50/p90
   per update, samples/s, busy time, idle share, peak memory, launches);
   the accumulated update against one from the mean of the micro-batches'
   gradients, the EMA against its formula, the recalibrated statistics
   against the batches' own at model.bn_momentum 0.9 and through the
   reference's recovery (0.9 old + 0.1 b - m old) / (1 - m) at 0.99, and
   a resume from micro-step 6 bit for bit;
   pr3 at full width in f32: model.freeze_backbone (no K2 backward),
   train.init_from_torch from a seeded torchvision ResNet-18 .npz,
   model.proprio_dropout, early stopping against the CPU, and
   train.debug_nans;
13. training across hosts (dist.multihost) on the card: two host
   processes, one gloo rank each, pr3 against one process, global rank 0
   writing and every host restoring the final checkpoint;
14. device augmentation (ops/image_augment_device.py, plain torch on the
   card) at pr5's shape, (1024, 3, 144, 144, 3) uint8 a camera, both crop
   modes, hue and the pose mirror on: against the CPU port on the same
   draws, crop and flip bit for bit; its time beside the host
   augmentation's for the same batch;
15. the device-resident data path at pr5's size (16,384 samples, 1.6 GB
   of frames): host augmentation, device cache + augment_device, and
   device cache without augmentation, each at batch 1024 and 4 x 256 on
   both BN routes (update p50/p90, busy time, idle share, peak memory,
   launches: no normalize_u8 under augment_device); the cache route
   equal to the host route without augmentation bit for bit, a resume
   under augment_device bit for bit, evaluate_on with and without the
   cache, and the upload budget's refusal;
16. the sharded cache on two ranks sharing the card over gloo, each
   holding its shard alone, pr3 against one process fed the same global
   batches;
17. the HTTP server (utils/serve.py) over the pr3 and pr5 checkpoints
   above: answers equal to the in-process Predictor bit for bit, a pr5
   session through a lost camera, a 413 and a 400, p50/p90 a request at
   1 client and at 8 coalesced within 2 ms;
18. the ViT backbone (models/vit.py): pr3 with model.backbone="vit" at
   the ModelConfig defaults (dim 384, depth 6, 6 heads, mean pooling, 64
   tokens at 128x128): serving in f32 and bf16 at batch 1, 8 and 128
   against the CPU (one normalize_u8 a forward, no BN-ReLU site),
   attention as its own kernel group with the SDPA kernels named; one f32
   step against the CPU, 16 f32 and 8 bf16 steps at batch 128, a resume
   bit for bit (deterministic cuDNN, math attention), evaluate_on against
   the CPU; then vit_b_16's widths (dim 768, depth 12, 12 heads, a class
   token, 224x224) in bf16: serving at batch 8 and 128, weights through
   train.init_from_torch from a seeded torchvision-named state_dict
   (held on the card), 8 steps at batch 128;
19. serving artifacts (utils/export.py) of pr3's and the ViT's f32
   checkpoints in f32 and int8 at batch 8, each loaded in a fresh process
   that has the artifact alone: K1 and K2 launches counted there, f32
   against the Predictor, int8 against f32, bytes and p50 against the
   Predictor's; a pr1 sweep (utils/sweep.py) of two runs, whose second
   call trains nothing;
20. the script's seconds, a JSON line of per-kernel numbers (pr3's f32
   sites; launches summed over every main path, the ranks' included),
   the card's name and power limit, and ``{"ok": true, "device": {...}}``
   last.

Two parts of the port are held on the CPU alone (tests/), not here:
scripts/torch_from_orbax.py, which converts the JAX package's orbax
checkpoints and needs JAX, which the card's host lacks; and the examples
of examples/torch/, which write HDF5 fixtures, and the card's host has no
h5py. What they run on the card (pr2 training, serving, the export) is
driven above by phases 7, 4 and 19.

Any failed check raises, so the script exits non-zero and prints no
result. It fails without CUDA. It imports nothing of JAX. Whether it
passes or fails, no process it started is left when it exits.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
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
# a NaN/inf case of the BN-ReLU kernels: NaN, +inf and -inf in a few rows
# of the first channels of x (and g), at a mid site
NONFINITE_SHAPE = (BATCH, 64, 32, 32)
# the twenty channel_stats sites of one pr3 train step with
# bn_stats="pallas": every BatchNorm (the stem, 16 in the blocks, 3
# downsample shortcuts)
K3_SITES = [((BATCH, 64, 64, 64), 1), ((BATCH, 64, 32, 32), 4),
            ((BATCH, 128, 16, 16), 5), ((BATCH, 256, 8, 8), 5),
            ((BATCH, 512, 4, 4), 5)]
MISALIGNED = "misaligned"
# beyond the sites: a ragged M, the one-element path (C = 3; C = 100 in
# bf16, which 8 does not divide; a view one element past a 16-byte
# boundary), and one block's worth of rows (the fixed cost of a launch)
K3_EXTRA = [((100003, 64), "ragged"), ((100003, 3), "C=3"),
            ((4099, 100), "C=100"), ((MISALIGNED, 4099, 64), MISALIGNED),
            ((64, 64), "one block")]
# beyond the nine sites, for K2's forward and backward
K2_EXTRA = [(K2_RAGGED, "ragged"), ((4099, 100), "C=100"),
            ((MISALIGNED, 4099, 64), MISALIGNED), ((64, 64), "one block")]
REPEATS = 1000                   # launches held bit for bit to the first
# share of dx elements whose ReLU mask may differ from the plain version's
# (a pre-activation within an ulp of 0); the kernel rounds x*s+b as the
# plain version does, so none are expected
MASK_SHARE = 1e-5
# dx = g*mask*scale, the same f32 product on both sides rounded once to
# dx's dtype: exact in f32, within one bf16 ulp of |dx| in bf16
DX_REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# training phase
TRAIN_STEPS, STEPS_PER_CALL, EVAL_BATCHES = 16, 8, 2
DATASET_BATCHES = 8
CMP_BATCH = 16
# one step on the card against the same step on the CPU, f32, TF32 off
CMP_LOSS_RTOL, CMP_GRAD_REL, CMP_STATS_RTOL, CMP_STATS_ATOL = (
    1e-4, 1e-3, 1e-4, 1e-5)
# K1: pr3's batch, 3 stacked frames, an n that 16 does not divide (a tail
# of 5 elements), and that image one byte past a 16-byte boundary
K1_SHAPES = [(BATCH, 128, 128, 3), (8, 128, 128, 9), (3, 37, 41, 3),
             (MISALIGNED, 3, 37, 41, 3)]
# pr4: a step of ResNet-50 at 224x224, batch 256 (data.batch_size). K1 on
# its images; K2 (forward and backward) at the stem and each Bottleneck's
# conv1 and conv2, 33 sites; K3 at those and every conv3 and downsample
# BatchNorm, 53 sites
PR4_BATCH = 256
K1_PR4_SHAPES = [(PR4_BATCH, 224, 224, 3)]
K2_PR4_SITES = [((PR4_BATCH, 64, 112, 112), 1), ((PR4_BATCH, 64, 56, 56), 6),
                ((PR4_BATCH, 128, 56, 56), 1), ((PR4_BATCH, 128, 28, 28), 7),
                ((PR4_BATCH, 256, 28, 28), 1), ((PR4_BATCH, 256, 14, 14), 11),
                ((PR4_BATCH, 512, 14, 14), 1), ((PR4_BATCH, 512, 7, 7), 5)]
K3_PR4_SITES = K2_PR4_SITES + [
    ((PR4_BATCH, 256, 56, 56), 4), ((PR4_BATCH, 512, 28, 28), 5),
    ((PR4_BATCH, 1024, 14, 14), 7), ((PR4_BATCH, 2048, 7, 7), 4)]
PR4_CMP_BATCH = 8                # pr4's f32 step and serving against the CPU
PR2_BATCH = 64
# pr5: two cameras, each running its T = 3 frames through ResNet-18 at
# 128x128 one by one (LSTM mode), global batch 1024 on one card: each
# encoder call takes 3072 frames, so the stem's BN-ReLU site is 3072 * 64 *
# 64 rows of 64 channels (805 M elements, 3.2 GB in f32) per camera
PR5_BATCH, PR5_FRAMES = 1024, 3
PR5_IMAGES = PR5_BATCH * PR5_FRAMES
K1_PR5_SHAPES = [(PR5_IMAGES, 128, 128, 3)]
K2_PR5_SITES = [((PR5_IMAGES, 64, 64, 64), 1)]
PR5_SAMPLES = 4 * PR5_BATCH      # the in-memory dataset's samples
PR5_EPISODE = 64                 # steps of each of its episodes
PR5_CMP_BATCH = 4                # pr5's f32 step against the CPU
PR5_RESUME_BATCH = 64
# data parallelism on the one card: two ranks share it over gloo (NCCL
# refuses two ranks on one device), which checks the step's correctness
# and shape, not NVLink or NCCL speed. pr3: three SGD steps at a learning
# rate small enough that the steps stay well-conditioned; pr5: the preset's
# dist.num_devices cut 8 -> 2, 8 steps at batch 1024, then a resume at
# batch 64
DDP_RANKS = 2
DDP_STEPS, DDP_LR = 3, 1e-4
# card against card: the two ranks' parameter updates after DDP_STEPS,
# against one process's, as the L2 norm of the difference over that of
# the update (a ReLU input within rounding of 0 moves one BatchNorm
# channel's gradients by percents, which this keeps out of the check)
DDP_UPDATE_REL = 1e-2
PR5_DDP_STEPS, PR5_DDP_PER_CALL, PR5_DDP_WORKERS = 8, 4, 4
TIMED_LAUNCHES = 100
L2_BYTES = 50 * 2 ** 20
# Whole-path tolerances. f32: the card and the CPU run the same f32 math
# (TF32 off) in other orders, as tests/parity/test_e2e_model_parity.py
# allows. bf16 against f32: bf16 keeps 8 significant bits and rounds at
# every layer; 5e-2 of the pose's scale is about 4x the gap between the
# port's bf16 and f32 paths on the CPU for the seed-0 weights: 9.8e-3 for
# pr3 at 128 px and 1.13e-2 for pr4 at 224 px (ResNet-50, pose scale
# 138), position, at batch 4.
F32_RTOL, F32_ATOL = 1e-3, 1e-4
BF16_REL = 5e-2
# evaluate on the card against the CPU: f32 (TF32 off) means of errors,
# rtol 1e-3 as the poses; the reports' rounded quantiles (3 decimals)
# within one unit of the last place beyond that; a success rate within one
# sample (a sample at a threshold may fall on either side)
EVAL_RTOL, EVAL_ROUNDED = 1e-3, 1e-3
EVAL_SAMPLES = 256
# the training extras: pr5 with the preset's batch of 1024 as micro-batches
# of 256 accumulated 4 times, 2 updates a route (one call; the steps at
# this config are timed and profiled by phase_device_cache_pr5's host
# augmentation route), the EMA and 2 batches of
# BN recalibration; a resume from a checkpoint at micro-step 6 (mid-way
# through the second update) at batch 64
PR5_MICRO, PR5_ACCUM, PR5_UPDATES = 256, 4, 2
PR5_EMA, PR5_RECAL = 0.999, 2
PR5_ACCUM_CUT, PR5_ACCUM_STEPS = 6, 8
# updates timed with one synchronization an update, after a warm one
PR5_TIMED_UPDATES = 4
# the accumulated update against one update from the mean of the four
# micro-gradients computed one by one: the L2 norm of their difference
# over that of the update (deterministic cuDNN: the same sums, in the
# same order); the EMA against its formula, relative to its largest
# value (one rounding of each product and of the sum)
ACCUM_UPDATE_REL, EMA_REL = 1e-5, 1e-6
# recalibrated statistics against the per-batch statistics of each BN
# input, computed in f64 from hooks, averaged: relative to each
# statistic's largest value (f32 sums of up to 3.1 M bf16 values a
# channel, and the momentum recovery scales their rounding by 10)
RECAL_REL = 1e-3
# model.bn_momentum of the recalibration checks: every preset's 0.9, and
# 0.99, where the reference recovers 10 b - 9 old (its layers, and the
# port's, update with 0.9 whatever the knob says)
RECAL_MOMENTA = (0.9, 0.99)
PR3_FREEZE_STEPS = 4
# pr3's early stopping at full width, at a batch the CPU runs in seconds
EARLY_BATCH, EARLY_STEPS, EARLY_LR = 16, 12, 1e-3
# training across hosts on the one card: two host processes, one rank
# each on cuda:0 over gloo, pr3 f32 at batch 128, DDP_STEPS SGD steps
MULTIHOST_HOSTS = 2
# the device-resident data path at pr5's size: device augmentation of
# batches of (1024, 3, 144, 144, 3) per camera (pad-and-crop margin 8),
# checked on the card against the CPU port on the same draws for the first
# AUG_CPU_ROWS samples (the contrast mean sums in another order: atol
# 1e-5, the CPU tests' jitter tolerance); MemoryDemos of 16,384 samples
# in 256 episodes of 64 (1.6 GB of uint8 frames at 128x128, two cameras);
# CACHE_STEPS updates per data route timed; the cache against the host
# route over CACHE_CMP_STEPS steps at CACHE_CMP_BATCH; a resume at
# CACHE_CUT of CACHE_RESUME_STEPS under augment_device at
# PR5_RESUME_BATCH; evaluate_on with and without the cache over
# EVAL_CACHE_BATCHES batches (the same pixels: within EVAL_CACHE_REL)
PR5_CROP_MARGIN, AUG_HUE, AUG_CPU_ROWS, AUG_ATOL = 8, 0.05, 64, 1e-5
PR5_CACHE_SAMPLES = 16 * PR5_BATCH
CACHE_STEPS = 4
CACHE_CMP_STEPS, CACHE_CMP_BATCH = 4, 256
CACHE_CUT, CACHE_RESUME_STEPS = 6, 8
EVAL_CACHE_BATCHES, EVAL_CACHE_REL = 2, 1e-3
# the sharded cache on two ranks sharing the card: pr3 in 16 episodes
SHARD_SAMPLES, SHARD_EPISODE = 1024, 64
# the HTTP server: requests of one sample, a body limit of 1 MB, a
# session of 6 frames (a camera lost on frame 3 is back in the window of
# T = 3 on frame 6), 8 clients coalesced within 2 ms (coalesced batches
# run other batch sizes than one request alone: rel 1e-3 of the pose,
# bf16's 5e-2 where the model is bf16)
SERVE_REQUESTS, SERVE_MAX_BODY_MB, SERVE_FRAMES = 20, 1.0, 6
SERVE_CLIENTS, SERVE_COALESCE_MS, SERVE_ROUNDS = 8, 2.0, 4
SERVE_COALESCED_REL = BF16_REL
# the ViT backbone: pr3 with model.backbone="vit" at the ModelConfig
# defaults (patch 16, dim 384, depth 6, 6 heads, mean pooling: 64 tokens at
# 128x128), and at vit_b_16's widths (dim 768, depth 12, 12 heads, a class
# token: 197 tokens at 224x224), the latter from a torchvision-named
# state_dict made from a seed (train.init_from_torch), bf16
VIT = {"model.backbone": "vit"}
VIT_B16 = {"model.backbone": "vit", "model.vit_dim": 768,
           "model.vit_depth": 12, "model.vit_heads": 12,
           "model.vit_pool": "cls", "model.image_size": 224}
# the ViT's 8 bf16 steps in two calls, so that the second call's 4 are
# timed and profiled
VIT_BF16_CALLS = {"train.steps_per_call": 4, "train.log_every": 4}
# serving artifacts (utils/export.py) at batch 8, loaded in a fresh
# process: f32 against the Predictor within the reference's rtol 1e-5,
# atol 1e-6 (tests/test_export.py); int8 positions within 0.05 of the f32
# artifact's, |<q8, q32>| within 0.01 of 1; latency over EXPORT_ITERS
EXPORT_MAX_BATCH, EXPORT_RTOL, EXPORT_ATOL = 8, 1e-5, 1e-6
INT8_POS_ATOL, INT8_QUAT_ATOL, EXPORT_ITERS = 0.05, 0.01, 30


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


def check_exact(out, ref, what: str) -> None:
    """out equals ref element for element, NaN where ref has NaN."""
    try:
        torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: differs from the plain version: {e}")


def check_nonfinite_placed(got, want, what: str) -> None:
    """NaN where want has NaN, and the same infinities where it has them."""
    inf = want.isinf()
    check(torch.equal(got.isnan(), want.isnan())
          and torch.equal(got.isinf(), inf)
          and torch.equal(got[inf], want[inf]),
          f"{what}: NaN or inf placed otherwise than in the plain version")


def _short_kernel_name(mangled: str) -> str:
    """name<type[, V]> from a mangled _ZN...<len>name_kernelI<type>[Li<V>E]
    kernel template name, else the mangled name."""
    import re

    for hit in re.finditer(r"\d+", mangled):
        name = mangled[hit.end():hit.end() + int(hit.group())]
        rest = mangled[hit.end() + len(name):]
        if name.endswith("_kernel") and rest.startswith("I"):
            dtype = "bf16" if rest.startswith("I13__nv_bfloat16") else "f32"
            vec = re.match(r"I(?:13__nv_bfloat16|f)Li(\d+)E", rest)
            return f"{name}<{dtype}{', ' + vec.group(1) if vec else ''}>"
    return mangled


def ptxas_kernels(report: str) -> list:
    """[(kernel, registers, spill bytes stored + loaded)] from ptxas -v."""
    import re

    out, kernel, spills = [], None, 0
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            kernel = _short_kernel_name(hit.group(1))
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            spills = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and kernel:
            out.append((kernel, int(hit.group(1)), spills))
            kernel, spills = None, 0
    check(bool(out), "ptxas reported no kernel")
    return out


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


def rows_input(shape, dtype, gen, dev, shift=0.0):
    """Seeded normal values (+ shift) of ``shape`` in ``dtype``: NCHW in
    channels_last memory, (M, C) contiguous, or, for (MISALIGNED, M, C), an
    (M, C) view one element past a 16-byte boundary."""
    if shape[0] == MISALIGNED:
        m, c = shape[1:]
        x = torch.empty(m * c + 1, dtype=dtype, device=dev)[1:].view(m, c)
        x.copy_(torch.randn((m, c), generator=gen, device=dev) + shift)
        check(x.data_ptr() % 16 != 0, "the misaligned view is aligned")
        return x
    x = (torch.randn(shape, generator=gen, device=dev) + shift).to(dtype)
    return _channels_last(x)


def launches_per_call(fn, args, counter) -> tuple:
    """(kernel launches of one call of fn, how they were counted): device
    kernels in a torch.profiler trace of one call, or, where the profiler
    sees none, the call's step of the wrapper's launch counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = counter.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if seen:
        return len(seen), "profiler"
    return counter.launches - before, "launch counter"


def vector_width(fn, args, counter, vec: int) -> int:
    """Elements per access that the wrapper's plan chose for one call: vec,
    or 1 where the call counted a one-element launch."""
    scalar = counter.scalar_launches
    fn(*args)
    return 1 if counter.scalar_launches > scalar else vec


def bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def differing_bits(fn, args, repeats: int = REPEATS) -> int:
    """Elements of fn's outputs that differ, over ``repeats`` launches,
    from the first launch's, bit for bit."""
    first = [bits(t).clone() for t in fn(*args)]
    differ = torch.zeros((), dtype=torch.int64, device=first[0].device)
    for _ in range(repeats):
        for a, b in zip(fn(*args), first):
            differ += (bits(a) != b).sum()
    return int(differ.item())


def bound(nbytes: int, ops: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def image_input(shape, gen, dev):
    """Seeded uint8 images of ``shape``, or, for (MISALIGNED, *shape), a
    contiguous view of them one byte past a 16-byte boundary."""
    if shape[0] == MISALIGNED:
        n = math.prod(shape[1:])
        img = torch.randint(0, 256, (n + 1,), generator=gen, device=dev,
                            dtype=torch.uint8)[1:].view(shape[1:])
        check(img.data_ptr() % 16 != 0, "the misaligned image is aligned")
        return img
    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)


def nonfinite_(rows, channels):
    """Write NaN, +inf and -inf into a few of ``rows`` (M, C), in their
    first ``channels`` channels, in place."""
    for i, value in enumerate((float("nan"), float("inf"), float("-inf"))):
        rows[i::97, i % channels] = value
        rows[i + 1::211, (i + 1) % channels] = value


def phase_normalize_u8(fused, dev, shapes=K1_SHAPES):
    """K1 at ``shapes`` in f32 and bf16, one line each: exact agreement
    with the plain version, time against the bound, vector width, launches
    per call, plain and library times; returns the f32 summary at the
    first shape (the main path's)."""
    g = torch.Generator(device=dev).manual_seed(0)
    summary = None
    fn = fused.normalize_u8
    for shape in shapes:
        real = shape[1:] if shape[0] == MISALIGNED else shape
        n, c = math.prod(real), real[-1]
        reps = c // len(MEAN)
        # the library call: addcmul promotes uint8 to f32, with the
        # per-channel constants built once
        lib_scale = torch.tensor([1.0 / (255.0 * s) for s in STD] * reps,
                                 device=dev)
        lib_shift = torch.tensor([-m / s for m, s in zip(MEAN, STD)] * reps,
                                 device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            copies = copies_beyond_l2(n * (1 + dtype.itemsize))
            imgs = [image_input(shape, g, dev) for _ in range(copies)]
            out = fn(imgs[0], MEAN, STD, dtype)
            ref = fused.normalize_u8_reference(imgs[0], MEAN, STD, dtype)
            check(out.shape == imgs[0].shape and out.dtype == dtype,
                  f"normalize_u8 {shape} {dtype}: output shape or dtype")
            check_exact(out, ref, f"normalize_u8 {shape} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            args0 = (imgs[0], MEAN, STD, dtype)
            vec = vector_width(fn, args0, fn, 16)
            tail = n % 16 if vec > 1 else 0
            per_call, how = launches_per_call(fn, args0, fn)
            arg_sets = [(im, MEAN, STD, dtype) for im in imgs]
            ms = device_ms(fn, arg_sets)
            plain = device_ms(fused.normalize_u8_reference, arg_sets)
            nbytes = n * (1 + dtype.itemsize)
            b_ms, b_by = bound(nbytes, 2 * n)
            if dtype == torch.float32:
                lib = device_ms(lambda im: torch.addcmul(lib_shift, im,
                                                         lib_scale),
                                [(im,) for im in imgs])
                lib_text = f"library (addcmul) {lib:.4f} ms"
            else:
                lib = None
                lib_text = "library none (no single call writes bf16)"
            print(f"kernel normalize_u8 {shape} -> {str(dtype)[6:]}: exact "
                  f"(rtol 0 atol 0), max_abs_err {err:.3g}; {nbytes} bytes; "
                  f"kernel {ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) share "
                  f"{b_ms / ms:.3f}; vector width {vec} bytes, tail {tail} "
                  f"elements one at a time; launches per call {per_call} "
                  f"({how}); plain {plain:.4f} ms {lib_text}", flush=True)
            check(per_call == 1, f"normalize_u8 {shape} {dtype}: "
                                 f"{per_call} launches in one call")
            check(vec == (1 if shape[0] == MISALIGNED else 16),
                  f"normalize_u8 {shape} {dtype}: vector width {vec}")
            if shape == shapes[0] and dtype == torch.float32:
                summary = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            del imgs, arg_sets, args0, out, ref
    return summary


def phase_sbr_forward(fused, dev, sites_list=K2_SITES, extra=K2_EXTRA,
                      label="nine", nonfinite=True):
    """K2's forward at the scale_bias_relu sites of ``sites_list`` (pr3's
    nine by default) and ``extra``, in f32 and bf16, one line each as
    phase_normalize_u8, then (``nonfinite``) a NaN/inf case; returns the
    f32 summary over the sites."""
    g = torch.Generator(device=dev).manual_seed(1)
    summary = None
    fn = fused.scale_bias_relu
    for dtype in (torch.float32, torch.bfloat16):
        totals = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for shape, sites in sites_list + extra:
            xs = [rows_input(shape, dtype, g, dev)]
            n, c = xs[0].numel(), xs[0].shape[1]
            xs += [rows_input(shape, dtype, g, dev) for _ in
                   range(copies_beyond_l2(2 * n * dtype.itemsize) - 1)]
            s = torch.rand(c, generator=g, device=dev) + 0.5
            b = torch.randn(c, generator=g, device=dev) * 0.5
            out = fn(xs[0], s, b)
            ref = fused.scale_bias_relu_reference(xs[0], s, b)
            check(out.stride() == xs[0].stride(),
                  f"scale_bias_relu {shape}: output layout differs")
            check_exact(out, ref, f"scale_bias_relu {shape} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            args0 = (xs[0], s, b)
            vec = vector_width(fn, args0, fn, 16 // dtype.itemsize)
            per_call, how = launches_per_call(fn, args0, fn)
            arg_sets = [(x, s, b) for x in xs]
            ms = device_ms(fn, arg_sets)
            plain = device_ms(fused.scale_bias_relu_reference, arg_sets)
            nbytes = 2 * n * dtype.itemsize + 2 * c * 4
            b_ms, b_by = bound(nbytes, 3 * n)
            print(f"kernel scale_bias_relu {shape} {str(dtype)[6:]} "
                  f"{_sites_label(sites)}: exact (rtol 0 atol 0), "
                  f"max_abs_err {err:.3g}; {nbytes} bytes; kernel {ms:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}) share {b_ms / ms:.3f}; "
                  f"vector width {vec}; launches per call {per_call} ({how}); "
                  f"plain {plain:.4f} ms library none", flush=True)
            check(per_call == 1, f"scale_bias_relu {shape} {dtype}: "
                                 f"{per_call} launches in one call")
            if isinstance(sites, int):
                check(vec == 16 // dtype.itemsize,
                      f"scale_bias_relu {shape} {dtype}: vector width {vec}")
                totals["max_abs_err"] = max(totals["max_abs_err"], err)
                totals["ms"] += sites * ms
                totals["plain_ms"] += sites * plain
                totals["nbytes"] += sites * nbytes
                totals["ops"] += sites * 3 * n
            del xs, arg_sets, args0, out, ref
        b_ms, b_by = bound(totals["nbytes"], totals["ops"])
        print(f"kernel scale_bias_relu all {label} sites {str(dtype)[6:]}: "
              f"kernel {totals['ms']:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
              f"{totals['nbytes']} bytes) share {b_ms / totals['ms']:.3f}; "
              f"plain {totals['plain_ms']:.4f} ms", flush=True)
        if dtype == torch.float32:
            summary = dict(max_abs_err=totals["max_abs_err"], ms=totals["ms"],
                           plain_ms=totals["plain_ms"], bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
        if not nonfinite:
            continue
        x = rows_input(NONFINITE_SHAPE, dtype, g, dev)
        nonfinite_(fused.channel_rows(x), 4)
        c = x.shape[1]
        s = torch.rand(c, generator=g, device=dev) + 0.5
        b = torch.randn(c, generator=g, device=dev) * 0.5
        ref = fused.scale_bias_relu_reference(x, s, b)
        check(bool(ref.isnan().any() and ref.isinf().any()),
              "the NaN/inf case has no NaN or inf")
        check_exact(fn(x, s, b), ref,
                    f"scale_bias_relu NaN/inf {NONFINITE_SHAPE} {dtype}")
        print(f"kernel scale_bias_relu NaN/inf {NONFINITE_SHAPE} "
              f"{str(dtype)[6:]}: {int(ref.isnan().sum())} NaN and "
              f"{int(ref.isinf().sum())} inf in the plain output; the "
              "kernel's equal (rtol 0 atol 0, NaN where NaN)", flush=True)
    return summary


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last) if x.ndim == 4 \
        else x


def _sites_label(sites):
    return f"x{sites} site(s)" if isinstance(sites, int) else sites


def phase_channel_stats(fused, dev, sites_list=K3_SITES, extra=K3_EXTRA,
                        label="twenty"):
    """K3 channel_stats at the BN sites of ``sites_list`` (the twenty of a
    pr3 step by default) and ``extra`` (a ragged M, C = 3, C = 100 and a
    misaligned view), in f32 and bf16: agreement with the plain version,
    time against the bound, the vector width the plan chose, launches per
    call (1), and REPEATS launches at pr3's stem shape bit for bit;
    returns the f32 summary over the sites."""
    g = torch.Generator(device=dev).manual_seed(2)
    summary = None
    fn = fused.channel_stats

    def library(x):
        return torch.var_mean(fused.channel_rows(x), dim=0, correction=0)

    for dtype in (torch.float32, torch.bfloat16):
        totals = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                      nbytes=0, ops=0)
        for shape, sites in sites_list + extra:
            xs = [rows_input(shape, dtype, g, dev, shift=0.5)]
            n, c = xs[0].numel(), xs[0].shape[1]
            xs += [rows_input(shape, dtype, g, dev, shift=0.5)
                   for _ in range(copies_beyond_l2(n * dtype.itemsize) - 1)]
            s, ss = fn(xs[0])
            s2, ss2 = fn(xs[0])
            check(torch.equal(s, s2) and torch.equal(ss, ss2),
                  f"channel_stats {shape} {dtype}: two launches differ")
            rs, rss = fused.channel_stats_reference(xs[0])
            xf = fused.channel_rows(xs[0]).float()
            tol_s = 1e-5 * xf.abs().sum(0)
            tol_ss = 1e-5 * (xf * xf).sum(0)
            err_s, err_ss = (s - rs).abs(), (ss - rss).abs()
            m = n // c
            mean, var = s / m, (ss / m - (s / m) ** 2).clamp_min(0.0)
            rmean, rvar = rs / m, (rss / m - (rs / m) ** 2).clamp_min(0.0)
            rel_mean = ((mean - rmean).abs() / rmean.abs().clamp_min(1e-12))
            rel_var = ((var - rvar).abs() / rvar.abs().clamp_min(1e-12))
            worst = int(rel_var.argmax())
            err = max(err_s.max().item(), err_ss.max().item())
            vec = vector_width(fn, (xs[0],), fn, 16 // dtype.itemsize)
            per_call, how = launches_per_call(fn, (xs[0],), fn)
            arg_sets = [(x,) for x in xs]
            ms = device_ms(fn, arg_sets)
            plain = device_ms(fused.channel_stats_reference, arg_sets)
            lib = device_ms(library, arg_sets)
            nbytes = n * dtype.itemsize + 2 * c * 4
            b_ms, b_by = bound(nbytes, 3 * n)
            print(f"kernel channel_stats {shape} {str(dtype)[6:]} "
                  f"{_sites_label(sites)}: max_abs_err sum "
                  f"{err_s.max().item():.3g} sumsq "
                  f"{err_ss.max().item():.3g} (tol 1e-5 of sum|x|, sum x^2 "
                  f"per channel); mean rel {rel_mean.max().item():.3g}, var "
                  f"rel {rel_var.max().item():.3g} worst at channel {worst} "
                  f"(var {rvar[worst].item():.4g} mean "
                  f"{rmean[worst].item():.4g}); bitwise repeatable; "
                  f"{nbytes} bytes; kernel {ms:.4f} ms bound {b_ms:.4f} ms "
                  f"({b_by}) share {b_ms / ms:.3f}; vector width {vec}; "
                  f"launches per call {per_call} ({how}); plain "
                  f"{plain:.4f} ms library (var_mean) {lib:.4f} ms",
                  flush=True)
            check(per_call == 1, f"channel_stats {shape} {dtype}: "
                                 f"{per_call} launches in one call")
            check(bool((err_s <= tol_s).all() and (err_ss <= tol_ss).all()),
                  f"channel_stats {shape} {dtype}: sums outside 1e-5 of "
                  "sum|x|, sum x^2")
            check(rel_var.max().item() <= 1e-4
                  and rel_mean.max().item() <= 1e-4,
                  f"channel_stats {shape} {dtype}: mean or var off by more "
                  "than 1e-4 relative")
            if isinstance(sites, int):
                totals["max_abs_err"] = max(totals["max_abs_err"], err)
                totals["ms"] += sites * ms
                totals["plain_ms"] += sites * plain
                totals["library_ms"] += sites * lib
                totals["nbytes"] += sites * nbytes
                totals["ops"] += sites * 3 * n
            if shape == K3_SITES[0][0]:
                differ = differing_bits(fn, (xs[0],))
                print(f"kernel channel_stats {shape} {str(dtype)[6:]}: "
                      f"{REPEATS} launches, {differ} output elements differ "
                      "from the first launch's bits", flush=True)
                check(differ == 0, f"channel_stats {shape} {dtype}: not "
                                   "bitwise repeatable")
            del xs, arg_sets, xf
        b_ms, b_by = bound(totals["nbytes"], totals["ops"])
        print(f"kernel channel_stats all {label} sites {str(dtype)[6:]}: "
              f"kernel {totals['ms']:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
              f"{totals['nbytes']} bytes) share {b_ms / totals['ms']:.3f}; "
              f"plain {totals['plain_ms']:.4f} ms library "
              f"{totals['library_ms']:.4f} ms", flush=True)
        if dtype == torch.float32:
            summary = dict(max_abs_err=totals["max_abs_err"], ms=totals["ms"],
                           plain_ms=totals["plain_ms"], bound_ms=b_ms,
                           bound_by=b_by, library_ms=totals["library_ms"])
    return summary


def phase_sbr_backward(fused, dev, sites_list=K2_SITES, extra=K2_EXTRA,
                       label="nine", nonfinite=True):
    """K2's backward at the scale_bias_relu sites of ``sites_list`` (pr3's
    nine by default) and ``extra``, in f32 and bf16, as
    phase_channel_stats, then (``nonfinite``) a NaN/inf case; returns the
    f32 summary over the sites."""
    gen = torch.Generator(device=dev).manual_seed(3)
    summary = None
    fn = fused.scale_bias_relu_backward
    for dtype in (torch.float32, torch.bfloat16):
        totals = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for shape, sites in sites_list + extra:
            xs = [rows_input(shape, dtype, gen, dev)]
            n, c = xs[0].numel(), xs[0].shape[1]
            copies = copies_beyond_l2(3 * n * dtype.itemsize)
            xs += [rows_input(shape, dtype, gen, dev)
                   for _ in range(copies - 1)]
            gs = [rows_input(shape, dtype, gen, dev) for _ in range(copies)]
            s = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.randn(c, generator=gen, device=dev) * 0.5
            out = fn(xs[0], gs[0], s, b)
            again = fn(xs[0], gs[0], s, b)
            check(all(torch.equal(u, v) for u, v in zip(out, again)),
                  f"scale_bias_relu_backward {shape} {dtype}: two launches "
                  "differ")
            dx, ds, db = out
            check(dx.shape == xs[0].shape and dx.dtype == dtype
                  and (dx.ndim == 2 or dx.stride() == xs[0].stride()),
                  f"scale_bias_relu_backward {shape}: dx layout or dtype")
            rdx, rds, rdb = fused.scale_bias_relu_backward_reference(
                xs[0], gs[0], s, b)
            flipped = (dx == 0) != (rdx == 0)
            share = flipped.float().mean().item()
            same = ~flipped
            diff_dx = (dx.float() - rdx.float()).abs() * same
            err_dx = diff_dx.max().item()
            ok_dx = bool((diff_dx <= DX_REL[dtype] * rdx.float().abs()).all())
            xr = fused.channel_rows(xs[0]).float()
            gm = fused.channel_rows(gs[0]).float() * fused.channel_rows(
                rdx != 0)
            tol_ds = 1e-5 * (gm * xr).abs().sum(0) + 1e-6
            tol_db = 1e-5 * gm.abs().sum(0) + 1e-6
            err_ds, err_db = (ds - rds).abs(), (db - rdb).abs()
            err = max(err_dx, err_ds.max().item(), err_db.max().item())
            args0 = (xs[0], gs[0], s, b)
            vec = vector_width(fn, args0, fn, 16 // dtype.itemsize)
            per_call, how = launches_per_call(fn, args0, fn)
            arg_sets = [(x, gg, s, b) for x, gg in zip(xs, gs)]
            ms = device_ms(fn, arg_sets)
            plain = device_ms(fused.scale_bias_relu_backward_reference,
                              arg_sets)
            nbytes = 3 * n * dtype.itemsize + 4 * c * 4
            b_ms, b_by = bound(nbytes, 6 * n)
            print(f"kernel scale_bias_relu_backward {shape} {str(dtype)[6:]} "
                  f"{_sites_label(sites)}: mask differs at {share:.3g} of dx "
                  f"(limit {MASK_SHARE}); max_abs_err dx elsewhere "
                  f"{err_dx:.3g} (tol {DX_REL[dtype]} of |dx|) dscale "
                  f"{err_ds.max().item():.3g} dbias "
                  f"{err_db.max().item():.3g} (tol 1e-5 of the sums of "
                  f"magnitudes); bitwise repeatable; {nbytes} bytes; kernel "
                  f"{ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) share "
                  f"{b_ms / ms:.3f}; vector width {vec}; launches per call "
                  f"{per_call} ({how}); plain {plain:.4f} ms library none",
                  flush=True)
            check(per_call == 1, f"scale_bias_relu_backward {shape} {dtype}: "
                                 f"{per_call} launches in one call")
            check(share <= MASK_SHARE and ok_dx,
                  f"scale_bias_relu_backward {shape} {dtype}: dx differs")
            check(bool((err_ds <= tol_ds).all() and (err_db <= tol_db).all()),
                  f"scale_bias_relu_backward {shape} {dtype}: dscale or "
                  "dbias outside 1e-5 of the sums of magnitudes")
            if isinstance(sites, int):
                totals["max_abs_err"] = max(totals["max_abs_err"], err)
                totals["ms"] += sites * ms
                totals["plain_ms"] += sites * plain
                totals["nbytes"] += sites * nbytes
                totals["ops"] += sites * 6 * n
            del out, again, dx, rdx, xr, gm
            if shape == K2_SITES[0][0]:
                differ = differing_bits(fn, args0)
                print(f"kernel scale_bias_relu_backward {shape} "
                      f"{str(dtype)[6:]}: {REPEATS} launches, {differ} output "
                      "elements differ from the first launch's bits",
                      flush=True)
                check(differ == 0, f"scale_bias_relu_backward {shape} "
                                   f"{dtype}: not bitwise repeatable")
            del xs, gs, arg_sets, args0
        b_ms, b_by = bound(totals["nbytes"], totals["ops"])
        print(f"kernel scale_bias_relu_backward all {label} sites "
              f"{str(dtype)[6:]}: kernel {totals['ms']:.4f} ms bound "
              f"{b_ms:.4f} ms ({b_by}, {totals['nbytes']} bytes) share "
              f"{b_ms / totals['ms']:.3f}; plain {totals['plain_ms']:.4f} ms",
              flush=True)
        if dtype == torch.float32:
            summary = dict(max_abs_err=totals["max_abs_err"], ms=totals["ms"],
                           plain_ms=totals["plain_ms"], bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
        if not nonfinite:
            continue
        x = rows_input(NONFINITE_SHAPE, dtype, gen, dev)
        gg = rows_input(NONFINITE_SHAPE, dtype, gen, dev)
        nonfinite_(fused.channel_rows(x), 4)
        nonfinite_(fused.channel_rows(gg), 8)
        c = x.shape[1]
        s = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.5
        got = fn(x, gg, s, b)
        want = fused.scale_bias_relu_backward_reference(x, gg, s, b)
        check(all(bool(w.isnan().any()) for w in want),
              "the NaN/inf case gives no NaN in dx, dscale or dbias")
        for name, u, w in zip(("dx", "dscale", "dbias"), got, want):
            check_nonfinite_placed(u, w, f"scale_bias_relu_backward NaN/inf "
                                         f"{dtype} {name}")
        fin = want[0].isfinite()
        check(bool(((got[0].float() - want[0].float()).abs()
                    <= DX_REL[dtype] * want[0].float().abs())[fin].all()),
              f"scale_bias_relu_backward NaN/inf {dtype}: finite dx differs")
        print(f"kernel scale_bias_relu_backward NaN/inf {NONFINITE_SHAPE} "
              f"{str(dtype)[6:]}: NaN in dx {int(want[0].isnan().sum())}, "
              f"dscale {int(want[1].isnan().sum())}, dbias "
              f"{int(want[2].isnan().sum())} of {c} channels, inf in dx "
              f"{int(want[0].isinf().sum())}, dscale "
              f"{int(want[1].isinf().sum())}; the kernel's at the same "
              f"places, finite dx within {DX_REL[dtype]} of |dx|", flush=True)
    return summary


def requests(model_cfg, seed, batches, dead=()):
    """Observations of each batch size of ``batches`` (1 unbatched), with
    T frames per camera where the model stacks or sequences them; then,
    for each (n, camera) of ``dead``, a batch of n with that camera left
    out, keyed "n without camera"."""
    rs = np.random.RandomState(seed)
    hw = model_cfg.image_size
    t = model_cfg.temporal_frames
    frames = (t,) if t > 1 else ()

    def obs(n, cameras=model_cfg.cameras):
        shape = () if n == 1 else (n,)
        return {"images": {c: rs.randint(0, 256, shape + frames + (hw, hw, 3),
                                         np.uint8)
                           for c in cameras},
                "proprio": rs.randn(*shape, *frames, model_cfg.proprio_dim)
                .astype(np.float32)}

    out = {n: obs(n) for n in batches}
    for n, cam in dead:
        out[f"{n} without {cam}"] = obs(
            n, [c for c in model_cfg.cameras if c != cam])
    return out


def request_size(key) -> int:
    """The batch size of a request key of ``requests``."""
    return key if isinstance(key, int) else int(key.split()[0])


def bn_sites(model):
    """(BN-ReLU sites, which run scale_bias_relu, and all BatchNorms, which
    run channel_stats on the pallas route) of a model's forward, over all
    its encoders."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
        BatchNormAct,
    )

    bns = [m for m in model.modules() if isinstance(m, BatchNormAct)]
    return sum(m.act for m in bns), len(bns)


def encoder_sites(model) -> int:
    """BN-ReLU sites of one camera's encoder (every camera's is alike)."""
    return bn_sites(model)[0] // max(len(model.cameras), 1)


def drive(pred, reqs, fused, label):
    """Answer every request once with the counters set to 0 just before;
    check one normalize_u8 launch per present camera and one
    scale_bias_relu launch per BN-ReLU site of its encoder, per forward
    chunk. Returns ({request: (pos, quat)}, {kernel: launches})."""
    sites = encoder_sites(pred.model)
    _zero_counts(fused)
    answers = {}
    want = {"normalize_u8": 0, "scale_bias_relu": 0}
    for key, obs in reqs.items():
        k1, k2 = fused.normalize_u8.launches, fused.scale_bias_relu.launches
        answers[key] = pred(obs)
        chunk = math.ceil(request_size(key) / pred.max_batch)
        cams = len(obs["images"])
        d1 = fused.normalize_u8.launches - k1
        d2 = fused.scale_bias_relu.launches - k2
        want["normalize_u8"] += chunk * cams
        want["scale_bias_relu"] += chunk * cams * sites
        print(f"serving {label} batch {key}: {chunk} forward(s) of {cams} "
              f"camera(s), launches normalize_u8 {d1}, scale_bias_relu {d2}",
              flush=True)
        check(d1 == chunk * cams and d2 == sites * chunk * cams,
              f"{label} batch {key}: expected {chunk * cams} and "
              f"{sites * chunk * cams} kernel launches, saw {d1} and {d2}")
    counts = {"normalize_u8": fused.normalize_u8.launches,
              "scale_bias_relu": fused.scale_bias_relu.launches}
    check(counts == want, f"{label}: launch counts {counts}, expected {want}")
    return answers, counts


def check_shapes(answers, label):
    for n, (pos, quat) in answers.items():
        lead = () if n == 1 else (request_size(n),)
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


FOLD_GROUP = "reduction fold (stage 2)"
OTHER_GROUP = "other elementwise/reduction"
ATTENTION_GROUP = "attention (SDPA)"


def _kernel_group(name: str) -> str:
    if "normalize_u8_kernel" in name:
        return "normalize_u8"
    if "scale_bias_relu_kernel" in name:
        return "scale_bias_relu"
    if "sbr_backward_kernel" in name:
        return "scale_bias_relu_backward"
    if "channel_stats_kernel" in name:
        return "channel_stats"
    if "fold_partials_kernel" in name:
        # the second launch of both reductions before they became one
        # launch each; none is expected
        return FOLD_GROUP
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    low = name.lower()
    if any(k in low for k in ("flash", "fmha", "attention", "sdpa")):
        return ATTENTION_GROUP
    if any(k in low for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    if any(k in low for k in ("conv", "fprop", "implicit", "dgrad", "wgrad",
                              "nhwc", "nchw")):
        return "convolution (cuDNN)"
    # cuBLAS's and cuBLASLt's (nvjet) matmul kernels, whose names may also
    # carry xmma
    if any(k in low for k in ("gemm", "gemv", "nvjet")):
        return "matmul"
    if "xmma" in low or "cudnn" in low:
        return "convolution (cuDNN)"
    return OTHER_GROUP


def device_breakdown(run, iters):
    """Device time per call of ``run`` (after one warm call), by kernel
    group and in all, from torch.profiler over ``iters`` calls, and the
    five kernels that take most of OTHER_GROUP's; None if the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    groups, other, attention = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
        if g == OTHER_GROUP:
            other[e.key[:100]] = other.get(e.key[:100], 0.0) + us
        if g == ATTENTION_GROUP:
            attention[e.key[:160]] = attention.get(e.key[:160], 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        return None
    if attention:
        # which backend scaled_dot_product_attention took, by its kernels
        share = sum(attention.values()) / busy
        print(f"profile: {ATTENTION_GROUP} kernels, ms per call "
              f"{json.dumps({k: round(us / iters / 1e3, 4) for k, us in attention.items()})}"
              f"; attention's share of the device busy time {share:.4f}",
              flush=True)
    per_call = {g: round(us / iters / 1e3, 4) for g, us in
                sorted(groups.items(), key=lambda kv: -kv[1])}
    top = {k: round(us / iters / 1e3, 4) for k, us in
           sorted(other.items(), key=lambda kv: -kv[1])[:5]}
    return per_call, busy / iters / 1e3, top


def phase_serving(rppt, fused, smi, name="pr3", batches=(1, 8, BATCH),
                  cpu_batches=(1, 8, BATCH), dead=(), overrides=None,
                  label=None, dtypes=("float32", "bfloat16")):
    """The ``name`` preset's Predictor (with dotted ``overrides``, printed
    as ``label``) at full width with seed-0 weights, in each of
    ``dtypes``, answering requests of ``batches`` and, for each (n,
    camera) of ``dead``, of n with that camera left out: launch counts,
    agreement with the CPU in f32 at ``cpu_batches`` (request keys), latency
    and device time by kernel group. Returns the first dtype's launch
    counts."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        random_jax_variables,
        state_dict_from_jax,
    )

    cfg = rppt.preset(name).override(**(overrides or {}))
    name = label or name
    m = cfg.model
    frames = (f", {m.temporal_frames} frames per camera ({m.temporal_mode})"
              if m.temporal_frames > 1 else "")
    head_in = m.image_features * len(m.cameras) + m.proprio_features
    print(f"serving {name}: {m.backbone} {m.image_size}x{m.image_size} "
          f"cameras {list(m.cameras)}{frames}, proprio {m.proprio_dim} -> "
          f"{list(m.proprio_hidden)} -> {m.proprio_features}, head "
          f"{head_in} -> {list(m.head_hidden)} -> "
          f"{9 if m.rot_rep == 'rot6d' else 7}", flush=True)
    t = time.perf_counter()
    state_dict = state_dict_from_jax(random_jax_variables(m, seed=0), m)
    print(f"serving weights from seed 0 via state_dict_from_jax: "
          f"{sum(v.numel() for v in state_dict.values())} values, "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    reqs = requests(m, seed=1, batches=batches, dead=dead)

    cpu = rppt.Predictor(cfg.override(**{"model.dtype": "float32"}),
                         state_dict=state_dict,
                         max_batch=max(map(request_size, cpu_batches)),
                         device="cpu")
    t = time.perf_counter()
    want = {n: cpu(reqs[n]) for n in cpu_batches}
    print(f"serving {name} f32 on the CPU at batch {list(cpu_batches)}: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    del cpu

    launches = None
    for dtype in dtypes:
        c = cfg.override(**{"model.dtype": dtype})
        pred = rppt.Predictor(c, state_dict=state_dict,
                              max_batch=max(map(request_size, reqs)))
        pred.warmup()
        label = f"{name} {dtype}"
        answers, counts = drive(pred, reqs, fused, label)
        if launches is None:
            launches = counts
        check_shapes(answers, label)
        for n in cpu_batches:
            (pos, quat), (wpos, wquat) = answers[n], want[n]
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
            print(f"serving {label} batch {n} card vs CPU f32: max_abs_err "
                  f"pos {err_p:.3g} quat {err_q:.3g} ({rule})", flush=True)
            check(ok, f"{label} batch {n}: card and CPU disagree")
        for n, obs in reqs.items():
            p50, p90 = latency_ms(pred, obs)
            print(f"serving {label} batch {n}: latency p50 {p50:.3f} ms "
                  f"p90 {p90:.3f} ms ({smi})", flush=True)
            prof = device_breakdown(lambda: pred(obs), iters=5)
            if prof is None:
                print(f"profile {label} batch {n}: the profiler saw no "
                      "device time (not measured)", flush=True)
            else:
                # idle share of the p50 request time, taken unprofiled
                groups, busy_ms, top = prof
                print(f"profile {label} batch {n}: device busy "
                      f"{busy_ms:.4f} ms per request, idle share "
                      f"{1 - busy_ms / p50:.3f}; ms per request by kernel "
                      f"group {json.dumps(groups)}; the {OTHER_GROUP!r} "
                      f"kernels that take most {json.dumps(top)}",
                      flush=True)
        del pred
    return launches


class MemoryDemos:
    """An in-memory dataset made from a seed with numpy: uint8 frames of
    each camera, proprio vectors and target poses, served by ``get_batch``
    as the HDF5 store serves them (data/hdf5_store.HDF5DemoStore.get_batch:
    the same keys, dtypes and shapes; with T = model.temporal_frames > 1
    each sample is the window of its last T steps, clamped at its
    episode's start (episodes of ``episode`` steps), as (n, T, H, W, 3)
    frames and (n, T, D) proprio; host augmentation with the store's
    per-(sample, camera) parameter stream, one draw shared by the T frames
    of a sample, through the port's data/augment.py and native engine).
    The card's host has no h5py, so the trainer reads this instead of a
    demo file.

    The device-resident data path reads it as it reads the store: its
    episodes are the demos (``frames_per_demo``, ``sample_demos``), sample
    i's frame is flat frame i, ``build_resized_cache(hw)`` gives every
    frame at ``hw`` (resized once by the native engine when hw is not the
    model's size), ``emit_image_indices`` makes ``get_batch`` send frame
    indices (rows of ``cache_plan``'s shard under the sharded layout),
    and with ``device_aug_hw`` set an augmented batch is the frames resized
    to it, left to the device to crop, flip and jitter."""

    def __init__(self, cfg, size: int, seed: int, episode: int = 0):
        m, d = cfg.model, cfg.data
        rs = np.random.RandomState(seed)
        hw = m.image_size
        self.cameras = tuple(m.cameras)
        self.hw = hw
        self.t = m.temporal_frames
        self.episode = episode or size
        self.frames = {c: rs.randint(0, 256, (size, hw, hw, 3), np.uint8)
                       for c in self.cameras}
        self.proprio = rs.randn(size, m.proprio_dim).astype(np.float32)
        self.pos = rs.uniform(-0.3, 0.3, (size, 3)).astype(np.float32)
        q = rs.randn(size, 4)
        self.quat = (q / np.linalg.norm(q, axis=1, keepdims=True)
                     ).astype(np.float32)
        self.use_native = d.use_native
        self.emit_image_indices = bool(d.device_cache)
        self.cache_plan = None
        self.device_aug_hw = (hw + 2 * d.crop_margin
                              if d.augment_device and d.augment else None)
        self._resized = {}
        self.aug_kwargs = dict(
            crop_scale=d.crop_scale, crop_ratio=d.crop_ratio,
            hflip_prob=d.hflip_prob, jitter_brightness=d.jitter_brightness,
            jitter_contrast=d.jitter_contrast,
            jitter_saturation=d.jitter_saturation, jitter_hue=d.jitter_hue,
            jitter_prob=d.jitter_prob)

    def __len__(self) -> int:
        return len(self.pos)

    def proprio_stats(self):
        return (self.proprio.mean(0, dtype=np.float64).astype(np.float32),
                np.maximum(self.proprio.std(0, dtype=np.float64), 1e-6)
                .astype(np.float32))

    def frames_per_demo(self):
        return np.full(len(self) // self.episode, self.episode, np.int64)

    def sample_demos(self):
        return np.arange(len(self)) // self.episode

    def build_resized_cache(self, hw: int):
        if hw == self.hw:
            return self.frames
        if hw not in self._resized:
            from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import (
                native,
            )

            check(native.available(), "the native augmentation engine did "
                                      "not build")
            self._resized[hw] = {c: native.center_crop_resize_batch(f, hw)
                                 for c, f in self.frames.items()}
        return self._resized[hw]

    def _camera_batch(self, cam, ci, indices, flat, augment, seed):
        from rgb_proprioceptive_pose_estimator_tpu_torch.data import (
            augment as aug,
        )
        from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import native

        n, t, hw = len(indices), self.t, self.hw
        if augment and self.device_aug_hw is not None:
            hw = self.device_aug_hw
            frames = self.build_resized_cache(hw)[cam][flat]
            return frames if t == 1 else frames.reshape(n, t, hw, hw, 3)
        frames = self.frames[cam][flat]                 # (n * T, hw, hw, 3)
        if augment:
            sseeds = (seed * 1_000_003 + indices * 31
                      + ci * 7_777) % (2 ** 31 - 1)
            pb = aug.sample_aug_params_batch(
                np.full(n, hw), np.full(n, hw), sseeds, **self.aug_kwargs)
            if self.use_native and native.available():
                crops = np.repeat(np.stack(
                    [pb["y0"], pb["x0"], pb["ch"], pb["cw"]], 1), t, axis=0)
                jit = np.repeat(np.stack(
                    [pb["brightness"], pb["contrast"], pb["saturation"],
                     pb["hue"]], 1).astype(np.float32), t, axis=0)
                frames = native.augment_batch(
                    frames, hw, crops,
                    np.repeat(pb["flip"].astype(np.uint8), t), jit)
            else:
                frames = np.stack([
                    aug.apply_aug_params(f, aug.params_row(pb, i // t), hw)
                    for i, f in enumerate(frames)])
        return frames if t == 1 else frames.reshape(n, t, hw, hw, 3)

    def get_batch(self, indices, augment: bool = False, seed: int = 0):
        indices = np.asarray(indices, dtype=np.int64)
        start = indices // self.episode * self.episode
        win = np.maximum(indices[:, None] + np.arange(1 - self.t, 1),
                         start[:, None])                # (n, T)
        flat = win.reshape(-1)
        out = {"proprio": (self.proprio[indices] if self.t == 1
                           else self.proprio[win]),
               "target_pos": self.pos[indices].copy(),
               "target_quat": self.quat[indices].copy()}
        if self.emit_image_indices:
            fi = win[:, 0] if self.t == 1 else win
            if self.cache_plan is not None:
                fi = self.cache_plan.local_row_of_frame[fi]
            out["image_idx"] = fi.astype(np.int32)
        else:
            out["images"] = {c: self._camera_batch(c, ci, indices, flat,
                                                   augment, seed)
                             for ci, c in enumerate(self.cameras)}
        return out


KERNEL_COUNTERS = ("normalize_u8", "scale_bias_relu",
                   "scale_bias_relu_backward", "channel_stats")


def _counts(fused):
    return {k: getattr(fused, k).launches for k in KERNEL_COUNTERS}


def _zero_counts(fused):
    for k in KERNEL_COUNTERS:
        getattr(fused, k).launches = 0
    fused.scale_bias_relu.grad_layout_copies = 0


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _to_device(batch, dev):
    return {k: ({c: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for c, a in v.items()} if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(dev))
            for k, v in batch.items()}


class ReluTape:
    """The ReLU decisions of one train step, recorded on the card in call
    order and replayed in the same step on the CPU.

    One ReLU input within rounding of 0 takes another side on the card
    than on the CPU, and moves its BatchNorm channel's gradients, and
    those of the layers before it, by percents; a full-width step of
    batch 16 has several such inputs among its 12 million. Replaying the
    card's decisions on the CPU removes that one ambiguity and leaves
    every other difference to the check. Inside ``with tape.record(fused)``
    (card) or ``tape.replay(fused)`` (CPU) ``torch.relu`` and the
    scale_bias_relu Function's forward and backward use the tape; the
    mask of scale_bias_relu is that of its kernels, forward and backward,
    round(round(x*scale) + bias) > 0."""

    def __init__(self):
        self.masks = []
        self.by_ptr = {}
        self.flips = 0
        self.n = 0

    def _patch(self, fused, relu, sbr_forward, sbr_backward):
        import contextlib

        @contextlib.contextmanager
        def patched():
            saved = (torch.relu, fused._sbr_forward,
                     fused.scale_bias_relu_backward)
            torch.relu, fused._sbr_forward = relu, sbr_forward
            if sbr_backward is not None:
                fused.scale_bias_relu_backward = sbr_backward
            try:
                yield self
            finally:
                (torch.relu, fused._sbr_forward,
                 fused.scale_bias_relu_backward) = saved
        return patched()

    @staticmethod
    def _pre(x, scale, bias):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x.float() * scale.view(shape) + bias.view(shape)

    def record(self, fused):
        relu, sbr_forward = torch.relu, fused._sbr_forward

        def rec_relu(x):
            self.masks.append((x > 0).cpu())
            return relu(x)

        def rec_sbr(x, scale, bias):
            self.masks.append((self._pre(x, scale, bias) > 0).cpu())
            return sbr_forward(x, scale, bias)

        return self._patch(fused, rec_relu, rec_sbr, None)

    def save(self, path):
        """The recorded decisions to ``path``, eight to a byte."""
        torch.save([(tuple(m.shape), torch.from_numpy(
            np.packbits(m.numpy().ravel()))) for m in self.masks], path)

    @classmethod
    def joined(cls, paths):
        """The tape of one process for the decisions that the ranks of a
        data-parallel group saved at ``paths`` (in rank order): each
        call's masks joined along the batch rows, rank 0's first."""
        tape = cls()
        saved = [torch.load(p) for p in paths]
        for calls in zip(*saved):
            tape.masks.append(torch.cat([
                torch.from_numpy(np.unpackbits(
                    bits.numpy(), count=math.prod(shape)).astype(bool)
                ).reshape(shape) for shape, bits in calls]))
        return tape

    def replay(self, fused):
        queue = iter(self.masks)

        def take(natural):
            m = next(queue)
            self.flips += int((m != natural.cpu()).sum())
            self.n += m.numel()
            return m.to(natural.device)

        def rep_relu(x):
            m = take(x > 0)
            return torch.where(m, x, torch.zeros_like(x))

        def rep_sbr(x, scale, bias):
            pre = self._pre(x, scale, bias)
            m = take(pre > 0)
            self.by_ptr[x.data_ptr()] = m
            return torch.where(m, pre, torch.zeros_like(pre)).to(x.dtype)

        def rep_sbr_backward(x, g, scale, bias):
            gm = g.float() * self.by_ptr[x.data_ptr()]
            shape = (1, -1) + (1,) * (x.ndim - 2)
            dims = tuple(d for d in range(x.ndim) if d != 1)
            return ((gm * scale.view(shape)).to(x.dtype),
                    torch.sum(gm * x.float(), dim=dims),
                    torch.sum(gm, dim=dims))

        return self._patch(fused, rep_relu, rep_sbr, rep_sbr_backward)


def compare_step_with_cpu(fused, cfg, label, dataset, dev, n=CMP_BATCH):
    """One f32 train step of ``cfg`` from the same seeded weights on the
    same batch of ``n``, on the card and on the CPU: loss, every parameter
    gradient, and the BatchNorm running statistics after the step. The CPU
    step takes the card's ReLU decisions (ReluTape); how many of them
    differ from the CPU's own, and the worst gradient without the tape,
    are printed too. A gradient is held relative to its tensor's largest
    value, but the ViT's attention key bias, whose gradient is 0 in exact
    arithmetic (the softmax removes a term added to all scores of a
    query) and rounding noise on both sides, relative to the model's
    largest gradient."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        forward_backward,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        random_jax_variables,
        state_dict_from_jax,
    )

    cfg = cfg.override(**{"model.dtype": "float32"})
    route = cfg.model.bn_stats
    sd = state_dict_from_jax(random_jax_variables(cfg.model, seed=0),
                             cfg.model)
    batch = dataset.get_batch(np.arange(n), augment=True, seed=5)
    if cfg.model.camera_dropout > 0:
        # the same keep mask on both sides (the card's and the CPU's
        # generators draw other numbers): odd sample i drops camera
        # (i // 2) mod cameras
        keep = np.ones((n, len(cfg.model.cameras)), np.float32)
        odd = np.arange(1, n, 2)
        keep[odd, odd // 2 % keep.shape[1]] = 0.0
        batch["camera_keep"] = keep

    def step(d, tape_mode=None):
        state = create_state(cfg, torch.device(d), sd)
        b = _to_device(batch, d)
        if tape_mode is None:
            m = forward_backward(state.model, b, cfg.train)
        else:
            with tape_mode:
                m = forward_backward(state.model, b, cfg.train)
        out = (float(m["loss"]),
               {k: p.grad.detach().cpu() for k, p in
                state.model.named_parameters()},
               {k: v.detach().cpu() for k, v in state.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))})
        del state
        return out

    tape = ReluTape()
    lg, gg, bg = step(dev, tape.record(fused))
    lc, gc, bc = step("cpu", tape.replay(fused))
    _, g_free, _ = step("cpu")

    largest = max(float(g.abs().max()) for g in gc.values())

    def rel(a, b, key=""):
        scale = (largest if key.endswith("attn.key.bias")
                 else b.abs().max().clamp_min(1e-30))
        return float((a - b).abs().max() / scale)

    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel = {k: rel(gg[k], gc[k], k) for k in gc}
    worst_g = max(grad_rel, key=grad_rel.get)
    free_rel = {k: rel(gg[k], g_free[k], k) for k in gc}
    worst_free = max(free_rel, key=free_rel.get)
    stats_err = {k: ((bg[k] - bc[k]).abs()
                     / (CMP_STATS_ATOL + CMP_STATS_RTOL * bc[k].abs())
                     ).max().item() for k in bc}
    # (no running statistics in a BN-free model, the ViT)
    worst_s = max(stats_err, key=stats_err.get, default=None)
    stats_text = ("none" if worst_s is None else
                  f"worst {worst_s} at {stats_err[worst_s]:.3g} of the "
                  f"tolerance")
    dropped = ("" if "camera_keep" not in batch else
               f"; camera keep mask {batch['camera_keep'].tolist()}")
    print(f"train {label} one step card vs CPU (batch {n}, f32, TF32 "
          f"off{dropped}): loss {lg:.6f} vs {lc:.6f} rel {loss_rel:.3g} (rtol "
          f"{CMP_LOSS_RTOL}); ReLU inputs of another sign on the CPU "
          f"{tape.flips} of {tape.n}; with the card's ReLU decisions worst "
          f"gradient {worst_g} {grad_rel[worst_g]:.3g} of its max (limit "
          f"{CMP_GRAD_REL}); without them {worst_free} "
          f"{free_rel[worst_free]:.3g}; running stats {stats_text} (rtol "
          f"{CMP_STATS_RTOL} atol {CMP_STATS_ATOL})", flush=True)
    vit = cfg.model.backbone == "vit"
    check(tape.n > 0 and (route != "reduce" or bool(tape.by_ptr) or vit),
          f"{label}: the ReLU tape missed the model's ReLUs")
    check(loss_rel <= CMP_LOSS_RTOL, f"{label}: loss differs from the CPU's")
    check(grad_rel[worst_g] <= CMP_GRAD_REL,
          f"{label}: gradient of {worst_g} differs from the CPU's")
    # the ViT's GELU and LayerNorm have no ReLU's ties: held without the
    # tape too
    check(not vit or free_rel[worst_free] <= CMP_GRAD_REL,
          f"{label}: without the card's ReLU decisions the gradient of "
          f"{worst_free} differs from the CPU's")
    check(worst_s is None or stats_err[worst_s] <= 1.0,
          f"{label}: running statistics {worst_s} differ from the CPU's")


def train_cfg(cfg, ckpt_dir, steps=TRAIN_STEPS, eval_every=TRAIN_STEPS,
              **overrides):
    """``cfg`` cut to ``steps`` steps in calls of STEPS_PER_CALL, logging
    at each call, with one eval pass of EVAL_BATCHES at ``eval_every``."""
    return cfg.override(**{
        "train.steps": steps, "train.steps_per_call": STEPS_PER_CALL,
        "train.log_every": STEPS_PER_CALL, "train.eval_every": eval_every,
        "train.eval_steps": EVAL_BATCHES, "train.ckpt_every": 0,
        "train.ckpt_dir": ckpt_dir, **overrides})


def run_training(fused, cfg, label, dataset, dev, smi, state=None,
                 expect_steps=None, profile_iters=4):
    """``cfg``'s training through engine/loop.train_on (from seeded
    weights, or ``state``), with the launch counters set to 0 just before
    and read just after: ``expect_steps`` steps (default train.steps);
    checks the kernel launches of every step and eval forward against the
    model's BN sites, prints step time, images/s, peak memory and the
    device time by kernel group over ``profile_iters`` profiled steps
    after the first call. Returns (launch counts of the run, train_on's
    result with the profiled device ms per step under "busy_ms" when the
    profiler saw the device, the steps' times)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )

    tcfg = cfg.train
    batch = cfg.data.batch_size
    if state is None:
        state = create_state(cfg, dev)
    act_sites, bn_count = bn_sites(state.model)
    steps, evals = [], []
    train_step, eval_step = loop.train_step, loop.eval_step
    # the device cache and augmentation train_on passes to the step, kept
    # for the profile below
    step_data = {}

    def timed_step(st, b, tc, *data):
        step_data["args"] = data
        before = _counts(fused)
        copies = fused.scale_bias_relu.grad_layout_copies
        t = time.perf_counter()
        m = train_step(st, b, tc, *data)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t, _delta(_counts(fused), before),
                      fused.scale_bias_relu.grad_layout_copies - copies))
        return m

    def counted_eval(model, b, tc):
        before = _counts(fused)
        m = eval_step(model, b, tc)
        evals.append(_delta(_counts(fused), before))
        return m

    loop.train_step, loop.eval_step = timed_step, counted_eval
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        _zero_counts(fused)
        out = loop.train_on(cfg, state, dataset, dataset)
        launches = _counts(fused)
        copies = fused.scale_bias_relu.grad_layout_copies
    finally:
        loop.train_step, loop.eval_step = train_step, eval_step
    peak = torch.cuda.max_memory_allocated(dev)

    # one normalize_u8 per camera: every camera's encoder runs in training
    # (camera dropout zeroes features, it skips no encoder); none under
    # device augmentation, whose frames reach the model as floats
    cams = len(state.model.cameras)
    device_aug = cfg.data.augment_device and cfg.data.augment
    want_step = {"normalize_u8": 0 if device_aug else cams,
                 "scale_bias_relu": act_sites,
                 "scale_bias_relu_backward": act_sites, "channel_stats": 0}
    if cfg.model.bn_stats == "pallas":
        want_step.update(scale_bias_relu=0, scale_bias_relu_backward=0,
                         channel_stats=bn_count)
    want_eval = {"normalize_u8": cams, "scale_bias_relu": act_sites,
                 "scale_bias_relu_backward": 0, "channel_stats": 0}
    n_steps = tcfg.steps if expect_steps is None else expect_steps
    n_evals = EVAL_BATCHES if tcfg.eval_every else 0
    check(len(steps) == n_steps and len(evals) == n_evals,
          f"{label}: {len(steps)} steps and {len(evals)} eval forwards, "
          f"expected {n_steps} and {n_evals}")
    for i, (_, seen, _) in enumerate(steps):
        check(seen == want_step, f"{label} step {i + 1}: launches {seen}, "
                                 f"expected {want_step}")
    for i, seen in enumerate(evals):
        check(seen == want_eval, f"{label} eval forward {i + 1}: launches "
                                 f"{seen}, expected {want_eval}")
    met = out["metrics"]
    keys = ("loss", "eval_loss", "eval_pos_mae_cm") if evals else ("loss",)
    check(all(math.isfinite(met[k]) for k in keys),
          f"{label}: non-finite metrics {met}")
    evals_text = (f"eval_loss {met['eval_loss']:.5f} eval_pos_mae_cm "
                  f"{met['eval_pos_mae_cm']:.3f}" if evals else "no eval")
    print(f"train {label}: {len(steps)} steps in calls of "
          f"{tcfg.steps_per_call}, launches per step {want_step} (all "
          f"{len(steps)} steps), per eval forward {want_eval} (all "
          f"{n_evals}); run total {launches}; loss {met['loss']:.5f} "
          f"{evals_text}; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated) ({smi})", flush=True)
    print(f"train {label}: gradient layout copies per step "
          f"{[c for _, _, c in steps]} (total {copies})", flush=True)
    times = [t * 1e3 for t, _, _ in steps]
    warm = tcfg.steps_per_call
    if len(steps) <= warm:
        return launches, out, times

    # steady state: the steps after the first call (kernel builds, cuDNN
    # plans and the first batches land in the first)
    p50, p90 = (float(v) for v in np.percentile(times[warm:], [50, 90]))
    m = cfg.model
    frames = len(state.model.cameras) * m.temporal_frames
    rate = (f"{batch / p50 * 1e3:.1f} images/s" if frames <= 1 else
            f"{batch / p50 * 1e3:.1f} samples/s ({frames} frames each, "
            f"{frames * batch / p50 * 1e3:.1f} frames/s)")
    print(f"train {label} batch {batch}: synchronized step p50 {p50:.3f} ms "
          f"p90 {p90:.3f} ms, {rate} at p50 ({smi})", flush=True)
    pipe = HostPipeline(dataset, cfg.data, device=dev, train=True)
    try:
        prof = device_breakdown(
            lambda: loop.train_step(state, next(pipe), tcfg,
                                    *step_data.get("args", ())),
            iters=profile_iters)
    finally:
        pipe.close()
    if prof is None:
        print(f"profile train {label}: the profiler saw no device time (not "
              "measured)", flush=True)
    else:
        groups, busy_ms, top = prof
        out["busy_ms"] = busy_ms
        print(f"profile train {label}: device busy {busy_ms:.4f} ms per "
              f"step, idle share {1 - busy_ms / p50:.3f} of the p50 step; ms "
              f"per step by kernel group {json.dumps(groups)}; group "
              f"{FOLD_GROUP!r} {groups.get(FOLD_GROUP, 0.0)} ms; the "
              f"{OTHER_GROUP!r} kernels that take most, ms per step "
              f"{json.dumps(top)}", flush=True)
        check(FOLD_GROUP not in groups,
              f"{label}: a second reduction launch ran in the step")
    return launches, out, times


def phase_training(rppt, fused, dev, smi, ckpt_root):
    """pr3 at full width on both BN routes: one step against the CPU, 16
    f32 steps with an eval pass, 8 bf16 steps. Returns ({path: launch
    counts}, the in-memory dataset)."""
    cfg = rppt.preset("pr3")
    m = cfg.model
    dataset = MemoryDemos(cfg, DATASET_BATCHES * BATCH, seed=4)
    print(f"training pr3: {m.backbone} {m.image_size}x{m.image_size}, "
          f"batch {BATCH}, in-memory dataset of {len(dataset)} samples from "
          f"seed 4, host augmentation on", flush=True)
    launches = {}
    for route in ("reduce", "pallas"):
        c = cfg.override(**{"model.bn_stats": route})
        compare_step_with_cpu(fused, c, f"pr3 {route}", dataset, dev)
        counts, out, _ = run_training(
            fused, train_cfg(c, f"{ckpt_root}/pr3_{route}_f32"),
            f"pr3 {route} f32", dataset, dev, smi)
        launches[f"train pr3 {route} f32"] = counts
        del out
        counts, out, _ = run_training(
            fused, train_cfg(c.override(**{"model.dtype": "bfloat16"}),
                             f"{ckpt_root}/pr3_{route}_bf16",
                             steps=STEPS_PER_CALL, eval_every=0),
            f"pr3 {route} bf16", dataset, dev, smi)
        launches[f"train pr3 {route} bf16"] = counts
        del out
    return launches, dataset


def phase_training_pr4(rppt, fused, dev, smi, ckpt_root):
    """pr4 (ResNet-50 at 224x224) as the preset trains it: bf16, batch 256,
    AdamW with cosine warmup, on both BN routes: one f32 step against the
    CPU at batch PR4_CMP_BATCH, then 16 steps with an eval pass."""
    cfg = rppt.preset("pr4")
    m, t = cfg.model, cfg.train
    dataset = MemoryDemos(cfg, DATASET_BATCHES * PR4_BATCH, seed=6)
    print(f"training pr4: {m.backbone} {m.image_size}x{m.image_size} "
          f"{m.dtype}, batch {cfg.data.batch_size}, {t.optimizer} lr {t.lr} "
          f"wd {t.weight_decay} {t.lr_schedule} schedule with "
          f"{t.warmup_steps} warmup steps, remat {m.remat}, in-memory "
          f"dataset of {len(dataset)} samples from seed 6, host "
          f"augmentation on ({cfg.data.num_workers} workers)", flush=True)
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )

    with torch.device("meta"):
        sites = bn_sites(PoseEstimator(m))
    check(sites == (sum(n for _, n in K2_PR4_SITES),
                    sum(n for _, n in K3_PR4_SITES)),
          f"pr4 has {sites} BN-ReLU sites and BatchNorms; the kernel "
          "phases' site lists differ")
    launches = {}
    for route in ("reduce", "pallas"):
        c = cfg.override(**{"model.bn_stats": route})
        compare_step_with_cpu(fused, c, f"pr4 {route}", dataset, dev,
                              n=PR4_CMP_BATCH)
        counts, out, _ = run_training(
            fused, train_cfg(c, f"{ckpt_root}/pr4_{route}"),
            f"pr4 {route} {m.dtype}", dataset, dev, smi)
        launches[f"train pr4 {route}"] = counts
        del out
        torch.cuda.empty_cache()
    return launches


def phase_training_pr2(rppt, fused, dev, smi, ckpt_root):
    """pr2 (CNNSmall at 64x64, batch 64): 16 steps with an eval pass."""
    cfg = rppt.preset("pr2")
    m = cfg.model
    dataset = MemoryDemos(cfg, DATASET_BATCHES * PR2_BATCH, seed=7)
    print(f"training pr2: {m.backbone} {m.image_size}x{m.image_size}, "
          f"batch {cfg.data.batch_size}, in-memory dataset of "
          f"{len(dataset)} samples from seed 7", flush=True)
    counts, out, _ = run_training(fused, train_cfg(cfg, f"{ckpt_root}/pr2"),
                                  "pr2 reduce f32", dataset, dev, smi)
    return {"train pr2": counts}


def pr5_config(rppt):
    """pr5 as the preset has it, in one process (the preset's
    dist.num_devices=8 cut to 1; phase_ddp_pr5 cuts it to 2), with one
    host augmentation thread per core of the card's host (the preset's 32
    would build up to 64 batches of 302 MB ahead of a 16-step run)."""
    return rppt.preset("pr5").override(**{"dist.num_devices": 1,
                                          "data.num_workers": 8})


def phase_training_pr5(rppt, fused, dev, smi, ckpt_root):
    """pr5 (two cameras, 3 frames through ResNet-18 at 128x128 and an LSTM
    each, camera dropout 0.15, bf16, global batch 1024) on both BN routes:
    one f32 step against the CPU at batch PR5_CMP_BATCH with an injected
    camera keep mask. Its bf16 training at batch 1024 with an eval pass
    is phase_device_cache_pr5's host augmentation route. Returns ({path:
    launch counts}, the in-memory dataset)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )

    cfg = pr5_config(rppt)
    m, t = cfg.model, cfg.train
    dataset = MemoryDemos(cfg, PR5_SAMPLES, seed=9, episode=PR5_EPISODE)
    print(f"training pr5: {m.backbone} {m.image_size}x{m.image_size} "
          f"{m.dtype}, cameras {list(m.cameras)}, {m.temporal_frames} frames "
          f"({m.temporal_mode}), camera dropout {m.camera_dropout}, batch "
          f"{cfg.data.batch_size} on {cfg.dist.num_devices} card, "
          f"{t.optimizer} lr {t.lr} {t.lr_schedule} schedule with "
          f"{t.warmup_steps} warmup steps, remat {m.remat}, in-memory "
          f"dataset of {len(dataset)} samples (episodes of {PR5_EPISODE} "
          f"steps) from seed 9, host augmentation on "
          f"({cfg.data.num_workers} workers)", flush=True)
    with torch.device("meta"):
        sites = bn_sites(PoseEstimator(m))
    check(sites == (2 * sum(n for _, n in K2_SITES),
                    2 * sum(n for _, n in K3_SITES)),
          f"pr5 has {sites} BN-ReLU sites and BatchNorms; expected two "
          "ResNet-18s")
    launches = {}
    for route in ("reduce", "pallas"):
        c = cfg.override(**{"model.bn_stats": route})
        compare_step_with_cpu(fused, c, f"pr5 {route}", dataset, dev,
                              n=PR5_CMP_BATCH)
        torch.cuda.empty_cache()
    return {}, dataset


def _checkpoint_differences(path_a, path_b):
    """{part: elements that differ} between two training checkpoints'
    model and optimizer tensors, bit for bit."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    _, sd_a, tr_a = checkpoint.load_training(path_a)
    _, sd_b, tr_b = checkpoint.load_training(path_b)
    opt_a, opt_b = tr_a["optimizer"]["inner"], tr_b["optimizer"]["inner"]
    out = {
        "model": sum(int((sd_a[k] != sd_b[k]).sum()) for k in sd_a),
        "optimizer": sum(int((opt_a["state"][i][k] != opt_b["state"][i][k])
                             .sum()) for i in opt_a["state"]
                         for k in opt_a["state"][i]),
        "count": int(tr_a["optimizer"]["count"] != tr_b["optimizer"]["count"]),
        "sampler": int(tr_a["pipeline"] != tr_b["pipeline"])}
    if "ema" in tr_a or "ema" in tr_b:
        out["ema"] = sum(int((v != tr_b["ema"][k]).sum())
                         for k, v in tr_a["ema"].items())
    acc_a = tr_a["optimizer"].get("accumulated")
    acc_b = tr_b["optimizer"].get("accumulated")
    if acc_a is not None or acc_b is not None:
        out["accumulator"] = sum(int((a != b).sum())
                                 for a, b in zip(acc_a, acc_b)
                                 if a is not None)
    out["micro-step"] = int(tr_a["optimizer"].get("mini_step", 0)
                            != tr_b["optimizer"].get("mini_step", 0))
    return out


def phase_resume(rppt, fused, dev, smi, ckpt_root, dataset, name="pr3",
                 base=None, attention_math=False):
    """``base`` (default the ``name`` preset) on its route and dtype, with
    deterministic cuDNN (whose backward otherwise sums in another order
    from run to run, and Adam's first steps move every weight by about the
    learning rate whatever the size of its gradient): 16 straight steps;
    then 8 steps to a checkpoint, and resume="auto" to 16 in the same
    directory. The resumed run starts at the saved step with the saved
    optimizer count and sampler state, runs the 8 steps left, and ends
    with the straight run's model, optimizer and sampler state bit for
    bit; with camera dropout, every run's keep masks are recorded, and the
    cut and resumed runs must draw the straight run's. Returns the launch
    counts of the three runs and the resumed run's final checkpoint.
    ``attention_math``: scaled_dot_product_attention takes its math
    backend (matmuls and a softmax) in all three runs, whose backward sums
    in one order, where the memory-efficient kernel's backward may not
    (the ViT in f32).
    """
    import contextlib

    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    base = rppt.preset(name) if base is None else base
    ckpt_dir = f"{ckpt_root}/{name}_resume"
    cfg = train_cfg(base, ckpt_dir)
    straight_cfg = train_cfg(base, f"{ckpt_root}/{name}_straight")
    first = cfg.override(**{"train.steps": STEPS_PER_CALL})
    masks = {"straight": [], "first": [], "resumed": []}
    draw = fusion.draw_camera_keep

    @contextlib.contextmanager
    def recording(run):
        def record(*args, **kwargs):
            keep = draw(*args, **kwargs)
            masks[run].append(keep.cpu())
            return keep

        fusion.draw_camera_keep = record
        try:
            yield
        finally:
            fusion.draw_camera_keep = draw

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    contexts = contextlib.ExitStack()
    try:
        if attention_math:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            contexts.enter_context(sdpa_kernel(SDPBackend.MATH))
        with recording("straight"):
            counts_s, straight, _ = run_training(
                fused, straight_cfg, f"{name} resume: 16 straight steps",
                dataset, dev, smi)
        with recording("first"):
            counts_a, _, _ = run_training(
                fused, first, f"{name} resume: first 8 steps", dataset, dev,
                smi)
        _, _, training = checkpoint.load_training(
            checkpoint.step_path(ckpt_dir, STEPS_PER_CALL))
        check(training["step"] == STEPS_PER_CALL
              and training["optimizer"]["count"] == STEPS_PER_CALL
              and training["pipeline"]["consumed"] == STEPS_PER_CALL,
              f"checkpoint at step {STEPS_PER_CALL}: {training['step']}, "
              f"count {training['optimizer']['count']}, "
              f"{training['pipeline']['consumed']} batches consumed")
        with recording("resumed"):
            counts_b, out, times = run_training(
                fused, cfg, f"{name} resume: resumed to 16", dataset, dev,
                smi, state=create_state(cfg, dev),
                expect_steps=TRAIN_STEPS - STEPS_PER_CALL)
    finally:
        contexts.close()
        torch.backends.cudnn.deterministic = deterministic
    st = out["state"]
    _, _, final = checkpoint.load_training(out["ckpt_path"])
    check(len(times) == TRAIN_STEPS - STEPS_PER_CALL
          and st.step == TRAIN_STEPS and st.optimizer.count == TRAIN_STEPS
          and final["pipeline"]["consumed"] == TRAIN_STEPS,
          f"resume ran {len(times)} steps to step {st.step}, count "
          f"{st.optimizer.count}, {final['pipeline']['consumed']} batches")
    differ = _checkpoint_differences(out["ckpt_path"], straight["ckpt_path"])
    loss, want = out["metrics"]["loss"], straight["metrics"]["loss"]
    dropout = cfg.model.camera_dropout > 0
    mask_text = ""
    if dropout:
        # the straight run's profile (run_training) steps on after its
        # TRAIN_STEPS and draws more
        straight_masks = masks["straight"][:TRAIN_STEPS]
        same = [torch.equal(a, b) for a, b in zip(
            masks["first"] + masks["resumed"], straight_masks)]
        dropped = int(sum(int((m == 0).sum()) for m in straight_masks))
        total = sum(m.numel() for m in straight_masks)
        mask_text = (f"; camera keep masks drawn {len(straight_masks)} in "
                     f"the straight run's steps, {len(masks['first'])} + "
                     f"{len(masks['resumed'])} cut and resumed, equal to the "
                     f"straight run's in {sum(same)} of {len(same)} steps, "
                     f"{dropped} of {total} camera entries dropped")
        check(len(straight_masks) == TRAIN_STEPS and len(same) ==
              TRAIN_STEPS and all(same) and dropped > 0,
              f"{name} resume: the camera keep masks differ from the "
              "straight run's, or none dropped")
    print(f"resume {name} (deterministic cuDNN"
          f"{', the math attention backend' if attention_math else ''}): "
          f"checkpoint at step "
          f"{STEPS_PER_CALL} (optimizer count {STEPS_PER_CALL}, sampler at "
          f"batch {STEPS_PER_CALL}); resumed {len(times)} steps from it to "
          f"step {st.step} (count {st.optimizer.count}, sampler at batch "
          f"{final['pipeline']['consumed']}); loss at step {TRAIN_STEPS} "
          f"{loss!r} against {want!r} straight; elements that differ from "
          f"the straight run's final state {differ}{mask_text}", flush=True)
    check(loss == want and not any(differ.values()),
          "the resumed run's final state differs from the straight run's")
    launches = {k: counts_s[k] + counts_a[k] + counts_b[k] for k in counts_a}
    return launches, out["ckpt_path"]


def phase_evaluate(rppt, fused, dev, ckpt_path, label="pr3"):
    """api.evaluate_on of the resumed pr3 checkpoint on an in-memory
    dataset of EVAL_SAMPLES, with percentiles and success rates, on the
    card (counts set to 0 just before) against the same checkpoint on the
    CPU. Returns the card run's launch counts."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.api import evaluate_on
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    cfg, state_dict, training = checkpoint.load_training(ckpt_path)
    dataset = MemoryDemos(cfg, EVAL_SAMPLES, seed=8)
    kw = dict(step=training["step"], percentiles=True,
              success_at=((10.0, 45.0), (25.0, 90.0)))
    reports = {}
    for d in ("cpu", dev):
        model = PoseEstimator(cfg.model)
        model.load_state_dict(state_dict)
        model.to(d)
        _zero_counts(fused)
        t = time.perf_counter()
        reports[str(d)] = evaluate_on(cfg, model, dataset, **kw)
        if d != "cpu":
            torch.cuda.synchronize()
            launches = _counts(fused)
        print(f"evaluate {label} on {d}: {time.perf_counter() - t:.2f} s",
              flush=True)
    want, got = reports["cpu"], reports[str(dev)]
    check(sorted(got) == sorted(want), f"evaluate keys {sorted(got)}")
    for k in ("loss", "pos_mae_cm", "rot_mae_deg"):
        check(abs(got[k] - want[k]) <= EVAL_RTOL * abs(want[k]),
              f"evaluate {k}: {got[k]} on the card, {want[k]} on the CPU")
    for k in ("pos_err_cm", "rot_err_deg"):
        for q, v in want[k].items():
            check(abs(got[k][q] - v) <= EVAL_RTOL * abs(v) + EVAL_ROUNDED,
                  f"evaluate {k} {q}: {got[k][q]} against {v}")
    for g_row, w_row in zip(got["success"], want["success"]):
        check(all(abs(g_row[k] - w_row[k]) <= 1.0 / EVAL_SAMPLES + 1e-4
                  for k in ("rate", "pos_rate", "rot_rate")),
              f"evaluate success {g_row} against {w_row}")
    batches = EVAL_SAMPLES // cfg.data.batch_size
    sites, _ = bn_sites(model)
    chunks = batches + math.ceil(EVAL_SAMPLES / 64)
    check(launches["normalize_u8"] == chunks
          and launches["scale_bias_relu"] == sites * chunks,
          f"evaluate launches {launches} for {chunks} forwards")
    print(f"evaluate {label} step {got['step']} card vs CPU: loss "
          f"{got['loss']:.6f} vs {want['loss']:.6f}, pos_mae_cm "
          f"{got['pos_mae_cm']:.4f} vs {want['pos_mae_cm']:.4f}, rot_mae_deg "
          f"{got['rot_mae_deg']:.4f} vs {want['rot_mae_deg']:.4f} (rtol "
          f"{EVAL_RTOL}); pos_err_cm {json.dumps(got['pos_err_cm'])} vs "
          f"{json.dumps(want['pos_err_cm'])}; success {json.dumps(got['success'])}"
          f" vs {json.dumps(want['success'])}; launches {launches}",
          flush=True)
    return launches


def phase_ddp_pr3(cfg, dev, smi, dataset, devices=None, backend="gloo"):
    """``cfg`` (pr3 at full width here) in f32: DDP_STEPS SGD steps
    (``parallel/dist.run_steps``) from seed-0 weights on ``devices``
    (default DDP_RANKS ranks sharing the card) over ``backend``, against
    the same steps in this process: each step's loss, the parameter
    updates, the running statistics (bitwise equal on the ranks) and the
    kernel launches of every step on every rank (none are counted on the
    CPU). Returns the ranks' launch counts, summed."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        random_jax_variables,
        state_dict_from_jax,
    )

    devices = devices or [torch.device("cuda", 0)] * DDP_RANKS
    n = len(devices)
    cfg = cfg.override(**{
        "model.dtype": "float32", "train.optimizer": "sgd",
        "train.lr": DDP_LR, "train.grad_clip": 0.0, "dist.num_devices": n})
    batch, route = cfg.data.batch_size, cfg.model.bn_stats
    sd = state_dict_from_jax(random_jax_variables(cfg.model, seed=0),
                             cfg.model)
    batches = [dataset.get_batch(np.arange(i * batch, (i + 1) * batch),
                                 augment=True, seed=i)
               for i in range(DDP_STEPS)]
    t = time.perf_counter()
    one = dist.run_steps(cfg.override(**{"dist.num_devices": 1}), dev, sd,
                         batches)
    t_one = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dist.launch(dist.run_steps, cfg, devices, backend, sd, batches)
    t_ranks = time.perf_counter() - t
    loss_rel = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                   for r in ranks for g, w in zip(r["losses"], one["losses"]))
    r0, want = ranks[0]["state_dict"], one["state_dict"]
    stats = [k for k in r0 if k.endswith(("running_mean", "running_var"))]
    same = all(torch.equal(r["state_dict"][k], r0[k]) for r in ranks
               for k in r0)
    stats_err = max(((r0[k] - want[k]).abs() / (CMP_STATS_ATOL + CMP_STATS_RTOL
                                                * want[k].abs())).max().item()
                    for k in stats)
    moved = [k for k, v in want.items() if v.is_floating_point()
             and k not in stats and not k.startswith("proprio.proprio_")]
    diff = math.sqrt(sum(float(((r0[k] - want[k]) ** 2).sum())
                         for k in moved))
    update = math.sqrt(sum(float(((want[k] - sd[k]) ** 2).sum())
                           for k in moved))
    launches = [r["launches"] for r in ranks]
    where = ("on the CPU" if dev.type == "cpu" else "sharing one card"
             if len(set(devices)) == 1 else "one card each")
    print(f"ddp pr3 f32 {route}: {n} ranks {where} over {backend}, global "
          f"batch {batch}, {DDP_STEPS} SGD steps at lr {DDP_LR} in "
          f"{t_ranks:.2f} s with the launch (one process {t_one:.2f} s): "
          f"losses {[m['loss'] for m in ranks[0]['losses']]} against "
          f"{[m['loss'] for m in one['losses']]}, worst rel {loss_rel:.3g} "
          f"(rtol {CMP_LOSS_RTOL}); parameter update differs by "
          f"{diff / update:.3g} of its L2 norm (limit {DDP_UPDATE_REL}); "
          f"model state equal on the ranks bit for bit: {same}; running "
          f"statistics worst against one process {stats_err:.3g} of the "
          f"tolerance; launches per step per rank {launches[0][0]} against "
          f"{one['launches'][0]} in one process ({smi})", flush=True)
    check(loss_rel <= CMP_LOSS_RTOL, "ddp pr3: losses differ from one "
                                     "process's")
    check(diff <= DDP_UPDATE_REL * update,
          "ddp pr3: parameter updates differ from one process's")
    check(same, "ddp pr3: the ranks' models differ")
    check(stats_err <= 1.0, "ddp pr3: running statistics differ from one "
                            "process's")
    check(all(seen == one["launches"] for seen in launches)
          and (dev.type == "cpu" or one["launches"][0]["normalize_u8"]),
          f"ddp pr3: launches per rank {launches}, one process "
          f"{one['launches']}")
    return {k: sum(step[k] for r in launches for step in r)
            for k in KERNEL_COUNTERS}


def collective_ms(run, iters):
    """CPU time per call of ``run`` of the profiler's collective events
    (``gloo:``/``nccl:`` and ``c10d::`` ones, which nest). (The kernels'
    device time is left out: two ranks time-slice one card, and each
    rank's kernel durations include the other's slices.)"""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.cpu_time_total / iters / 1e3, 4)
            for e in prof.key_averages()
            if e.key.startswith(("gloo:", "nccl:", "c10d::"))}


def _ddp_pr5_rank(cfg, device, resume_cfg):
    """One rank of phase_ddp_pr5: ``api.train(cfg)`` as this rank of the
    group (the datasets are MemoryDemos: the card's host has no h5py),
    each step timed and its launches counted; two more steps under the
    profiler; then, with deterministic cuDNN, ``resume_cfg`` straight,
    cut at half its steps and resumed, with the camera keep masks of
    every step recorded."""
    import contextlib

    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

    dataset = MemoryDemos(cfg, PR5_SAMPLES, seed=9, episode=PR5_EPISODE)
    loop.build_dataset = lambda c, split="all": dataset
    steps = []
    train_step = loop.train_step

    def timed_step(st, b, tc, *data):
        before = _counts(fused)
        t = time.perf_counter()
        m = train_step(st, b, tc, *data)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t, _delta(_counts(fused),
                                                      before)))
        return m

    loop.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(device)
    try:
        out = rppt.train(cfg, device=device)
    finally:
        loop.train_step = train_step
    peak = torch.cuda.max_memory_allocated(device)
    # the trained model, before the profiled steps below move it
    final = {k: v.detach().to("cpu", copy=True)
             for k, v in out["model"].state_dict().items()}
    pipe = HostPipeline(dataset, cfg.data, device=device, train=True,
                        rank=dist.rank(), world=dist.world())
    try:
        state = out["state"]
        collectives = collective_ms(
            lambda: loop.train_step(state, next(pipe), cfg.train), iters=2)
    finally:
        pipe.close()
    result = {"times": [t * 1e3 for t, _ in steps],
              "launches": [c for _, c in steps], "peak": peak,
              "metrics": out["metrics"], "collectives": collectives,
              "ckpt_path": out["ckpt_path"], "final": final}
    del out, state
    torch.cuda.empty_cache()

    masks = {"straight": [], "first": [], "resumed": []}
    draw = fusion.draw_camera_keep

    @contextlib.contextmanager
    def recording(run):
        def record(*args, **kwargs):
            keep = draw(*args, **kwargs)
            masks[run].append(keep.cpu())
            return keep

        fusion.draw_camera_keep = record
        try:
            yield
        finally:
            fusion.draw_camera_keep = draw

    half = resume_cfg.train.steps // 2
    torch.backends.cudnn.deterministic = True
    ckpt_dir = resume_cfg.train.ckpt_dir
    with recording("straight"):
        straight = rppt.train(resume_cfg.override(
            **{"train.ckpt_dir": f"{ckpt_dir}_straight"}), device=device)
    with recording("first"):
        rppt.train(resume_cfg.override(**{"train.steps": half}),
                   device=device)
    with recording("resumed"):
        resumed = rppt.train(resume_cfg, device=device)
    result["resume"] = {
        "differ": _checkpoint_differences(resumed["ckpt_path"],
                                          straight["ckpt_path"]),
        "loss": (resumed["metrics"]["loss"], straight["metrics"]["loss"]),
        "steps": resumed["state"].step,
        "masks": {k: len(v) for k, v in masks.items()},
        "masks_equal": sum(torch.equal(a, b) for a, b in zip(
            masks["first"] + masks["resumed"], masks["straight"])),
        "dropped": int(sum(int((m == 0).sum()) for m in masks["straight"])),
        "entries": sum(m.numel() for m in masks["straight"])}
    return result


def phase_ddp_pr5(rppt, dev, smi, ckpt_root, devices=None):
    """pr5 at full width, bf16, bn_stats="reduce", global batch 1024 with
    dist.num_devices cut 8 -> DDP_RANKS, the ranks sharing the card over
    gloo: PR5_DDP_STEPS steps through api.train on each rank, step time
    p50/p90 after the first call, samples/s, peak memory per rank, the
    profiler's collective time; then a resume with camera dropout at
    batch PR5_RESUME_BATCH, bit for bit with the straight run. Returns the
    ranks' launch counts, summed."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

    devices = devices or [torch.device("cuda", 0)] * DDP_RANKS
    n = len(devices)
    base = pr5_config(rppt).override(**{
        "dist.num_devices": n, "data.num_workers": PR5_DDP_WORKERS,
        "model.bn_stats": "reduce"})
    cfg = train_cfg(base, f"{ckpt_root}/pr5_ddp", steps=PR5_DDP_STEPS,
                    eval_every=PR5_DDP_STEPS, **{
                        "train.steps_per_call": PR5_DDP_PER_CALL,
                        "train.log_every": PR5_DDP_PER_CALL})
    resume_cfg = train_cfg(base.override(**{
        "data.batch_size": PR5_RESUME_BATCH}), f"{ckpt_root}/pr5_ddp_resume",
        steps=PR5_DDP_STEPS, eval_every=0, **{
            "train.steps_per_call": PR5_DDP_PER_CALL,
            "train.log_every": PR5_DDP_PER_CALL})
    m = cfg.model
    with torch.device("meta"):
        act_sites, _ = bn_sites(PoseEstimator(m))
    want = {"normalize_u8": len(m.cameras), "scale_bias_relu": act_sites,
            "scale_bias_relu_backward": act_sites, "channel_stats": 0}
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dist.launch(_ddp_pr5_rank, cfg, devices, "gloo", resume_cfg)
    t_all = time.perf_counter() - t
    batch = cfg.data.batch_size
    for r, res in enumerate(ranks):
        times = res["times"]
        check(len(times) == PR5_DDP_STEPS, f"ddp pr5 rank {r}: {len(times)} "
                                           f"steps")
        for i, seen in enumerate(res["launches"]):
            check(seen == want, f"ddp pr5 rank {r} step {i + 1}: launches "
                                f"{seen}, expected {want}")
        met = res["metrics"]
        check(all(math.isfinite(met[k]) for k in ("loss", "eval_loss")),
              f"ddp pr5 rank {r}: non-finite metrics {met}")
        p50, p90 = (float(v) for v in np.percentile(
            times[PR5_DDP_PER_CALL:], [50, 90]))
        print(f"ddp pr5 bf16 reduce rank {r} of {n} (sharing one card over "
              f"gloo: correctness and the step's shape, not NVLink or NCCL "
              f"speed): global batch {batch} ({batch // n} per rank), "
              f"synchronized step p50 {p50:.3f} ms p90 {p90:.3f} ms, "
              f"{batch / p50 * 1e3:.1f} samples/s at p50; loss "
              f"{met['loss']:.5f} eval_loss {met['eval_loss']:.5f}; peak "
              f"memory {res['peak'] / 2**30:.2f} GiB (max_memory_allocated "
              f"of the rank); profiler: collectives ms per step (CPU, "
              f"nested) "
              f"{json.dumps(res['collectives'])}; launches per step {want} "
              f"({smi})", flush=True)
        rs = res["resume"]
        print(f"ddp pr5 resume rank {r} (deterministic cuDNN, batch "
              f"{PR5_RESUME_BATCH}): straight {PR5_DDP_STEPS} steps, cut at "
              f"{PR5_DDP_STEPS // 2} and resumed to step {rs['steps']}; loss "
              f"{rs['loss'][0]!r} against {rs['loss'][1]!r}; elements that "
              f"differ from the straight run's final state {rs['differ']}; "
              f"camera keep masks drawn {rs['masks']}, equal to the straight "
              f"run's in {rs['masks_equal']} steps, {rs['dropped']} of "
              f"{rs['entries']} entries dropped", flush=True)
        check(rs["steps"] == PR5_DDP_STEPS and rs["loss"][0] == rs["loss"][1]
              and not any(rs["differ"].values()),
              f"ddp pr5 rank {r}: the resumed run differs from the straight "
              "run")
        check(rs["masks"]["straight"] == PR5_DDP_STEPS
              and rs["masks_equal"] == PR5_DDP_STEPS and rs["dropped"] > 0,
              f"ddp pr5 rank {r}: camera keep masks {rs}")
    print(f"ddp pr5: {n} ranks launched, trained, profiled and resumed in "
          f"{t_all:.2f} s", flush=True)
    # what api.train's launcher returns (engine/loop.fit): rank 0's final
    # checkpoint, restored here on the card
    got = loop.restore_final(cfg, dev, ranks[0]["metrics"],
                             ranks[0]["ckpt_path"])
    restored = got["model"].state_dict()
    differ = {r: sum(not torch.equal(restored[k].cpu(), v)
                     for k, v in res["final"].items())
              for r, res in enumerate(ranks)}
    print(f"ddp pr5: rank 0's final checkpoint restored on "
          f"{next(got['model'].parameters()).device} at step "
          f"{got['state'].step}: tensors that differ from each rank's final "
          f"model {differ}", flush=True)
    check(got["state"].step == PR5_DDP_STEPS
          and next(got["model"].parameters()).device.type == "cuda"
          and sorted(restored) == sorted(ranks[0]["final"])
          and not any(differ.values()),
          f"ddp pr5: the restored state differs from the ranks' ({differ})")
    del got, restored
    torch.cuda.empty_cache()
    return {k: sum(step[k] for res in ranks for step in res["launches"])
            for k in KERNEL_COUNTERS}


def phase_ddp_refusal(rppt):
    """bn_stats="pallas" on 2 devices raises the reference's ValueError,
    the check fit makes before any rank starts."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop

    cfg = pr5_config(rppt).override(**{"dist.num_devices": DDP_RANKS,
                                       "model.bn_stats": "pallas"})
    try:
        loop.check_fit_supported(cfg, DDP_RANKS)
    except ValueError as e:
        check("single-device only" in str(e)
              and f"{DDP_RANKS}-device mesh" in str(e),
              f"ddp pallas refusal: {e}")
        print(f"ddp refusal: bn_stats='pallas' on {DDP_RANKS} devices "
              f"raises ValueError: {e}", flush=True)
        return
    check(False, "bn_stats='pallas' on 2 devices did not raise")


# ---------------------------------------------------------------------------
# the training extras (ROADMAP queue A, item 9) and training across hosts
# (item 8g)
# ---------------------------------------------------------------------------


def _device_batches(dataset, batch, n, dev, first=0):
    return [_to_device(dataset.get_batch(
        np.arange((first + i) * batch, (first + i + 1) * batch),
        augment=True, seed=first + i), dev) for i in range(n)]


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _l2(tensors):
    return math.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors))


def check_accumulation(c, dataset, dev, smi):
    """train.grad_accum against its definition, and the EMA against its
    formula, on the card with deterministic cuDNN: PR5_ACCUM micro-steps
    of a seeded state against one update, by a fresh one-step optimizer,
    from the mean of the same micro-batches' gradients computed one by
    one (with the same dropout generators); then ``ema = d * init + (1 -
    d) * params``. SGD at a constant rate: its update is the gradient's,
    so the check sees every element of it."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        Optimizer,
        dropout_generator,
        forward_backward,
        train_step,
    )

    c = c.override(**{"train.optimizer": "sgd", "train.lr": 1e-3,
                      "train.lr_schedule": "constant",
                      "train.warmup_steps": 0, "train.grad_clip": 0.0})
    batches = _device_batches(dataset, PR5_MICRO, PR5_ACCUM, dev)
    state = create_state(c, dev)
    init = _params(state.model)
    for b in batches:
        train_step(state, b, c.train)
    after = _params(state.model)
    ref = create_state(c, dev)
    grads = []
    for i, b in enumerate(batches):
        forward_backward(ref.model, b, c.train,
                         dropout_generator(c.train.seed, i, dev))
        grads.append({k: p.grad.clone()
                      for k, p in ref.model.named_parameters()})
    one = Optimizer(c.train.__class__(**{**c.train.__dict__,
                                         "grad_accum": 1}),
                    ref.model.parameters())
    for k, p in ref.model.named_parameters():
        p.grad = sum(g[k] for g in grads) / PR5_ACCUM
    one.step()
    want = _params(ref.model)
    update = _l2(after[k] - init[k] for k in after)
    diff = _l2(after[k] - want[k] for k in after)
    d = c.train.ema_decay
    ema_err = max(float((state.ema[k] - (d * init[k] + (1 - d) * after[k]))
                        .abs().max() / after[k].abs().max().clamp_min(1e-30))
                  for k in after)
    print(f"extras pr5 grad_accum {PR5_ACCUM} x batch {PR5_MICRO} "
          f"{c.model.dtype} (deterministic cuDNN, SGD lr 1e-3): the "
          f"accumulated update against one update from the mean of the "
          f"{PR5_ACCUM} micro-gradients: difference {diff / update:.3g} of "
          f"the update's L2 norm {update:.4g} (limit {ACCUM_UPDATE_REL}); "
          f"weights unchanged before the {PR5_ACCUM}th micro-step, "
          f"optimizer count {state.optimizer.count}; EMA {d} against "
          f"d*init + (1-d)*params: worst {ema_err:.3g} of a tensor's "
          f"largest (limit {EMA_REL}) ({smi})", flush=True)
    check(diff <= ACCUM_UPDATE_REL * update and update > 0,
          "grad_accum: the accumulated update differs from one update from "
          "the mean gradient")
    check(state.optimizer.count == 1 and state.step == PR5_ACCUM,
          f"grad_accum: count {state.optimizer.count}, step {state.step}")
    check(ema_err <= EMA_REL, "the EMA differs from its formula")
    return state


def check_recalibration(state, c, dataset, dev, smi):
    """recalibrate_batch_stats of the EMA weights on PR5_RECAL batches,
    with model.bn_momentum m as fit passes it, against the statistics b
    of each BatchNorm's input taken by a hook in f64 (mean, unbiased
    variance) on the same train-mode forwards, mapped through the
    reference's recovery (0.9 old + 0.1 b - m old) / (1 - m) (the layers
    update with 0.9 whatever m is; at m = 0.9 this is b) and averaged over
    the batches; the model's own statistics are left as they were. The
    limit is RECAL_REL at 0.9, scaled by (1 - 0.9) / (1 - m): the
    recovery divides the f32 rounding of the updated statistic by
    1 - m."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        serving,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        recal_generator,
        recalibrate_batch_stats,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
        BatchNormAct,
    )

    model = state.model
    m = c.model.bn_momentum
    limit = RECAL_REL * (1.0 - 0.9) / (1.0 - m)
    batches = _device_batches(dataset, PR5_MICRO, PR5_RECAL, dev,
                              first=PR5_ACCUM)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    layers = {n: mod for n, mod in model.named_modules()
              if isinstance(mod, BatchNormAct)}
    with serving(model, state.ema):
        got = recalibrate_batch_stats(model, batches, c.train.seed,
                                      momentum=m)
        sums = {}

        def hook(name):
            def record(mod, args):
                x = args[0].detach().double()
                dims = [d for d in range(x.ndim) if d != 1]
                n = x.numel() // x.shape[1]
                mean = x.mean(dims)
                var = x.var(dims, correction=1)
                acc = sums.setdefault(name, [0, 0])
                acc[0] = acc[0] + mean / PR5_RECAL
                acc[1] = acc[1] + var / PR5_RECAL
                check(n > 1, f"{name}: one value a channel")
            return record

        handles = [m.register_forward_pre_hook(hook(n))
                   for n, m in model.named_modules()
                   if isinstance(m, BatchNormAct)]
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        try:
            with torch.no_grad():
                model.train()
                for i, b in enumerate(batches):
                    model(b, generator=recal_generator(c.train.seed, i, dev))
        finally:
            for h in handles:
                h.remove()
            model.load_state_dict(saved)
    worst, where = 0.0, ""
    for name, (mean, var) in sums.items():
        layer_m = layers[name].momentum
        for key, batch in ((f"{name}.running_mean", mean),
                           (f"{name}.running_var", var)):
            old = before[key].double()
            want = ((layer_m - m) * old + (1.0 - layer_m) * batch) / (1.0 - m)
            err = float((got[key].double() - want).abs().max()
                        / want.abs().max().clamp_min(1e-30))
            if err > worst:
                worst, where = err, key
    unchanged = all(torch.equal(v, before[k])
                    for k, v in model.state_dict().items())
    print(f"extras pr5 BN recalibration at model.bn_momentum {m} "
          f"({PR5_RECAL} batches of {PR5_MICRO}, the EMA weights, "
          f"{len(sums)} BatchNorms): against the f64 statistics of each "
          f"BatchNorm's input through the reference's recovery, averaged "
          f"over the batches, worst {worst:.3g} of a statistic's largest at "
          f"{where} (limit {limit:.3g}); the model's own statistics "
          f"unchanged: {unchanged} ({smi})", flush=True)
    check(len(sums) > 0 and len(got) == 2 * len(sums),
          "recalibration: statistics missing")
    check(worst <= limit, f"recalibrated statistics at bn_momentum {m} "
                          "differ from the reference's recovery of the "
                          "batches' statistics")
    check(unchanged, "recalibration changed the model's statistics")


def check_resume_mid_accumulation(fused, c, dataset, dev, ckpt_root, smi):
    """With deterministic cuDNN at batch PR5_RESUME_BATCH: a straight run
    of PR5_ACCUM_STEPS micro-steps that checkpoints at micro-step
    PR5_ACCUM_CUT (mid-way through an update), then a run resumed from
    that checkpoint in another directory: the two final checkpoints
    (weights, recalibrated statistics, EMA, optimizer, sampler) equal bit
    for bit. Returns the launch counts of both runs."""
    import shutil

    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    base = c.override(**{
        "data.batch_size": PR5_RESUME_BATCH,
        "train.steps": PR5_ACCUM_STEPS, "train.steps_per_call": 2,
        "train.log_every": 2, "train.eval_every": 0,
        "train.ckpt_every": PR5_ACCUM_CUT})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counts = []
    try:
        runs = {}
        for name in ("straight", "resumed"):
            cfg = base.override(**{"train.ckpt_dir":
                                   f"{ckpt_root}/pr5_accum_{name}"})
            if name == "resumed":
                os.makedirs(cfg.train.ckpt_dir)
                shutil.copy(checkpoint.step_path(
                    runs["straight"][0].train.ckpt_dir, PR5_ACCUM_CUT),
                    cfg.train.ckpt_dir)
            _zero_counts(fused)
            out = loop.train_on(cfg, create_state(cfg, dev), dataset,
                                dataset)
            torch.cuda.synchronize()
            counts.append(_counts(fused))
            runs[name] = (cfg, out)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cut = checkpoint.load_training(checkpoint.step_path(
        runs["straight"][0].train.ckpt_dir, PR5_ACCUM_CUT))[2]["optimizer"]
    differ = _checkpoint_differences(runs["resumed"][1]["ckpt_path"],
                                     runs["straight"][1]["ckpt_path"])
    losses = [runs[k][1]["metrics"]["loss"] for k in ("resumed", "straight")]
    print(f"extras pr5 resume mid-accumulation (deterministic cuDNN, batch "
          f"{PR5_RESUME_BATCH} x grad_accum {PR5_ACCUM}, EMA, BN "
          f"recalibration at the end): checkpoint at micro-step "
          f"{PR5_ACCUM_CUT} holds micro-step {cut['mini_step']} of update "
          f"{cut['count'] + 1}; resumed to {PR5_ACCUM_STEPS}: loss "
          f"{losses[0]!r} against {losses[1]!r} straight; elements that "
          f"differ from the straight run's final state {differ} ({smi})",
          flush=True)
    check(cut["mini_step"] == PR5_ACCUM_CUT % PR5_ACCUM
          and cut.get("accumulated") is not None,
          "the mid-accumulation checkpoint lacks the accumulator")
    check(losses[0] == losses[1] and not any(differ.values()),
          "the run resumed mid-accumulation differs from the straight run")
    return {k: sum(cnt[k] for cnt in counts) for k in KERNEL_COUNTERS}


def phase_extras_pr5(rppt, fused, dev, smi, ckpt_root, dataset):
    """pr5 at full width, bf16, the preset's batch of 1024 as PR5_ACCUM
    micro-batches of PR5_MICRO, EMA PR5_EMA and PR5_RECAL batches of BN
    recalibration before the eval and the final save: PR5_UPDATES updates
    on each BN route (launches and peak memory from run_training; then
    p50/p90 per update over PR5_TIMED_UPDATES more, synchronized once an
    update as fit runs them, and samples/s); then
    the checks of the accumulated
    update, the EMA, the recalibration and a resume mid-accumulation.
    Returns {path: launch counts}."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    cfg = pr5_config(rppt).override(**{
        "data.batch_size": PR5_MICRO, "train.grad_accum": PR5_ACCUM,
        "train.ema_decay": PR5_EMA,
        "train.ema_bn_recal_batches": PR5_RECAL})
    steps = PR5_UPDATES * PR5_ACCUM
    print(f"extras pr5: {cfg.model.dtype}, micro-batch {PR5_MICRO} x "
          f"grad_accum {PR5_ACCUM} = {PR5_MICRO * PR5_ACCUM} samples an "
          f"update, EMA {PR5_EMA}, BN recalibration {PR5_RECAL} batches, "
          f"{PR5_UPDATES} updates ({steps} micro-steps) a route", flush=True)
    launches = {}
    for route in ("reduce", "pallas"):
        c = cfg.override(**{"model.bn_stats": route})
        label = f"pr5 {route} grad_accum"
        torch.cuda.reset_peak_memory_stats(dev)
        counts, out, _ = run_training(
            fused, train_cfg(c, f"{ckpt_root}/pr5_accum_{route}",
                             steps=steps, eval_every=steps), label,
            dataset, dev, smi)
        peak = torch.cuda.max_memory_allocated(dev)
        launches[f"train {label}"] = counts
        # the run's final checkpoint (the profile below steps on)
        _, final, training = checkpoint.load_training(out["ckpt_path"])
        check(training["optimizer"]["count"] == PR5_UPDATES
              and training["step"] == steps and "ema" in training,
              f"{label}: {training['optimizer']['count']} updates in "
              f"{training['step']} micro-steps")
        # and as fit runs them: one synchronization an update
        pipe = HostPipeline(dataset, c.data, device=dev, train=True)
        updates = []
        try:
            for u in range(1 + PR5_TIMED_UPDATES):
                t = time.perf_counter()
                for _ in range(PR5_ACCUM):
                    loop.train_step(out["state"], next(pipe), c.train)
                torch.cuda.synchronize()
                if u:
                    updates.append((time.perf_counter() - t) * 1e3)
        finally:
            pipe.close()
        p50, p90 = (float(v) for v in np.percentile(updates, [50, 90]))
        print(f"extras {label}: update of {PR5_ACCUM} micro-steps p50 "
              f"{p50:.3f} ms p90 {p90:.3f} ms over {len(updates)} updates "
              f"synchronized once each, "
              f"{PR5_MICRO * PR5_ACCUM / p50 * 1e3:.1f} samples/s at p50; "
              f"peak memory {peak / 2**30:.2f} GiB; launches {counts} "
              f"({smi})", flush=True)
        del out, final, training
        torch.cuda.empty_cache()
    c = cfg.override(**{"model.bn_stats": "reduce"})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _zero_counts(fused)
        state = check_accumulation(c, dataset, dev, smi)
        for momentum in RECAL_MOMENTA:
            check_recalibration(
                state, c.override(**{"model.bn_momentum": momentum}),
                dataset, dev, smi)
        torch.cuda.synchronize()
        launches["extras pr5 checks"] = _counts(fused)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del state
    torch.cuda.empty_cache()
    launches["extras pr5 resume"] = check_resume_mid_accumulation(
        fused, c, dataset, dev, ckpt_root, smi)
    torch.cuda.empty_cache()
    return launches


def _torchvision_resnet18(seed):
    """A torchvision-layout ResNet-18 state_dict of seeded numpy arrays."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv_bn(conv, bn, o, i, k):
        sd[f"{conv}.weight"] = rng.normal(0, 0.05, (o, i, k, k)).astype(
            np.float32)
        sd[f"{bn}.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
        sd[f"{bn}.bias"] = rng.normal(0, 0.1, o).astype(np.float32)
        sd[f"{bn}.running_mean"] = rng.normal(0, 0.1, o).astype(np.float32)
        sd[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for s in range(1, 5):
        w = 64 * 2 ** (s - 1)
        for b in range(2):
            t = f"layer{s}.{b}"
            conv_bn(f"{t}.conv1", f"{t}.bn1", w, cin, 3)
            conv_bn(f"{t}.conv2", f"{t}.bn2", w, w, 3)
            if b == 0 and s > 1:
                conv_bn(f"{t}.downsample.0", f"{t}.downsample.1", w, cin, 1)
            cin = w
    sd["fc.weight"] = rng.normal(0, 0.05, (1000, cin)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def torchvision_vit(seed, image_size, patch, dim, depth, heads,
                    in_channels=3, mlp_ratio=4, classes=1000):
    """A torchvision-layout VisionTransformer state_dict (vit_b_16's key
    names and shapes at these widths) of seeded numpy arrays, the
    classifier included (the import drops it). ``heads`` fixes nothing in
    torch's packed layout; it is how the import splits it."""
    rng = np.random.default_rng(seed)
    tokens = (image_size // patch) ** 2 + 1
    sd = {}

    def put(key, shape, std, mean=0.0):
        sd[key] = rng.normal(mean, std, shape).astype(np.float32)

    def linear(key, o, i):
        put(f"{key}.weight", (o, i), 1.0 / math.sqrt(i))
        put(f"{key}.bias", (o,), 0.02)

    def ln(key):
        put(f"{key}.weight", (dim,), 0.1, 1.0)
        put(f"{key}.bias", (dim,), 0.02)

    put("conv_proj.weight", (dim, in_channels, patch, patch),
        1.0 / math.sqrt(in_channels * patch * patch))
    put("conv_proj.bias", (dim,), 0.02)
    put("class_token", (1, 1, dim), 0.02)
    put("encoder.pos_embedding", (1, tokens, dim), 0.02)
    for i in range(depth):
        t = f"encoder.layers.encoder_layer_{i}"
        ln(f"{t}.ln_1")
        put(f"{t}.self_attention.in_proj_weight", (3 * dim, dim),
            1.0 / math.sqrt(dim))
        put(f"{t}.self_attention.in_proj_bias", (3 * dim,), 0.02)
        linear(f"{t}.self_attention.out_proj", dim, dim)
        ln(f"{t}.ln_2")
        linear(f"{t}.mlp.0", dim * mlp_ratio, dim)
        linear(f"{t}.mlp.3", dim, dim * mlp_ratio)
    ln("encoder.ln")
    linear("heads.head", classes, dim)
    return sd


def _by_hand(model, sd):
    """torchvision ResNet-18 weights copied into every camera encoder of
    ``model``, each key spelled out here."""
    for cam in model.cameras:
        enc = getattr(model, f"encoder_{cam}")
        pairs = [(enc.stem.conv, enc.stem.bn, "conv1", "bn1")]
        for s in range(1, 5):
            for b in range(2):
                blk = getattr(enc, f"stage{s}_block{b}")
                t = f"layer{s}.{b}"
                pairs += [(blk.conv1.conv, blk.conv1.bn, f"{t}.conv1",
                           f"{t}.bn1"),
                          (blk.conv2.conv, blk.conv2.bn, f"{t}.conv2",
                           f"{t}.bn2")]
                if blk.downsample is not None:
                    pairs.append((blk.downsample.conv, blk.downsample.bn,
                                  f"{t}.downsample.0", f"{t}.downsample.1"))
        with torch.no_grad():
            for conv, bn, tc, tb in pairs:
                conv.weight.copy_(torch.from_numpy(sd[f"{tc}.weight"]))
                bn.weight.copy_(torch.from_numpy(sd[f"{tb}.weight"]))
                bn.bias.copy_(torch.from_numpy(sd[f"{tb}.bias"]))
                bn.running_mean.copy_(torch.from_numpy(
                    sd[f"{tb}.running_mean"]))
                bn.running_var.copy_(torch.from_numpy(
                    sd[f"{tb}.running_var"]))


def _early_stop(cfg, dataset, device):
    """loop.train_on of ``cfg`` on ``device``; (its early_stopped_at, the
    values of the early-stopping metric it logged)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )

    out = loop.train_on(cfg, create_state(cfg, device), dataset, dataset)
    with open(os.path.join(cfg.train.ckpt_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    key = f"eval/{cfg.train.ckpt_best_metric or 'loss'}"
    return (out["metrics"].get("early_stopped_at"),
            [r[key] for r in rows if key in r])


def phase_extras_pr3(rppt, fused, dev, smi, ckpt_root, dataset):
    """pr3 at full width in f32, batch 128: model.freeze_backbone for
    PR3_FREEZE_STEPS steps (encoders bit for bit unchanged, their running
    statistics moved, no K2 backward launch: no gradient reaches them);
    train.init_from_torch from a seeded torchvision ResNet-18 .npz (served
    poses equal those of the same weights carried by hand);
    model.proprio_dropout 0.1 (the identity in eval, its rate in
    training); early stopping with an eval every step (the stop step the
    CPU port finds); train.debug_nans on an injected NaN. Returns {path:
    launch counts}."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.api import Predictor
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        train_step,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion

    cfg = rppt.preset("pr3").override(**{"model.dtype": "float32"})
    launches = {}
    batches = _device_batches(dataset, BATCH, PR3_FREEZE_STEPS, dev)

    # freeze_backbone
    c = cfg.override(**{"model.freeze_backbone": True})
    state = create_state(c, dev)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _zero_counts(fused)
    for b in batches:
        train_step(state, b, c.train)
    torch.cuda.synchronize()
    counts = _counts(fused)
    launches["extras pr3 freeze_backbone"] = counts
    after = state.model.state_dict()
    enc = [k for k in after if k.startswith("encoder_")]
    params = {k for k, _ in state.model.named_parameters()}
    frozen_same = all(torch.equal(after[k], before[k]) for k in enc
                      if k in params)
    stats_moved = sum(not torch.equal(after[k], before[k]) for k in enc
                      if k.endswith("running_mean"))
    head_moved = sum(not torch.equal(after[k], before[k]) for k in params
                     if not k.startswith("encoder_"))
    sites, _ = bn_sites(state.model)
    want = {"normalize_u8": PR3_FREEZE_STEPS,
            "scale_bias_relu": sites * PR3_FREEZE_STEPS,
            "scale_bias_relu_backward": 0, "channel_stats": 0}
    print(f"extras pr3 freeze_backbone, {PR3_FREEZE_STEPS} steps at batch "
          f"{BATCH}: encoder parameters bit for bit unchanged: "
          f"{frozen_same}; running means moved in {stats_moved} encoder "
          f"BatchNorms; {head_moved} trainable tensors moved; launches "
          f"{counts} against {want} (no gradient reaches the encoder, so "
          f"K2's backward does not run) ({smi})", flush=True)
    check(frozen_same and stats_moved > 0 and head_moved > 0,
          "freeze_backbone: frozen weights moved or statistics did not")
    check(counts == want, "freeze_backbone: launches differ")
    del state
    torch.cuda.empty_cache()

    # init_from_torch, served against the same weights carried by hand
    sd = _torchvision_resnet18(11)
    npz = f"{ckpt_root}/resnet18_torchvision.npz"
    np.savez(npz, **sd)
    c = cfg.override(**{"train.init_from_torch": npz})
    state = create_state(c, dev)
    loop.warm_start(c, state)
    hand = create_state(c, dev)
    _by_hand(hand.model, sd)
    obs = dataset.get_batch(np.arange(8), augment=False)
    _zero_counts(fused)
    got = Predictor(c, state=state, device=dev)(obs)
    torch.cuda.synchronize()
    launches["extras pr3 init_from_torch"] = _counts(fused)
    want = Predictor(c, model=hand.model)(obs)
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    print(f"extras pr3 init_from_torch (seeded torchvision ResNet-18 .npz, "
          f"fc dropped): poses of 8 samples equal those of the same weights "
          f"carried by hand bit for bit: {same}", flush=True)
    check(same, "init_from_torch: served poses differ")
    del state, hand

    # proprio dropout: the identity in eval, its rate in training
    c = cfg.override(**{"model.proprio_dropout": 0.1})
    drop = create_state(c, dev)
    plain = create_state(cfg, dev)
    b = batches[0]
    with torch.no_grad():
        served = drop.model.eval()(b)
        want = plain.model.eval()(b)
        trained = drop.model.train()(
            b, generator=torch.Generator(device=dev).manual_seed(1))
    identity = all(torch.equal(g, w) for g, w in zip(served, want))
    feats = c.model.proprio_features
    y = fusion.proprio_dropout(
        torch.ones((BATCH * 64, feats), device=dev), 0.1,
        torch.Generator(device=dev).manual_seed(2))
    share = float((y == 0).float().mean())
    sigma = math.sqrt(0.1 * 0.9 / y.numel())
    print(f"extras pr3 proprio_dropout 0.1: eval poses equal the model "
          f"without it bit for bit: {identity}; zeroed share in training "
          f"{share:.5f} over {y.numel()} features (0.1 within 3 sigma = "
          f"{3 * sigma:.5f}); kept ones scaled by 1/(1-p): "
          f"{bool(torch.all((y == 0) | (y == 1 / 0.9)))}; a train-mode "
          f"forward is finite: "
          f"{all(bool(torch.isfinite(t).all()) for t in trained)}",
          flush=True)
    check(identity and abs(share - 0.1) <= 3 * sigma
          and bool(torch.all((y == 0) | (y == 1 / 0.9))),
          "proprio_dropout: not the identity in eval or not its rate")
    del drop, plain

    # early stopping: the card's stop step is the CPU port's
    c = cfg.override(**{
        "data.batch_size": EARLY_BATCH, "train.optimizer": "sgd",
        "train.lr": EARLY_LR, "train.lr_schedule": "constant",
        "train.warmup_steps": 0, "train.steps": EARLY_STEPS,
        "train.steps_per_call": 1, "train.log_every": 1,
        "train.eval_every": 1, "train.eval_steps": 1, "train.ckpt_every": 0,
        "train.early_stop_patience": 1})
    small = MemoryDemos(c, 8 * EARLY_BATCH, seed=12)
    stops = {}
    for i, d in enumerate(("cpu", dev)):
        _zero_counts(fused)
        stops[str(d)] = _early_stop(c.override(**{
            "train.ckpt_dir": f"{ckpt_root}/early_{i}"}), small,
            torch.device(d))
        if d != "cpu":
            torch.cuda.synchronize()
            launches["extras pr3 early stop"] = _counts(fused)
    (got, got_l), (want, want_l) = stops[str(dev)], stops["cpu"]
    print(f"extras pr3 early stopping (batch {EARLY_BATCH}, SGD lr "
          f"{EARLY_LR}, eval every step, patience 1, metric "
          f"{c.train.ckpt_best_metric or 'loss'}): stopped at {got} on "
          f"the card, {want} on the CPU; metric {got_l} against {want_l}",
          flush=True)
    check(got is not None and got == want,
          "early stopping: the card stops elsewhere than the CPU")

    # debug_nans
    c = cfg.override(**{"train.debug_nans": True})
    state = create_state(c, dev)
    bad = dict(batches[0], proprio=batches[0]["proprio"].clone())
    bad["proprio"][3, 0] = float("nan")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    raised = ""
    try:
        train_step(state, bad, c.train)
    except FloatingPointError as e:
        raised = str(e)
    unchanged = all(torch.equal(v, before[k])
                    for k, v in state.model.state_dict().items()
                    if not k.endswith(("running_mean", "running_var")))
    print(f"extras pr3 debug_nans: a NaN in one proprio value raised "
          f"FloatingPointError: {raised!r}; weights unchanged: {unchanged}",
          flush=True)
    check(bool(raised) and unchanged, "debug_nans did not stop the step")
    del state
    torch.cuda.empty_cache()
    return launches


def _multihost_rank(cfg, device):
    """One global rank of phase_multihost: fit_rank on the pr3 in-memory
    dataset (the card's host has no h5py), with its launches counted."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

    dataset = MemoryDemos(cfg, DATASET_BATCHES * cfg.data.batch_size, seed=4)
    loop.build_dataset = lambda c, split="all": dataset
    _zero_counts(fused)
    tape = ReluTape()
    with tape.record(fused):
        out = loop.fit_rank(cfg, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    tape_path = os.path.join(os.path.dirname(cfg.train.ckpt_dir),
                             f"relu_tape_{dist.rank()}.pt")
    tape.save(tape_path)
    return {**out, "launches": _counts(fused), "tape": tape_path}


def _multihost_host(cfg_dict, out_path, devices, backend, visible):
    """One host of phase_multihost: with ``visible`` as its
    CUDA_VISIBLE_DEVICES (a host's own cards), ``dist.launch_host`` of a
    rank on each of ``devices`` over ``backend``, then the final
    checkpoint restored here, as ``api.train`` returns it on every
    host."""
    if visible is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.from_dict(cfg_dict)
    ranks = dist.launch_host(_multihost_rank, cfg, devices, backend)
    out = loop.restore_final(cfg, torch.device(devices[0]),
                             ranks[0]["metrics"], ranks[0]["ckpt_path"])
    torch.save({"ranks": ranks, "state_dict": {
        k: v.detach().cpu() for k, v in out["model"].state_dict().items()}},
        out_path)


def phase_multihost(rppt, fused, dev, smi, ckpt_root, dataset, hosts=None,
                    backend="gloo", **overrides):
    """dist.multihost: host processes (dist.process_id 0, 1, .. of
    num_processes, a coordinator on 127.0.0.1), each launching a rank on
    each of its devices over ``backend``; ``hosts`` lists each host's
    (devices, CUDA_VISIBLE_DEVICES or None), by default MULTIHOST_HOSTS
    hosts of one rank on ``dev`` over gloo (NCCL refuses two ranks on one
    card). The ranks train pr3 f32 at batch 128 (dotted ``overrides`` on
    top) on ``dataset``, which each rank makes anew (DATASET_BATCHES
    batches from seed 4) for DDP_STEPS SGD steps with one eval, held
    against one process on ``dev`` under the data-parallel tolerances of
    phase_ddp_pr3. Global rank 0 alone writes; every host restores the
    final checkpoint. Returns the ranks' launch counts, summed."""
    import socket

    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import (
        fused as fused_mod,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = rppt.preset("pr3").override(**{
        "model.dtype": "float32", "train.optimizer": "sgd",
        "train.lr": DDP_LR, "train.grad_clip": 0.0,
        "train.lr_schedule": "constant", "train.warmup_steps": 0,
        "train.steps": DDP_STEPS, "train.steps_per_call": 1,
        "train.log_every": 1, "train.eval_every": DDP_STEPS,
        "train.eval_steps": EVAL_BATCHES, "train.ckpt_every": 0,
        **overrides})
    rank_dev = torch.device("cuda", 0) if dev.type == "cuda" else dev
    hosts = hosts or [([str(rank_dev)], None)] * MULTIHOST_HOSTS
    mh_dir = f"{ckpt_root}/multihost"
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    t = time.perf_counter()
    for p, (devices, visible) in enumerate(hosts):
        cfg = base.override(**{
            "train.ckpt_dir": mh_dir, "dist.multihost": True,
            "dist.num_devices": 0, "dist.num_processes": len(hosts),
            "dist.process_id": p, "dist.coordinator": f"127.0.0.1:{port}"})
        proc = ctx.Process(target=_multihost_host,
                           args=(cfg.to_dict(), f"{ckpt_root}/host{p}.pt",
                                 devices, backend, visible))
        proc.start()
        procs.append(proc)
    try:
        for proc in procs:
            proc.join(timeout=600)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        dist.stop_resource_tracker()
    t_hosts = time.perf_counter() - t
    check(all(proc.exitcode == 0 for proc in procs),
          f"multihost: host exit codes {[p.exitcode for p in procs]}")
    results = [torch.load(f"{ckpt_root}/host{p}.pt", weights_only=False)
               for p in range(len(hosts))]
    one_cfg = base.override(**{"train.ckpt_dir": f"{ckpt_root}/mh_one",
                               "dist.num_devices": 1})
    # one process takes the ranks' ReLU decisions: at 32 px (the CPU
    # rehearsal) a stage-4 BatchNorm normalizes 16 values a channel, and
    # one ReLU input of the first step lies within rounding of 0 (1.1e-5
    # against the channel's 3.2), which the ranks' all-reduced sums put on
    # the other side; the steps after it then differ by 1.6e-2 of the
    # update
    tape = ReluTape.joined([r["tape"] for h in results for r in h["ranks"]])
    with tape.replay(fused_mod):
        one = loop.train_on(one_cfg, create_state(one_cfg, dev), dataset,
                            dataset)
    want = {k: v.detach().cpu() for k, v in one["model"].state_dict().items()}
    init = {k: v.cpu() for k, v in create_state(one_cfg, dev)
            .model.state_dict().items()}
    path = results[0]["ranks"][0]["ckpt_path"]
    _, ckpt_sd, _ = checkpoint.load_training(path)
    restored_equal = all(torch.equal(r["state_dict"][k], v)
                         for r in results for k, v in ckpt_sd.items())
    paths = [r["ckpt_path"] for h in results for r in h["ranks"]]
    files = sorted(os.listdir(mh_dir))

    def rows(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got_rows, want_rows = rows(mh_dir), rows(one_cfg.train.ckpt_dir)
    logged = [r["step"] for r in got_rows if "train/loss" in r]
    loss_rel = max(abs(a["train/loss"] - b["train/loss"]) / abs(b["train/loss"])
                   for a, b in zip(got_rows, want_rows) if "train/loss" in b)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    moved = [k for k, v in want.items() if v.is_floating_point()
             and k not in stats and not k.startswith("proprio.proprio_")]
    diff = _l2(ckpt_sd[k] - want[k] for k in moved)
    update = _l2(want[k] - init[k] for k in moved)
    launches = [r["launches"] for h in results for r in h["ranks"]]
    print(f"multihost pr3 f32: {len(hosts)} host processes with ranks on "
          f"{[d for d, _ in hosts]} (CUDA_VISIBLE_DEVICES "
          f"{[v for _, v in hosts]}) over {backend}, coordinator "
          f"127.0.0.1:{port}, global batch {base.data.batch_size}, "
          f"{DDP_STEPS} SGD steps at lr {DDP_LR} and one eval "
          f"in {t_hosts:.2f} s with the launches; files written "
          f"{files} (train steps logged {logged}); final checkpoint "
          f"{paths}; losses against one process worst rel {loss_rel:.3g} "
          f"(rtol {CMP_LOSS_RTOL}); parameter update differs by "
          f"{diff / update:.3g} of its L2 norm (limit {DDP_UPDATE_REL}), "
          f"one process taking the ranks' ReLU decisions (of another sign "
          f"there: {tape.flips} of {tape.n}); both hosts' restored models equal the checkpoint bit for bit: "
          f"{restored_equal}; launches per rank {launches} ({smi})",
          flush=True)
    check(paths == [checkpoint.step_path(mh_dir, DDP_STEPS)] * len(paths)
          and files == ["metrics.jsonl",
                        os.path.basename(paths[0])]
          and logged == list(range(1, DDP_STEPS + 1)),
          "multihost: not global rank 0 alone writing one checkpoint")
    check(restored_equal, "multihost: a host restored another state")
    check(loss_rel <= CMP_LOSS_RTOL and diff <= DDP_UPDATE_REL * update,
          "multihost: the run differs from one process's")
    sites, _ = bn_sites(one["model"])
    # (the CPU's plain versions count no launch)
    check(dev.type == "cpu" or all(
        c["scale_bias_relu_backward"] == sites * DDP_STEPS
        for c in launches), f"multihost: launches per rank {launches}")
    return {k: sum(c[k] for c in launches) for k in KERNEL_COUNTERS}



# ---------------------------------------------------------------------------
# the device-resident data path (data.device_cache, data.augment_device)
# and the HTTP server
# ---------------------------------------------------------------------------


def events_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn`` in ms, with CUDA events around
    ``iters`` calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device_aug(rppt, dev, smi):
    """ops/image_augment_device at pr5's shape: (PR5_BATCH, 3, 128 + 2 *
    PR5_CROP_MARGIN, ..., 3) uint8 per camera, both crop modes, hue on,
    the pose mirror on. The card's output against the CPU port's on the
    same injected draws (the first AUG_CPU_ROWS samples: every sample's
    arithmetic is its own), crop and flip bit for bit; the card's time
    with CUDA events for both cameras of a batch, beside the host
    augmentation's for the same batch (MemoryDemos.get_batch through the
    native engine on the host's cores)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        device_aug_of,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import (
        image_augment_device as ida,
    )

    base = pr5_config(rppt).override(**{
        "data.augment_device": True, "data.crop_margin": PR5_CROP_MARGIN,
        "data.hflip_prob": 0.5, "data.hflip_pose_mirror": True,
        "data.jitter_hue": AUG_HUE})
    m = base.model
    hw = m.image_size + 2 * PR5_CROP_MARGIN
    rs = np.random.RandomState(21)
    host = {c: rs.randint(0, 256, (PR5_BATCH, m.temporal_frames, hw, hw, 3),
                          np.uint8) for c in m.cameras}
    q = rs.randn(PR5_BATCH, 4)
    host_batch = {"images": host,
                  "target_pos": rs.uniform(-0.3, 0.3, (PR5_BATCH, 3)).astype(
                      np.float32),
                  "target_quat": (q / np.linalg.norm(q, axis=1, keepdims=True)
                                  ).astype(np.float32)}
    batch = _to_device(host_batch, dev)
    rows = slice(0, AUG_CPU_ROWS)
    cpu_batch = _to_device(
        {"images": {c: v[rows] for c, v in host.items()},
         "target_pos": host_batch["target_pos"][rows],
         "target_quat": host_batch["target_quat"][rows]}, "cpu")
    for crop, over in (("pad-and-crop", {}),
                       ("RandomResizedCrop", {"data.crop_scale": (0.6, 1.0),
                                              "data.crop_ratio": (0.75,
                                                                  1.333)})):
        kw = device_aug_of(base.override(**over))
        gen = torch.Generator(device=dev).manual_seed(3)
        draws = ida.draw_batch_aug(gen, batch, **kw)
        cpu_draws = {c: {k: v[rows].cpu() for k, v in d.items()}
                     for c, d in draws.items()}
        got = ida.augment_batch_images(batch, draws, **kw)
        want = ida.augment_batch_images(cpu_batch, cpu_draws, **kw)
        err = max(float((got["images"][c][rows].cpu() - want["images"][c])
                        .abs().max()) for c in m.cameras)
        geo = dict(kw, jitter_prob=0.0)
        g_geo = ida.augment_batch_images(batch, draws, **geo)
        w_geo = ida.augment_batch_images(cpu_batch, cpu_draws, **geo)
        exact = all(torch.equal(g_geo["images"][c][rows].cpu(),
                                w_geo["images"][c]) for c in m.cameras)
        labels = all(torch.equal(got[k][rows].cpu(), want[k])
                     for k in ("target_pos", "target_quat"))
        flips = int(draws["flip_mask"]["flip"].sum())
        del g_geo, got
        ms = events_ms(lambda: ida.augment_batch_images(batch, draws, **kw))
        print(f"device augment pr5 {crop}: {len(m.cameras)} cameras x "
              f"({PR5_BATCH}, {m.temporal_frames}, {hw}, {hw}, 3) uint8 -> "
              f"{m.image_size}x{m.image_size} f32, hue {AUG_HUE}, pose "
              f"mirror ({flips} of {PR5_BATCH} flipped): card against the "
              f"CPU port on the same draws ({AUG_CPU_ROWS} samples) max abs "
              f"error {err:.3g} (limit {AUG_ATOL}); crop and flip bit for "
              f"bit: {exact}; mirrored labels bit for bit: {labels}; "
              f"{ms:.4f} ms a batch on the card (CUDA events) ({smi})",
              flush=True)
        check(err <= AUG_ATOL and exact and labels and 0 < flips < PR5_BATCH,
              f"device augment {crop} differs from the CPU port")
    del batch
    torch.cuda.empty_cache()
    # the host's augmentation of the same batch's samples: crop, flip and
    # jitter of 2 cameras x 3 frames a sample on the host's cores
    data = MemoryDemos(pr5_config(rppt), PR5_BATCH, seed=22,
                       episode=PR5_EPISODE)
    times = []
    for i in range(3):
        t = time.perf_counter()
        data.get_batch(np.arange(PR5_BATCH), augment=True, seed=i)
        times.append((time.perf_counter() - t) * 1e3)
    print(f"device augment pr5: the host augmentation of a batch of "
          f"{PR5_BATCH} (MemoryDemos.get_batch, native engine, "
          f"{os.cpu_count()} host cores) {float(np.median(times)):.3f} ms "
          f"median of 3 (host clock) ({smi})", flush=True)


def _route_cfg(cfg, route):
    """``cfg`` on one of the three data routes at the same config."""
    if route == "host augmentation":
        return cfg
    over = {"data.device_cache": True}
    if route == "device cache + augment_device":
        over.update({"data.augment_device": True,
                     "data.crop_margin": PR5_CROP_MARGIN})
    else:
        over["data.augment"] = False
    return cfg.override(**over)


def _use_route(dataset, cfg):
    """Point the shared in-memory dataset at ``cfg``'s data route, as
    build_dataset makes a store for it."""
    d = cfg.data
    dataset.emit_image_indices = bool(d.device_cache)
    dataset.cache_plan = None
    dataset.device_aug_hw = (cfg.model.image_size + 2 * d.crop_margin
                             if d.augment_device and d.augment else None)


def phase_device_cache_pr5(rppt, fused, dev, smi, ckpt_root):
    """pr5 bf16 on one card, on MemoryDemos of PR5_CACHE_SAMPLES samples
    in episodes of PR5_EPISODE (two cameras at 128x128), on three data
    routes at the same config: host augmentation (the host pipeline of
    earlier phases), device cache + augment_device (frames at 128 + 2 *
    PR5_CROP_MARGIN in device memory, crop, flip and jitter in the step),
    device cache without augmentation; each at batch PR5_BATCH and at
    PR5_MICRO x PR5_ACCUM accumulated, on both BN routes: step (update)
    p50/p90, the profiler's busy time and idle share, peak memory, and
    launches (no normalize_u8 under augment_device); the host route at
    batch PR5_BATCH evaluates too, and leaves the checkpoint that
    phase_serve serves (cache_reduce_1_0). Then the checks: the
    cache route without augmentation equals the host route without it
    bit for bit over CACHE_CMP_STEPS steps (deterministic cuDNN); a resume
    at step CACHE_CUT under augment_device equals the straight run;
    evaluate_on with and without the cache within EVAL_CACHE_REL; the
    budget refusal. Returns {path: launch counts}."""
    from rgb_proprioceptive_pose_estimator_tpu_torch import api
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

    base = pr5_config(rppt).override(**{"train.steps_per_call": 4})
    t = time.perf_counter()
    dataset = MemoryDemos(base, PR5_CACHE_SAMPLES, seed=9,
                          episode=PR5_EPISODE)
    hw = base.model.image_size + 2 * PR5_CROP_MARGIN
    dataset.build_resized_cache(hw)
    nbytes = {h: sum(a.nbytes for a in dataset.build_resized_cache(h)
                     .values()) for h in (base.model.image_size, hw)}
    print(f"device cache pr5: {len(dataset)} samples in "
          f"{len(dataset.frames_per_demo())} episodes of {PR5_EPISODE}, "
          f"cameras {list(base.model.cameras)}: "
          f"{nbytes[base.model.image_size] / 1e9:.3f} GB of uint8 frames at "
          f"{base.model.image_size}, {nbytes[hw] / 1e9:.3f} GB at {hw} "
          f"(made and resized in {time.perf_counter() - t:.1f} s)",
          flush=True)
    routes = ("host augmentation", "device cache + augment_device",
              "device cache, augment=False")
    launches = {}
    for bn in ("reduce", "pallas"):
        for accum in (1, PR5_ACCUM):
            batch = PR5_BATCH // accum
            c = base.override(**{"model.bn_stats": bn,
                                 "data.batch_size": batch,
                                 "train.grad_accum": accum})
            steps = CACHE_STEPS * accum
            for r, route in enumerate(routes):
                rc = _route_cfg(c, route)
                _use_route(dataset, rc)
                label = (f"pr5 {bn} {route} "
                         + (f"batch {batch}" if accum == 1 else
                            f"{batch} x {accum} accumulated"))
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                # the host route at batch 1024 evaluates too (what
                # phase_training_pr5 ran before); the profile covers one
                # step, or half an update
                evals = steps if (accum == 1 and r == 0) else 0
                counts, out, times = run_training(
                    fused, train_cfg(rc, f"{ckpt_root}/cache_{bn}_{accum}_{r}",
                                     steps=steps, eval_every=evals,
                                     **{"train.steps_per_call": accum}),
                    label, dataset, dev, smi,
                    profile_iters=max(accum // 2, 1))
                peak = torch.cuda.max_memory_allocated(dev)
                launches[f"device cache {label}"] = counts
                warm = accum
                updates = [sum(times[i:i + accum])
                           for i in range(warm, steps, accum)]
                p50, p90 = (float(v) for v in
                            np.percentile(updates, [50, 90]))
                busy = out.get("busy_ms")
                busy_text = ("device busy not measured" if busy is None else
                             f"device busy {busy * accum:.4f} ms an update, "
                             f"idle share {1 - busy * accum / p50:.3f}")
                print(f"device cache {label}: update p50 {p50:.3f} ms p90 "
                      f"{p90:.3f} ms over {len(updates)} updates "
                      f"(synchronized micro-steps summed), "
                      f"{PR5_BATCH / p50 * 1e3:.1f} samples/s; {busy_text}; "
                      f"peak memory {peak / 2**30:.2f} GiB ({smi})",
                      flush=True)
                del out
    torch.cuda.empty_cache()
    c = base.override(**{"model.bn_stats": "reduce",
                         "data.batch_size": CACHE_CMP_BATCH})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        finals = {}
        for route in ("host augmentation", "device cache, augment=False"):
            rc = _route_cfg(c.override(**{"data.augment": False}), route)
            _use_route(dataset, rc)
            _zero_counts(fused)
            out = loop.train_on(train_cfg(
                rc, f"{ckpt_root}/cache_cmp_{len(finals)}",
                steps=CACHE_CMP_STEPS, eval_every=0,
                **{"train.steps_per_call": 1}), create_state(rc, dev),
                dataset, dataset)
            launches[f"device cache pr5 bitwise {route}"] = _counts(fused)
            finals[route] = out["ckpt_path"]
        differ = _checkpoint_differences(*finals.values())
        print(f"device cache pr5: {CACHE_CMP_STEPS} steps at batch "
              f"{CACHE_CMP_BATCH} without augmentation, cache route against "
              f"the host route (deterministic cuDNN): elements that differ "
              f"{differ}", flush=True)
        check(not any(differ.values()), "the cache route's steps differ "
                                        "from the host route's")
        # a resume under augment_device at step CACHE_CUT
        rc = _route_cfg(c.override(**{"data.batch_size": PR5_RESUME_BATCH}),
                        "device cache + augment_device")
        _use_route(dataset, rc)
        runs = {}
        _zero_counts(fused)
        for name, steps, d in (("straight", CACHE_RESUME_STEPS, "straight"),
                               ("cut", CACHE_CUT, "resumed"),
                               ("resumed", CACHE_RESUME_STEPS, "resumed")):
            out = loop.train_on(train_cfg(
                rc, f"{ckpt_root}/cache_resume_{d}", steps=steps,
                eval_every=0, **{"train.steps_per_call": 1,
                                 "train.ckpt_every": CACHE_CUT}),
                create_state(rc, dev), dataset, dataset)
            runs[name] = out
        launches["device cache pr5 resume"] = _counts(fused)
        differ = _checkpoint_differences(runs["straight"]["ckpt_path"],
                                         runs["resumed"]["ckpt_path"])
        ended = runs["resumed"]["state"].step
        print(f"device cache pr5: augment_device at batch "
              f"{PR5_RESUME_BATCH}, {CACHE_RESUME_STEPS} straight steps "
              f"against {CACHE_CUT} and a resume to {CACHE_RESUME_STEPS} "
              f"(deterministic cuDNN): elements that differ {differ}",
              flush=True)
        check(ended == CACHE_RESUME_STEPS and not any(differ.values()),
              "the resumed augment_device run differs from the straight run")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    model = runs["straight"]["model"]
    del runs
    # evaluate_on with and without the cache, the same model
    ev = {}
    for route in ("host augmentation", "device cache, augment=False"):
        rc = _route_cfg(base.override(**{"data.augment": False}), route)
        _use_route(dataset, rc)
        _zero_counts(fused)
        ev[route] = api.evaluate_on(rc, model, dataset,
                                    max_batches=EVAL_CACHE_BATCHES)
        launches[f"evaluate pr5 {route}"] = _counts(fused)
    a, b = ev.values()
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for k in ("loss", "pos_mae_cm", "rot_mae_deg"))
    print(f"device cache pr5: evaluate_on over {EVAL_CACHE_BATCHES} batches "
          f"of {base.data.batch_size}, with the cache {b} against without "
          f"{a}: worst rel {rel:.3g} (limit {EVAL_CACHE_REL})", flush=True)
    check(rel <= EVAL_CACHE_REL, "evaluate_on with the cache differs")
    del model
    # the budget refusal, before anything is allocated on the card
    before = torch.cuda.memory_allocated(dev)
    try:
        loop.upload_image_cache(dataset, hw, dev, budget_bytes=nbytes[hw] - 1)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"device cache pr5: budget {nbytes[hw] - 1} bytes for "
          f"{nbytes[hw]}: {refused!r}", flush=True)
    check("budget" in refused and torch.cuda.memory_allocated(dev) == before,
          "the upload budget did not refuse before allocating")
    _use_route(dataset, base)
    del dataset
    torch.cuda.empty_cache()
    return launches


def _sharded_rank(cfg, device, state_dict, samples, episode):
    """One rank of phase_sharded_cache: train_on with the sharded cache on
    a MemoryDemos made anew from the phase's seed (``samples`` in episodes
    of ``episode``), with the bytes of the cache this rank uploaded and
    its launches counted."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused

    dataset = MemoryDemos(cfg, samples, seed=23, episode=episode)
    uploads = []
    upload = loop.upload_image_cache

    def counted(*args, **kwargs):
        out = upload(*args, **kwargs)
        uploads.append(sum(t.numel() * t.element_size()
                           for t in out.values()))
        return out

    loop.upload_image_cache = counted
    _zero_counts(fused)
    out = loop.train_on(cfg, create_state(cfg, device, state_dict), dataset,
                        dataset)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"cache_bytes": uploads, "launches": _counts(fused),
            "state_dict": {k: v.detach().cpu() for k, v in
                           out["model"].state_dict().items()},
            "plan_rows": dataset.cache_plan.rows_per_shard}


def phase_sharded_cache(rppt, dev, smi, ckpt_root, devices=None,
                        backend="gloo", **overrides):
    """data.cache_layout="sharded" on DDP_RANKS ranks sharing the card
    over gloo (default; ``devices`` and ``backend`` otherwise): pr3 f32 at
    batch 128 (dotted ``overrides`` on top), DDP_STEPS SGD steps of
    train_on, each rank holding only its shard of the frames (its cache
    bytes printed), against one process fed the same global batches (the
    shard-constrained sampler's, gathered from one replicated cache), with
    phase_ddp_pr3's tolerances. Returns the ranks' launch counts, summed."""
    import json as json_

    from rgb_proprioceptive_pose_estimator_tpu_torch.data.cache_shard import (
        build_shard_plan,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.convert import (
        random_jax_variables,
        state_dict_from_jax,
    )

    devices = devices or [torch.device("cuda", 0)] * DDP_RANKS
    n = len(devices)
    cfg = rppt.preset("pr3").override(**{
        "model.dtype": "float32", "train.optimizer": "sgd",
        "train.lr": DDP_LR, "train.grad_clip": 0.0,
        "train.lr_schedule": "constant", "train.warmup_steps": 0,
        "train.steps": DDP_STEPS, "train.steps_per_call": 1,
        "train.log_every": 1, "train.eval_every": 0, "train.ckpt_every": 0,
        "data.device_cache": True, "data.augment": False,
        "data.cache_layout": "sharded", "dist.num_devices": n,
        "train.ckpt_dir": f"{ckpt_root}/sharded", **overrides})
    sd = state_dict_from_jax(random_jax_variables(cfg.model, seed=0),
                             cfg.model)
    # the one process: the sampler's global batches, as pixels, from the
    # proprio statistics train_on writes into the model
    dataset = MemoryDemos(cfg, SHARD_SAMPLES, seed=23, episode=SHARD_EPISODE)
    if cfg.model.use_proprio and cfg.model.proprio_normalize:
        mean, std = dataset.proprio_stats()
        sd = {**sd, "proprio.proprio_mean": torch.from_numpy(mean),
              "proprio.proprio_std": torch.from_numpy(std)}
    plan = build_shard_plan(dataset.frames_per_demo(), n)
    dataset.emit_image_indices = False
    pipe = HostPipeline(dataset, cfg.data, device="cpu", train=True,
                        shard_of_sample=plan.shard_of_sample(
                            dataset.sample_demos()), n_shards=n)
    batches = [{k: ({c: a.numpy() for c, a in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in next(pipe).items()} for _ in range(DDP_STEPS)]
    pipe.close()
    one = dist.run_steps(cfg.override(**{"dist.num_devices": 1}), dev, sd,
                         batches)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dist.launch(_sharded_rank, cfg, devices, backend, sd,
                        SHARD_SAMPLES, SHARD_EPISODE)
    t_ranks = time.perf_counter() - t
    with open(f"{cfg.train.ckpt_dir}/metrics.jsonl") as f:
        losses = [r["train/loss"] for r in map(json_.loads, f)
                  if "train/loss" in r]
    want_losses = [m["loss"] for m in one["losses"]]
    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(losses, want_losses))
    r0, want = ranks[0]["state_dict"], one["state_dict"]
    stats = [k for k in r0 if k.endswith(("running_mean", "running_var"))]
    same = all(torch.equal(r["state_dict"][k], r0[k]) for r in ranks
               for k in r0)
    moved = [k for k, v in want.items() if v.is_floating_point()
             and k not in stats and not k.startswith("proprio.proprio_")]
    diff = math.sqrt(sum(float(((r0[k] - want[k]) ** 2).sum())
                         for k in moved))
    update = math.sqrt(sum(float(((want[k] - sd[k]) ** 2).sum())
                           for k in moved))
    full = sum(a.nbytes for a in dataset.build_resized_cache(
        cfg.model.image_size).values())
    per_rank = [r["cache_bytes"] for r in ranks]
    print(f"sharded cache pr3 f32: {n} ranks over {backend}, "
          f"{SHARD_SAMPLES} samples in episodes of {SHARD_EPISODE}, "
          f"{full} bytes of frames in all; cache bytes per rank {per_rank} "
          f"({ranks[0]['plan_rows']} rows a shard); {DDP_STEPS} SGD steps "
          f"in {t_ranks:.2f} s with the launch: losses {losses} against "
          f"{want_losses} in one process on the same global batches, worst "
          f"rel {loss_rel:.3g} (rtol {CMP_LOSS_RTOL}); update differs by "
          f"{diff / update:.3g} of its L2 norm (limit {DDP_UPDATE_REL}); "
          f"ranks equal bit for bit: {same}; launches per rank "
          f"{[r['launches'] for r in ranks]} ({smi})", flush=True)
    check(len(losses) == DDP_STEPS and loss_rel <= CMP_LOSS_RTOL,
          "sharded cache: losses differ from one process's")
    check(diff <= DDP_UPDATE_REL * update and same,
          "sharded cache: the update differs from one process's")
    check(all(b == [full // n] for b in per_rank),
          f"sharded cache: a rank holds more than its shard {per_rank}")
    check(dev.type == "cpu" or all(r["launches"]["normalize_u8"]
                                   for r in ranks),
          "sharded cache: the ranks launched no kernel")
    return {k: sum(r["launches"][k] for r in ranks)
            for k in KERNEL_COUNTERS}


def _post(port, payload=None, raw=None, path="/predict"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = raw if raw is not None else (
        None if payload is None else json.dumps(payload))
    conn.request("POST" if body is not None else "GET", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _post_oversized(port, nbytes):
    """The status of a POST that announces ``nbytes`` of body and sends
    none: the server answers from the header alone (a body sent after a
    413 would meet a closed connection)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.putrequest("POST", "/predict")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(nbytes))
    conn.endheaders()
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def _raw_image(img):
    import base64

    return {"b64": base64.b64encode(np.ascontiguousarray(img).tobytes())
            .decode(), "encoding": "raw", "shape": list(img.shape)}


def phase_serve(fused, smi, checkpoints):
    """utils/serve on 127.0.0.1:0 over the checkpoints the earlier phases
    wrote ({name: file}), with "raw" images: each answer equal
    to the in-process Predictor's bit for bit; for a temporal model a
    session of SERVE_FRAMES frames that loses robot0_eye_in_hand on frame
    3 and gets it back, equal to an in-process ObsBuffer + Predictor; a
    413 and a 400; p50/p90 per request at 1 client and at SERVE_CLIENTS
    clients with coalesce_ms SERVE_COALESCE_MS (host clock). Returns
    {path: launch counts}."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import (
        checkpoint,
        serve,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer import (
        ObsBuffer,
    )

    launches = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, path in checkpoints.items():
            cfg = checkpoint.load_training(path)[0]
            m = cfg.model
            rs = np.random.RandomState(31)
            hw = m.image_size

            def frame(dead=()):
                obs = {"images": {c: rs.randint(0, 256, (hw, hw, 3),
                                                np.uint8)
                                  for c in m.cameras if c not in dead}}
                if m.use_proprio:
                    obs["proprio"] = rs.randn(m.proprio_dim).astype(
                        np.float32)
                return obs

            def window():
                t = (m.temporal_frames,) if m.temporal_frames > 1 else ()
                obs = {"images": {c: rs.randint(0, 256, t + (hw, hw, 3),
                                                np.uint8)
                                  for c in m.cameras}}
                if m.use_proprio:
                    obs["proprio"] = rs.randn(*t, m.proprio_dim).astype(
                        np.float32)
                return obs

            def payload(obs, **extra):
                out = {"images": {c: _raw_image(v)
                                  for c, v in obs["images"].items()},
                       **extra}
                if "proprio" in obs:
                    out["proprio"] = obs["proprio"].tolist()
                return out

            _zero_counts(fused)
            for coalesce in (0.0, SERVE_COALESCE_MS):
                service = serve.PoseService(cfg, ckpt_path=path,
                                            max_batch=SERVE_CLIENTS,
                                            coalesce_ms=coalesce)
                httpd = serve.make_server(service, port=0,
                                          max_body_mb=SERVE_MAX_BODY_MB)
                port = httpd.server_address[1]
                thread = threading.Thread(target=httpd.serve_forever,
                                          daemon=True)
                thread.start()
                pred = service.predictor
                try:
                    status, health = _post(port, raw=None, path="/healthz")
                    check(status == 200 and health["step"] == service.step,
                          f"serve {name}: /healthz {status} {health}")
                    if coalesce == 0.0:
                        obs = [window() for _ in range(SERVE_REQUESTS)]
                        times, same = [], True
                        for o in obs:
                            t = time.perf_counter()
                            status, out = _post(port, payload(o))
                            times.append((time.perf_counter() - t) * 1e3)
                            pos, quat = pred(o)
                            same &= (status == 200
                                     and out["pos"] == pos.tolist()
                                     and out["quat"] == quat.tolist())
                        p50, p90 = np.percentile(times[1:], [50, 90])
                        print(f"serve {name}: {len(obs)} requests of one "
                              f"sample from 1 client, answers equal to the "
                              f"in-process Predictor bit for bit: {same}; "
                              f"p50 {p50:.3f} ms p90 {p90:.3f} ms a request "
                              f"(host clock) ({smi})", flush=True)
                        check(same, f"serve {name}: an HTTP answer differs "
                                    "from the Predictor's")
                        s413 = _post_oversized(
                            port, int(SERVE_MAX_BODY_MB * 2 ** 20) + 1)
                        s400, e400 = _post(port, raw="{not json")
                        print(f"serve {name}: a body over "
                              f"{SERVE_MAX_BODY_MB} MB -> {s413}; invalid "
                              f"JSON -> {s400} {e400}", flush=True)
                        check(s413 == 413 and s400 == 400,
                              f"serve {name}: {s413} and {s400}")
                        if m.temporal_frames > 1:
                            dead = "robot0_eye_in_hand"
                            buf = ObsBuffer(m)
                            fields, same = [], True
                            for i in range(SERVE_FRAMES):
                                fr = frame((dead,) if i == 2 else ())
                                status, out = _post(port, payload(
                                    fr, session="s", reset=i == 0))
                                pos, quat = pred(buf.push(fr))
                                same &= (status == 200
                                         and out["pos"] == pos.tolist()
                                         and out["quat"] == quat.tolist())
                                fields.append(out.get("dead_cameras", []))
                            print(f"serve {name}: a session of "
                                  f"{SERVE_FRAMES} frames losing {dead} on "
                                  f"frame 3: dead cameras per answer "
                                  f"{fields}; equal to ObsBuffer + "
                                  f"Predictor bit for bit: {same}",
                                  flush=True)
                            want = [[dead] if 2 <= i < 2 + m.temporal_frames
                                    else [] for i in range(SERVE_FRAMES)]
                            check(same and fields == want,
                                  f"serve {name}: the session differs")
                    else:
                        obs = [window() for _ in range(SERVE_CLIENTS)]
                        solo = [pred(o) for o in obs]
                        times, worst = [], 0.0

                        def ask(o):
                            t = time.perf_counter()
                            out = _post(port, payload(o))
                            return out, (time.perf_counter() - t) * 1e3

                        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                            for _ in range(SERVE_ROUNDS):
                                for ((status, out), ms), (pos, _) in zip(
                                        pool.map(ask, obs), solo):
                                    check(status == 200,
                                          f"serve {name}: {status} {out}")
                                    times.append(ms)
                                    worst = max(worst, float(np.abs(
                                        np.asarray(out["pos"]) - pos).max()
                                        / max(np.abs(pos).max(), 1e-12)))
                        h = _post(port, raw=None, path="/healthz")[1]
                        p50, p90 = np.percentile(times, [50, 90])
                        print(f"serve {name}: {SERVE_CLIENTS} clients at "
                              f"once, coalesce_ms {coalesce}: p50 {p50:.3f} "
                              f"ms p90 {p90:.3f} ms a request over "
                              f"{len(times)} (host clock); "
                              f"{h['coalesced_batches']} device calls, mean "
                              f"batch {h['mean_batch']}; poses against the "
                              f"Predictor's one by one worst rel "
                              f"{worst:.3g} (limit {SERVE_COALESCED_REL}) "
                              f"({smi})", flush=True)
                        check(worst <= SERVE_COALESCED_REL
                              and h["mean_batch"] > 1,
                              f"serve {name}: coalesced answers")
                finally:
                    httpd.shutdown()
                    httpd.server_close()
                    service.close()
                    thread.join(timeout=10)
            torch.cuda.synchronize()
            launches[f"serve {name} (HTTP)"] = _counts(fused)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return launches


# ---------------------------------------------------------------------------
# the ViT backbone, serving artifacts and sweeps
# ---------------------------------------------------------------------------


def phase_vit(rppt, fused, dev, smi, ckpt_root):
    """pr3 with the ViT at the ModelConfig defaults: serving in f32 and
    bf16 at batch 1, 8 and 128 against the CPU; one f32 step against the
    CPU (no ReLU tape needed: GELU and LayerNorm have no ties); 16 f32
    steps at batch 128 with an eval pass and 8 bf16 steps; a resume from
    step 8 bit for bit with the straight run (deterministic cuDNN, the
    math attention backend); evaluate_on against the CPU. Returns ({path: launch
    counts}, the f32 run's checkpoint directory)."""
    cfg = rppt.preset("pr3").override(**VIT)
    m = cfg.model
    tokens = (m.image_size // m.vit_patch) ** 2 + (m.vit_pool == "cls")
    dataset = MemoryDemos(cfg, DATASET_BATCHES * BATCH, seed=11)
    print(f"vit pr3: patch {m.vit_patch}, dim {m.vit_dim}, depth "
          f"{m.vit_depth}, {m.vit_heads} heads, {m.vit_pool} pooling, "
          f"{m.image_size}x{m.image_size} ({tokens} tokens), batch {BATCH}, "
          f"in-memory dataset of {len(dataset)} samples from seed 11",
          flush=True)
    paths = {"serving pr3 vit": phase_serving(rppt, fused, smi,
                                              overrides=VIT,
                                              label="pr3 vit")}
    torch.cuda.empty_cache()
    compare_step_with_cpu(fused, cfg, "pr3 vit", dataset, dev)
    f32_dir = f"{ckpt_root}/vit_f32"
    counts, out, _ = run_training(fused, train_cfg(cfg, f32_dir),
                                  "pr3 vit f32", dataset, dev, smi)
    paths["train pr3 vit f32"] = counts
    del out
    counts, out, _ = run_training(
        fused, train_cfg(cfg.override(**{"model.dtype": "bfloat16"}),
                         f"{ckpt_root}/vit_bf16", steps=STEPS_PER_CALL,
                         eval_every=0, **VIT_BF16_CALLS),
        "pr3 vit bf16", dataset, dev, smi)
    paths["train pr3 vit bf16"] = counts
    del out
    torch.cuda.empty_cache()
    paths["resume pr3 vit"], ckpt_path = phase_resume(
        rppt, fused, dev, smi, ckpt_root, dataset, "vit", cfg,
        attention_math=True)
    paths["evaluate pr3 vit"] = phase_evaluate(rppt, fused, dev, ckpt_path,
                                               "pr3 vit")
    return paths, f32_dir


def phase_vit_b16(rppt, fused, dev, smi, ckpt_root):
    """pr3 with the ViT at vit_b_16's widths in bf16: serving at batch 8
    and 128 (batch 8 against the CPU in f32); then weights through
    train.init_from_torch from a torchvision-named state_dict made from
    seed 12, the imported encoder held to that state_dict on the card,
    and 8 steps at batch 128. Returns {path: launch counts}."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine import loop
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import import (
        import_torch_vit,
    )

    cfg = rppt.preset("pr3").override(**VIT_B16,
                                      **{"model.dtype": "bfloat16"})
    m = cfg.model
    tokens = (m.image_size // m.vit_patch) ** 2 + 1
    print(f"vit_b_16 pr3: patch {m.vit_patch}, dim {m.vit_dim}, depth "
          f"{m.vit_depth}, {m.vit_heads} heads, {m.vit_pool} pooling, "
          f"{m.image_size}x{m.image_size} ({tokens} tokens), bf16",
          flush=True)
    paths = {"serving pr3 vit_b_16": phase_serving(
        rppt, fused, smi, batches=(8, BATCH), cpu_batches=(8,),
        overrides=VIT_B16, label="pr3 vit_b_16", dtypes=("bfloat16",))}
    torch.cuda.empty_cache()
    sd = torchvision_vit(12, m.image_size, m.vit_patch, m.vit_dim,
                         m.vit_depth, m.vit_heads)
    npz = f"{ckpt_root}/vit_b_16.npz"
    np.savez(npz, **sd)
    c = train_cfg(cfg.override(**{"train.init_from_torch": npz}),
                  f"{ckpt_root}/vit_b16", steps=STEPS_PER_CALL, eval_every=0,
                  **VIT_BF16_CALLS)
    state = create_state(c, dev)
    t = time.perf_counter()
    loop.warm_start(c, state)
    want = import_torch_vit(sd, m.vit_depth, m.vit_heads)
    got = state.model.encoder_agentview.state_dict()
    equal = [k for k, v in want.items()
             if torch.equal(got[k].cpu(), torch.from_numpy(v))]
    print(f"vit_b_16 init_from_torch: {len(sd)} torchvision tensors "
          f"({sum(v.size for v in sd.values())} values) in "
          f"{time.perf_counter() - t:.2f} s; encoder tensors equal to the "
          f"import on the card {len(equal)} of {len(want)} (the encoder has "
          f"{len(got)}, its projection keeping its own)", flush=True)
    check(len(equal) == len(want) == len(got) - 2,
          "vit_b_16: the imported encoder differs from the state_dict")
    dataset = MemoryDemos(c, DATASET_BATCHES * BATCH, seed=12)
    counts, out, _ = run_training(fused, c, "pr3 vit_b_16 bf16", dataset,
                                  dev, smi, state=state)
    paths["train pr3 vit_b_16 bf16"] = counts
    del out, state
    torch.cuda.empty_cache()
    return paths


_EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from rgb_proprioceptive_pose_estimator_tpu_torch.models import fusion


def refuse(*args, **kwargs):
    raise AssertionError("the artifact built a PoseEstimator")


fusion.PoseEstimator.__init__ = refuse
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
    load_predictor,
)

path, obs_path, out_path, iters = sys.argv[1], sys.argv[2], sys.argv[3], int(
    sys.argv[4])
t = time.perf_counter()
serve = load_predictor(path)
load_s = time.perf_counter() - t
with np.load(obs_path) as z:
    sizes = sorted({int(k.split("_")[1]) for k in z.files})
    obs = {n: {"images": {k.split("_", 2)[2]: z[k] for k in z.files
                          if k.startswith(f"images_{n}_")},
               "proprio": z[f"proprio_{n}"]} for n in sizes}
for n in sizes:
    serve(obs[n])
torch.cuda.synchronize()
kernels = ("normalize_u8", "scale_bias_relu")
for k in kernels:
    getattr(fused, k).launches = 0
out = {}
for n in sizes:
    out[f"pos_{n}"], out[f"quat_{n}"] = serve(obs[n])
launches = {k: getattr(fused, k).launches for k in kernels}
p50 = {}
for n in sizes:
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        serve(obs[n])
        times.append((time.perf_counter() - t) * 1e3)
    p50[n] = float(np.percentile(times, 50))
np.savez(out_path, **out)
print(json.dumps({"launches": launches, "p50_ms": p50, "load_s": load_s}))
"""


def phase_export(rppt, fused, smi, ckpt_root, checkpoints):
    """utils/export.py: each of ``checkpoints`` ({label: checkpoint
    directory}) exported in f32 and int8 at batch EXPORT_MAX_BATCH (traced
    on the CPU), then loaded in a fresh process that has the artifact
    alone (PoseEstimator made unbuildable there) on the card and called at
    batch 1 and 8: K1's and K2's launches counted there, from the counts
    set to 0 just before those calls; f32 answers against the Predictor of
    the checkpoint on the card, int8 against the f32 artifact's; bytes,
    and p50 latency against the Predictor's. Returns {path: launch
    counts}."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
        export_predictor,
    )

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    paths = {}
    for label, ckpt_dir in checkpoints.items():
        path, step = checkpoint.resolve(ckpt_dir)
        cfg = checkpoint.load(path)[0]
        m = cfg.model
        with torch.device("meta"):
            sites = encoder_sites(PoseEstimator(m))
        sizes = (1, EXPORT_MAX_BATCH)
        rs = np.random.RandomState(13)
        obs = {n: {"images": {c: rs.randint(0, 256, (n, m.image_size,
                                                      m.image_size, 3),
                                             np.uint8)
                              for c in m.cameras},
                   "proprio": rs.randn(n, m.proprio_dim).astype(np.float32)}
               for n in sizes}
        obs_path = f"{ckpt_root}/export_obs.npz"
        np.savez(obs_path, **{f"images_{n}_{c}": v
                              for n in sizes
                              for c, v in obs[n]["images"].items()},
                 **{f"proprio_{n}": obs[n]["proprio"] for n in sizes})
        pred = rppt.Predictor(cfg, ckpt_dir, max_batch=EXPORT_MAX_BATCH)
        pred.warmup()
        want = {n: pred(obs[n]) for n in sizes}
        pred_p50 = {n: latency_ms(pred, obs[n], EXPORT_ITERS)[0]
                    for n in sizes}
        del pred
        answers, sizes_bytes = {}, {}
        for quantize in ("none", "int8"):
            kind = "f32" if quantize == "none" else quantize
            t = time.perf_counter()
            art = export_predictor(
                f"{ckpt_root}/{label.replace(' ', '_')}_{quantize}.rppe",
                cfg, ckpt_dir=ckpt_dir, max_batch=EXPORT_MAX_BATCH,
                quantize=quantize)
            export_s = time.perf_counter() - t
            sizes_bytes[quantize] = os.path.getsize(art)
            out_path = f"{ckpt_root}/export_out.npz"
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", _EXPORT_CHILD, art, obs_path,
                 out_path, str(EXPORT_ITERS)],
                capture_output=True, text=True, env=env, cwd=root,
                timeout=600)
            child_s = time.perf_counter() - t
            check(proc.returncode == 0,
                  f"export {label} {kind}: the serving process failed: "
                  f"{proc.stderr[-3000:]}")
            report = json.loads(proc.stdout.strip().splitlines()[-1])
            with np.load(out_path) as z:
                answers[quantize] = {n: (z[f"pos_{n}"], z[f"quat_{n}"])
                                     for n in sizes}
            forwards = len(sizes)
            launches = report["launches"]
            paths[f"export {label} {kind} (fresh process)"] = {
                **launches, "scale_bias_relu_backward": 0,
                "channel_stats": 0}
            print(f"export {label} {kind}: step {step}, max_batch "
                  f"{EXPORT_MAX_BATCH}, {sizes_bytes[quantize]} bytes, "
                  f"traced in {export_s:.2f} s; a fresh process loaded it "
                  f"in {report['load_s']:.2f} s ({child_s:.2f} s in all), "
                  f"launches in its calls at batch {list(sizes)}: "
                  f"{launches}; p50 at batch 1 "
                  f"{report['p50_ms']['1']:.3f} ms and 8 "
                  f"{report['p50_ms'][str(EXPORT_MAX_BATCH)]:.3f} ms against "
                  f"the Predictor's {pred_p50[1]:.3f} and "
                  f"{pred_p50[EXPORT_MAX_BATCH]:.3f} ms ({smi})", flush=True)
            check(launches == {"normalize_u8": forwards,
                               "scale_bias_relu": sites * forwards},
                  f"export {label} {kind}: launches {launches}, expected "
                  f"{forwards} normalize_u8 and {sites * forwards} "
                  "scale_bias_relu")
        for n in sizes:
            (p32, q32), (wp, wq) = answers["none"][n], want[n]
            (p8, q8) = answers["int8"][n]
            err32 = max(float(np.abs(p32 - wp).max()),
                        float(np.abs(q32 - wq).max()))
            err8 = float(np.abs(p8 - p32).max())
            dot = float(np.abs(np.abs(np.sum(q8 * q32, -1)) - 1.0).max())
            print(f"export {label} batch {n}: f32 artifact against the "
                  f"Predictor max_abs_err {err32:.3g} (rtol {EXPORT_RTOL} "
                  f"atol {EXPORT_ATOL}); int8 positions against f32 "
                  f"{err8:.3g} (atol {INT8_POS_ATOL}), 1 - |<q8, q32>| "
                  f"worst {dot:.3g} (atol {INT8_QUAT_ATOL})", flush=True)
            check(np.allclose(p32, wp, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
                  and np.allclose(q32, wq, rtol=EXPORT_RTOL,
                                  atol=EXPORT_ATOL),
                  f"export {label} batch {n}: the f32 artifact differs from "
                  "the Predictor")
            check(err8 <= INT8_POS_ATOL and dot <= INT8_QUAT_ATOL,
                  f"export {label} batch {n}: int8 too far from f32")
        print(f"export {label}: artifact bytes f32 {sizes_bytes['none']} "
              f"int8 {sizes_bytes['int8']} (ratio "
              f"{sizes_bytes['int8'] / sizes_bytes['none']:.4f})",
              flush=True)
    return paths


def phase_sweep(rppt, dev, smi, ckpt_root):
    """utils/sweep.py on the card: pr1 on synthetic data, a grid of two
    learning rates of a few steps each, then the same call again, which
    trains nothing (each run's row is in sweep.jsonl)."""
    cfg = rppt.preset("pr1").override(**{
        "train.steps": 6, "train.eval_every": 6, "train.eval_steps": 2,
        "train.ckpt_every": 6, "train.log_every": 3,
        "data.synthetic_size": 512, "data.batch_size": 32,
        "data.val_fraction": 0.25, "data.num_workers": 1,
        "dist.num_devices": 1})
    out = f"{ckpt_root}/sweep"
    grid = "train.lr=1e-3|1e-4"
    t = time.perf_counter()
    first = rppt.run_sweep(cfg, grid, out, device=dev)
    t_first = time.perf_counter() - t
    t = time.perf_counter()
    again = rppt.run_sweep(cfg, grid, out, device=dev)
    t_again = time.perf_counter() - t
    with open(first["results"]) as f:
        rows = [json.loads(line) for line in f]
    print(f"sweep pr1 on {dev}: grid {grid!r}, {cfg.train.steps} steps a "
          f"run: {first['completed']} runs in {t_first:.2f} s (cached "
          f"{first['cached']}), again in {t_again:.2f} s (cached "
          f"{again['cached']}); best {json.dumps(first['best'])}; rows "
          f"{[(r['run'], r['overrides'], r['eval_pos_mae_cm']) for r in rows]}"
          f" ({smi})", flush=True)
    check(first["completed"] == 2 and first["cached"] == 0
          and again["completed"] == 2 and again["cached"] == 2
          and again["best"] == first["best"] and len(rows) == 2
          and all(math.isfinite(r["eval_pos_mae_cm"]) for r in rows),
          "sweep: runs not recorded, or the second call trained again")


# the port's subpackages; their exports, and the reference's __all__
# names each must resolve (read from the reference's files as text: the
# card's host cannot import the JAX package)
SUBPACKAGES = ("models", "data", "engine", "losses", "ops", "parallel",
               "runtime", "utils")
# modules the card's host lacks, and the JAX package: none may load with
# the port
BANNED = ("jax", "flax", "optax", "h5py", "cv2", "matplotlib", "mujoco",
          "rgb_proprioceptive_pose_estimator_tpu")
QUAT_ATOL = 1e-6
QUAT_DRAWS = 2 ** 20
QUAT_MOMENT_TOL = 0.01

_SURFACE_CHILD = r"""
import json, sys
import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
import importlib
subs, reference, banned = json.loads(sys.argv[1])
unresolved, names = [], 0
for sub, ref_names in zip(subs, reference):
    m = importlib.import_module(f"rgb_proprioceptive_pose_estimator_tpu_torch.{sub}")
    renamed = getattr(m, "REFERENCE_NAMES", {})
    not_owed = getattr(m, "NOT_OWED", {})
    for name in set(m.__all__) | set(ref_names):
        if name in not_owed:
            continue
        obj = m
        try:
            for part in renamed.get(name, name).split("."):
                obj = getattr(obj, part)
            names += 1
        except AttributeError:
            unresolved.append(f"{sub}.{name}")
loaded = sorted({n.split(".")[0] for n in sys.modules} & set(banned))
print(json.dumps({"names": names, "unresolved": unresolved,
                  "loaded": loaded, "version": rppt.__version__}))
"""


def _reference_all(sub: str) -> list:
    """The ``__all__`` list of the reference's subpackage, read from its
    file as text."""
    import ast

    path = (Path(__file__).resolve().parent
            / "rgb_proprioceptive_pose_estimator_tpu" / sub / "__init__.py")
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return list(ast.literal_eval(node.value))
    raise ValueError(f"{path}: no __all__")


def phase_surface(dev, smi):
    """The import surface and the quaternion algebra on the card's host:
    a fresh process imports every subpackage of the port, resolves each
    one's exports and the reference's ``__all__`` names (under the port's
    name where ``REFERENCE_NAMES`` maps one; ``NOT_OWED`` names skipped),
    and loads none of BANNED; the render child's import loads no torch;
    the five quaternion functions on the card against the CPU within
    QUAT_ATOL; ``random_quaternion`` from a CUDA generator: unit norm
    within QUAT_ATOL and a second moment within QUAT_MOMENT_TOL of I/4 at
    QUAT_DRAWS draws."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import pose_math as pm

    t0 = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    arg = json.dumps([SUBPACKAGES, [_reference_all(s) for s in SUBPACKAGES],
                      BANNED])
    proc = subprocess.run([sys.executable, "-c", _SURFACE_CHILD, arg],
                          capture_output=True, text=True, env=env, cwd=root,
                          timeout=300)
    check(proc.returncode == 0, f"surface: the import process failed: "
                                f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not report["unresolved"],
          f"surface: names not resolved {report['unresolved']}")
    check(not report["loaded"], f"surface: loaded {report['loaded']}")
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import rgb_proprioceptive_pose_estimator_tpu_torch.data.playback\n"
         "print('torch' in sys.modules)"],
        capture_output=True, text=True, cwd=root, timeout=120,
        env=dict(env, _RPPE_RENDER_WORKER="1"))
    check(child.returncode == 0 and child.stdout.strip() == "False",
          f"surface: the render child imported torch or failed: "
          f"{child.stdout}{child.stderr[-2000:]}")

    gen = torch.Generator().manual_seed(3)

    def unit(*shape):
        q = torch.randn(*shape, 4, generator=gen)
        return q / q.norm(dim=-1, keepdim=True)

    a, b = unit(4096), unit(1, 4096)
    v = torch.randn(4096, 3, generator=gen)
    axis = torch.randn(4096, 3, generator=gen)
    axis[0] = 0.0
    angle = (torch.rand(4096, generator=gen) * 2 - 1) * math.pi
    u = torch.rand(3, 4096, generator=gen)
    cases = {
        "quat_conjugate": (pm.quat_conjugate, (a,)),
        "quat_multiply": (pm.quat_multiply, (a, b)),
        "quat_rotate": (pm.quat_rotate, (a, v)),
        "quat_from_axis_angle": (pm.quat_from_axis_angle, (axis, angle)),
        "random_quaternion's map": (pm.quat_from_uniform, (u,)),
    }
    errs = {}
    for name, (fn, args) in cases.items():
        want = fn(*args)
        got = fn(*(x.to(dev) for x in args))
        check(got.device.type == "cuda", f"{name}: not on the card")
        errs[name] = float((got.cpu() - want).abs().max())
    worst = max(errs, key=errs.get)
    cuda_gen = torch.Generator(device=dev).manual_seed(7)
    q = pm.random_quaternion((QUAT_DRAWS,), generator=cuda_gen)
    check(q.device.type == "cuda", "random_quaternion: not on the card")
    norm_err = float((q.norm(dim=-1) - 1).abs().max())
    qd = q.double()
    moment_err = float(((qd.T @ qd) / QUAT_DRAWS
                        - torch.eye(4, dtype=torch.float64, device=dev) / 4
                        ).abs().max())
    print(f"surface: {len(SUBPACKAGES)} subpackages, {report['names']} "
          f"names resolved (the port's exports and the reference's, "
          f"version {report['version']}), none of {list(BANNED)} loaded, the "
          f"render child without torch; quaternion functions card vs CPU "
          f"worst {errs[worst]:.3g} ({worst}; limit {QUAT_ATOL}); "
          f"random_quaternion x {QUAT_DRAWS} from a CUDA generator: |q| - 1 "
          f"{norm_err:.3g} (limit {QUAT_ATOL}), E[q q^T] - I/4 "
          f"{moment_err:.3g} (limit {QUAT_MOMENT_TOL}); "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    check(errs[worst] <= QUAT_ATOL, f"surface: {worst} differs from the CPU")
    check(norm_err <= QUAT_ATOL, "random_quaternion: not unit norm")
    check(moment_err <= QUAT_MOMENT_TOL,
          "random_quaternion: second moment is not I/4")


def main() -> int:
    t_start = time.perf_counter()
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
    for source in libs:
        for kernel, regs, spills in ptxas_kernels(_build.ptxas_report(source)):
            print(f"ptxas {source}: {kernel}: {regs} registers, spill stores "
                  f"and loads {spills} bytes", flush=True)
            check(spills == 0, f"{kernel} spills {spills} bytes")
    phase_surface(dev, smi)

    # the JSON line's numbers are pr3's f32 sites; pr4's are printed
    summary = {"normalize_u8": phase_normalize_u8(fused, dev),
               "scale_bias_relu": phase_sbr_forward(fused, dev)}
    summary["channel_stats"] = phase_channel_stats(fused, dev)
    summary["scale_bias_relu_backward"] = phase_sbr_backward(fused, dev)
    phase_normalize_u8(fused, dev, K1_PR4_SHAPES)
    phase_sbr_forward(fused, dev, K2_PR4_SITES, [], "pr4", nonfinite=False)
    phase_channel_stats(fused, dev, K3_PR4_SITES, [], "pr4")
    phase_sbr_backward(fused, dev, K2_PR4_SITES, [], "pr4", nonfinite=False)
    torch.cuda.empty_cache()
    # pr5's stem site, four times pr4's largest
    phase_normalize_u8(fused, dev, K1_PR5_SHAPES)
    phase_sbr_forward(fused, dev, K2_PR5_SITES, [], "pr5 stem",
                      nonfinite=False)
    torch.cuda.empty_cache()
    phase_channel_stats(fused, dev, K2_PR5_SITES, [], "pr5 stem")
    torch.cuda.empty_cache()
    phase_sbr_backward(fused, dev, K2_PR5_SITES, [], "pr5 stem",
                       nonfinite=False)
    torch.cuda.empty_cache()
    # each main path is driven with the counts set to 0 just before it and
    # read just after; a kernel's launches are the sum over the paths
    with tempfile.TemporaryDirectory() as ckpt_root:
        paths = {"serving pr3": phase_serving(rppt, fused, smi)}
        trained, pr3_data = phase_training(rppt, fused, dev, smi,
                                           ckpt_root)
        paths.update(trained)
        paths["serving pr4"] = phase_serving(
            rppt, fused, smi, "pr4", (1, 8, PR4_BATCH), (PR4_CMP_BATCH,))
        torch.cuda.empty_cache()
        paths.update(phase_training_pr4(rppt, fused, dev, smi, ckpt_root))
        paths.update(phase_training_pr2(rppt, fused, dev, smi, ckpt_root))
        paths["resume pr3"], ckpt_path = phase_resume(
            rppt, fused, dev, smi, ckpt_root, pr3_data)
        paths["evaluate pr3"] = phase_evaluate(rppt, fused, dev, ckpt_path)
        torch.cuda.empty_cache()
        dead = "robot0_eye_in_hand"
        paths["serving pr5"] = phase_serving(
            rppt, fused, smi, "pr5", (1, 8), (8, f"8 without {dead}"),
            dead=((8, dead),))
        torch.cuda.empty_cache()
        trained, pr5_data = phase_training_pr5(rppt, fused, dev, smi,
                                               ckpt_root)
        paths.update(trained)
        paths["resume pr5"], _ = phase_resume(
            rppt, fused, dev, smi, ckpt_root, pr5_data, "pr5",
            pr5_config(rppt).override(
                **{"data.batch_size": PR5_RESUME_BATCH}))
        del pr5_data
        torch.cuda.empty_cache()
        # data parallelism: the ranks' kernels are counted in the ranks
        paths["ddp pr3 (2 ranks)"] = phase_ddp_pr3(rppt.preset("pr3"), dev,
                                                   smi, pr3_data)
        paths["ddp pr5 (2 ranks)"] = phase_ddp_pr5(rppt, dev, smi,
                                                   ckpt_root)
        phase_ddp_refusal(rppt)
        # the training extras, then two hosts on the card
        paths.update(phase_extras_pr5(
            rppt, fused, dev, smi, ckpt_root,
            MemoryDemos(pr5_config(rppt), PR5_SAMPLES, seed=9,
                        episode=PR5_EPISODE)))
        paths.update(phase_extras_pr3(rppt, fused, dev, smi, ckpt_root,
                                      pr3_data))
        paths["multihost pr3 (2 hosts)"] = phase_multihost(
            rppt, fused, dev, smi, ckpt_root, pr3_data)
        # the device-resident data path, then the HTTP server over the
        # checkpoints written above
        phase_device_aug(rppt, dev, smi)
        paths.update(phase_device_cache_pr5(rppt, fused, dev, smi,
                                            ckpt_root))
        paths["sharded cache pr3 (2 ranks)"] = phase_sharded_cache(
            rppt, dev, smi, ckpt_root)
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils import (
            checkpoint,
        )

        paths.update(phase_serve(fused, smi, {
            "pr3": ckpt_path,
            "pr5": checkpoint.resolve(
                f"{ckpt_root}/cache_reduce_1_0")[0]}))
        torch.cuda.empty_cache()
        # the ViT backbone at its default and vit_b_16 widths, serving
        # artifacts of pr3's and the ViT's f32 checkpoints in a fresh
        # process, a sweep
        trained, vit_dir = phase_vit(rppt, fused, dev, smi, ckpt_root)
        paths.update(trained)
        paths.update(phase_vit_b16(rppt, fused, dev, smi, ckpt_root))
        paths.update(phase_export(rppt, fused, smi, ckpt_root, {
            "pr3": f"{ckpt_root}/pr3_reduce_f32", "pr3 vit": vit_dir}))
        phase_sweep(rppt, dev, smi, ckpt_root)
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in KERNEL_COUNTERS}
    print(f"launches by main path: {json.dumps(paths)}", flush=True)

    source = "rgb_proprioceptive_pose_estimator_tpu_torch/csrc/fused.cu"
    jax_file = "rgb_proprioceptive_pose_estimator_tpu/ops/pallas_fused.py"
    replaces = {"normalize_u8": f"{jax_file}:57",
                "scale_bias_relu": f"{jax_file}:225",
                "scale_bias_relu_backward": f"{jax_file}:243",
                "channel_stats": f"{jax_file}:144"}
    kernels = []
    for k in KERNEL_COUNTERS:
        check(launches[k] > 0, f"{k} was not launched on the main path")
        s = summary[k]
        kernels.append({"name": k, "route": "cuda", "source": source,
                        "replaces": replaces[k], "launches": launches[k],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s.get("library_ms")})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def stop_children() -> None:
    """Stop every process this script started that is still there:
    multiprocessing's resource tracker, which launching ranks starts (the
    launch stops it, and a late finalizer may start it again), then any
    other child, terminated, killed after 10 s, and reaped."""
    dist = sys.modules.get(
        "rgb_proprioceptive_pose_estimator_tpu_torch.parallel.dist")
    if dist is None:             # the port never loaded: nothing launched
        return
    dist.stop_resource_tracker()
    for pid in dist.child_processes():
        cmd = "?"
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            os.kill(pid, signal.SIGTERM)
            deadline = time.monotonic() + 10
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except OSError:          # it ended and was reaped meanwhile
            pass
        print(f"stopped a process left at the end: {pid} {cmd.strip()}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    stop_children()
    sys.exit(rc)

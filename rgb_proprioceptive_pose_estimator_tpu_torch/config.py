"""Typed dataclass config tree + the five staged presets.

The reference (`[RECALL]` SURVEY.md section 1.3) used per-script argparse flags;
this framework replaces that with one typed config tree (SURVEY.md section 6.6).
The five presets are the staged acceptance configs of BASELINE.json:7-11.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


def _check_enum(name: str, value: str, allowed: Tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclass
class ModelConfig:
    """Model architecture (BASELINE.json:5 -- CNN backbone + proprio MLP,
    late-fused by concat into a shared pose-regression head)."""

    # one of: "none" (proprio-only), "cnn_small", "resnet18", "resnet34",
    # "resnet50", "vit" (TPU-native addition beyond the reference's CNN
    # families -- models/vit.py; sized by the vit_* fields below)
    backbone: str = "resnet18"
    # cameras used as image inputs; one encoder per camera (BASELINE.json:11)
    cameras: Tuple[str, ...] = ("agentview",)
    image_size: int = 128          # 64 / 128 / 224 (BASELINE.json:8-10)
    # proprioceptive branch (BASELINE.json:5,7)
    use_proprio: bool = True
    proprio_dim: int = 32          # robot state vector width
    proprio_hidden: Tuple[int, ...] = (256, 256)
    proprio_features: int = 128    # proprio embedding width
    # dropout rate on the proprio embedding during training (0 = off).
    # At small demo counts an uninformative proprio branch can act as a
    # distractor the head overfits to (docs/DESIGN.md accuracy table,
    # VERDICT r2 weak-5); dropping the branch's features forces the head
    # to keep the image path load-bearing.
    proprio_dropout: float = 0.0
    # z-score the proprio vector with train-split statistics (robomimic-
    # style obs normalization). fit() computes per-dim mean/std from the
    # training data and stores them in the model's batch_stats collection,
    # so checkpoints / exports / Predictor all apply the same affine with
    # no extra plumbing. Off by default (raw-state parity with the
    # reference's plain MLP branch, BASELINE.json:5).
    proprio_normalize: bool = False
    # per-sample probability of dropping each camera's ENTIRE feature
    # vector during training (modality dropout, no rescale): the head
    # learns the all-zero representation a dead/omitted camera presents
    # at inference, so a robot stack losing a sensor degrades gracefully
    # instead of feeding the model out-of-distribution garbage. Serve the
    # failure case by omitting the camera from Predictor obs (a zero
    # camera_mask column rides in the batch) or `evaluate(drop_cameras=)`.
    # Requires a second input source (another camera or proprio).
    camera_dropout: float = 0.0
    image_features: int = 512      # image embedding width (per camera)
    head_hidden: Tuple[int, ...] = (512, 256)
    # rotation parameterization of the head's raw output. "quat": 4 values,
    # normalized (reference parity, BASELINE.json:5). "rot6d": 6 values,
    # Gram-Schmidt to a rotation matrix (Zhou et al. CVPR'19 continuous
    # representation -- no antipodal double cover for the head to fight);
    # converted to a quaternion in-graph, so losses, metrics, checkpoints'
    # eval path, Predictor, and exports all stay quaternion-typed.
    rot_rep: str = "quat"          # "quat" | "rot6d"
    # temporal stacking: number of recent frames stacked as input
    # (BASELINE.json:11). 1 = no stacking.
    temporal_frames: int = 1
    # "channel": T frames stack along channels into one encoder pass;
    # "lstm": per-frame encoding + LSTM over the feature sequence (the
    # reference's temporally-dependent estimator variant, SURVEY.md 1.3).
    # Proprio always flattens T*D.
    temporal_mode: str = "channel"
    # compute dtype policy; params always float32 (BASELINE.json:10 bf16 path)
    dtype: str = "float32"         # "float32" | "bfloat16"
    # use hand-written Pallas fused kernels where available (XLA fusion is the
    # default-correct fallback, SURVEY.md section 8 hard-part 4)
    use_pallas: bool = False
    # training-mode BatchNorm statistics implementation (models/blocks.py):
    # "reduce" = XLA reduce fusions (default -- measured fastest in-step on
    # v5e: the reduces co-fuse with neighboring elementwise work, which the
    # alternatives break up; see docs/DESIGN.md); "matmul" = MXU-routed
    # dot_generals with a hand-written VJP (ops/fused_bn.py, SPMD-safe);
    # "pallas" = one-pass Pallas stats kernel (single-device only)
    bn_stats: str = "reduce"
    # compute the ResNet 7x7/2 stem as an equivalent 4x4/1 conv over a
    # space-to-depth input (C_in 3 -> 12; standard TPU stem optimization,
    # bit-equivalent up to f32 summation order -- models/resnet._S2DStemConv)
    stem_s2d: bool = False
    # rematerialize residual blocks (jax.checkpoint): trades recompute FLOPs
    # for activation HBM -- enables bigger per-chip batches at 224x224
    remat: bool = False
    # finetune mode: exclude the image encoder(s) (params under
    # encoder_<camera>/ and lstm_<camera>/) from optimization via
    # optax.multi_transform + set_to_zero -- correct under weight decay
    # (adamw's decay term must not touch frozen params). BN running
    # statistics in the frozen encoder STILL update during training (the
    # standard finetune caveat; freeze + stats-drift is torch behavior
    # too). Typically combined with utils.torch_import pretrained weights.
    freeze_backbone: bool = False
    # ViT backbone geometry (backbone="vit"): image_size must divide by
    # vit_patch; vit_dim by vit_heads. BN fields (bn_stats, stem_s2d) do
    # not apply to the ViT (LayerNorm only); remat checkpoints per block.
    vit_patch: int = 16
    vit_dim: int = 384
    vit_depth: int = 6
    vit_heads: int = 6
    vit_mlp_ratio: int = 4
    # "mean" token pooling (default) | "cls" class-token readout (the
    # torchvision convention; required for imported vit_b_16-style
    # weights, utils/torch_import.import_torch_vit)
    vit_pool: str = "mean"
    # BatchNorm semantics: torch momentum 0.1 == flax momentum 0.9
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # imagenet-style per-channel normalization applied ON DEVICE to uint8 input
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    def __post_init__(self):
        # validate string enums: a typo'd value silently selecting a
        # default would train the wrong architecture/precision
        _check_enum("model.backbone", self.backbone,
                    ("none", "cnn_small", "resnet18", "resnet34",
                     "resnet50", "vit"))
        _check_enum("model.dtype", self.dtype, ("float32", "bfloat16"))
        _check_enum("model.bn_stats", self.bn_stats,
                    ("reduce", "matmul", "pallas"))
        _check_enum("model.temporal_mode", self.temporal_mode,
                    ("channel", "lstm"))
        _check_enum("model.rot_rep", self.rot_rep, ("quat", "rot6d"))
        if not 0.0 <= self.camera_dropout < 1.0:
            raise ValueError(
                f"model.camera_dropout={self.camera_dropout} must be in "
                "[0, 1)")
        if self.camera_dropout > 0:
            if self.backbone == "none":
                raise ValueError(
                    "model.camera_dropout needs an image path "
                    "(model.backbone is 'none')")
            if len(self.cameras) + int(self.use_proprio) < 2:
                raise ValueError(
                    "model.camera_dropout needs a second input source "
                    "(another camera or use_proprio=True): dropping the "
                    "only input would leave those samples nothing to "
                    "predict from")
        if self.backbone == "vit":
            _check_enum("model.vit_pool", self.vit_pool, ("mean", "cls"))
            if self.image_size % self.vit_patch:
                raise ValueError(
                    f"model.image_size={self.image_size} must be a "
                    f"multiple of model.vit_patch={self.vit_patch}")
            if self.vit_dim % self.vit_heads:
                raise ValueError(
                    f"model.vit_dim={self.vit_dim} must divide by "
                    f"model.vit_heads={self.vit_heads}")


@dataclass
class DataConfig:
    """Data source + host pipeline (BASELINE.json:5 -- HDF5/robosuite-style
    ingestion, async host pipeline so the TPU never stalls)."""

    source: str = "synthetic"      # "synthetic" | "hdf5"
    # HDF5 file(s) when source == "hdf5": one path, a comma-separated
    # list, and/or glob patterns ("/data/lift*.hdf5,/data/can.hdf5") --
    # demos from all files concatenate into one dataset
    # (data/hdf5_store.expand_paths)
    path: str = ""
    batch_size: int = 64           # GLOBAL batch size (split across chips)
    # held-out fraction for eval (hdf5: by demo; synthetic: by index).
    # 0 = eval on the training data (reference research-repo behavior).
    val_fraction: float = 0.0
    # held-out demo file(s) for the val split (same comma/glob syntax as
    # `path`; hdf5 only): training uses ALL of `path`, the periodic eval
    # during fit() and evaluate(split="val") use ALL of `val_path`.
    # Mutually exclusive with val_fraction (fraction splitting).
    val_path: str = ""
    split_seed: int = 0
    # cap the dataset at the first N demos (natural order, before the
    # split) -- robomimic-style n_demos data-efficiency studies. 0 = all.
    max_demos: int = 0
    # robomimic filter key: restrict each file to the demos named in its
    # mask/<filter_key> dataset (applied before max_demos / the split)
    filter_key: str = ""
    num_workers: int = 8           # host decode/augment threads
    prefetch: int = 2              # device-side prefetch depth (double buffer)
    shuffle: bool = True
    seed: int = 0
    # HDF5 layout keys (robomimic-style; SURVEY.md section 4.4)
    image_key_format: str = "obs/{camera}_image"
    # one key, or a comma-separated list of low-dim obs keys concatenated
    # along the feature dim in order (robomimic idiom:
    # "obs/robot0_eef_pos,obs/robot0_eef_quat,obs/robot0_gripper_qpos")
    proprio_key: str = "obs/robot0_proprio-state"
    # target pose: 7 leading dims = pos(3) + quat(4). One key, or a comma
    # list concatenated along the feature dim in order (robomimic often
    # stores them separately: "obs/cube_pos,obs/cube_quat")
    target_key: str = "obs/object"
    # predictive pose targets (hdf5 only): train against the target's pose
    # K steps AHEAD of the observation (label[t] = pose[t+K]) -- "where
    # will the object be when the gripper arrives". Each demo's last K
    # steps are excluded from the sample index so every label exists;
    # a single frame cannot resolve the object's velocity, so K > 0
    # typically needs model.temporal_frames > 1 (measured:
    # scripts/flagship_battery.py, docs/DESIGN.md). 0 = estimate the
    # current pose (reference behavior).
    target_lookahead: int = 0
    # augmentation (C2, BASELINE.json:5,10). Applied on host in uint8;
    # normalize happens on device fused into the model input stage.
    #
    # GEOMETRIC augmentation defaults are OFF for pose targets (VERDICT r1
    # missing-2): a random crop or flip moves the object in the image while
    # the pose label stays in the world/robot frame, so without a camera
    # model the (image, pose) pair becomes inconsistent -- label noise, not
    # regularization. Photometric jitter is label-safe and stays on.
    # To use flips, either accept the noise (hflip_prob > 0 alone, warns)
    # or enable hflip_pose_mirror to transform the label with the image.
    augment: bool = True
    # fuse crop/flip/jitter INTO the jitted train step (BASELINE.json:5
    # "fused host-to-device preprocessing stage"): the host only decodes +
    # resizes to image_size + 2*crop_margin; the device does a fixed-size
    # random crop over the margin + flip + jitter + normalize, all fused
    # by XLA. Offloads weak hosts at the cost of slightly larger frames.
    augment_device: bool = False
    crop_margin: int = 0           # device-aug pad-and-crop margin (geometric)
    crop_scale: Tuple[float, float] = (1.0, 1.0)   # random resized crop area
    # random-resized-crop aspect-ratio range, torchvision convention
    # (log-uniform draw; (1,1) = square windows). torchvision's default for
    # RandomResizedCrop is (3/4, 4/3).
    crop_ratio: Tuple[float, float] = (1.0, 1.0)
    hflip_prob: float = 0.0
    # hflip label consistency: mirror the target pose with the image flip.
    # Valid when target-frame axis `hflip_mirror_axis` maps (up to sign)
    # onto the image x direction; position reflects about
    # hflip_mirror_center, the quaternion is conjugated by the reflection
    # (ops/pose_math.mirror_pose). Forces ONE flip draw per sample shared
    # by all cameras (per-camera flips cannot share one label).
    hflip_pose_mirror: bool = False
    hflip_mirror_axis: int = 0
    hflip_mirror_center: float = 0.0
    jitter_brightness: float = 0.2
    jitter_contrast: float = 0.2
    jitter_saturation: float = 0.2
    # hue shift amplitude in [0, 0.5] full turns (torchvision ColorJitter
    # hue; its default is 0 = off). Supported by every backend: numpy,
    # C++, and the fused device-augment path.
    jitter_hue: float = 0.0
    jitter_prob: float = 0.8
    # synthetic source parameters (C15, BASELINE.json:7)
    synthetic_size: int = 4096     # samples per epoch
    synthetic_noise: float = 0.01
    # use the native C++ host-augment shim when built (runtime/)
    use_native: bool = True
    # Device-resident dataset: upload the deterministically-resized frames
    # to HBM once (replicated across the mesh) and ship only int32 frame
    # indices per batch; the jitted step gathers + (device-)augments. For
    # datasets that fit in HBM this removes the host->device image stream
    # entirely -- pixels are bit-identical to the host path (both gather
    # from the same memoized resize cache). Training with augmentation
    # requires data.augment_device (host-side pixel aug can't run on
    # cached device frames). See docs/DESIGN.md "Device-resident dataset".
    device_cache: bool = False
    # HBM placement of the device cache across the mesh's data axis:
    #   "replicated" -- every device holds the full frame set (default;
    #     capacity capped by ONE chip's HBM, any batch references any
    #     frame);
    #   "sharded" -- frames are partitioned across devices at demo
    #     granularity (data/cache_shard.py): N devices hold N x the
    #     dataset, the sampler draws each device's sub-batch from its own
    #     shard (per-shard stratified sampling), and the in-step gather
    #     stays collective-free (shard_map local take). Resuming a sharded
    #     run requires the same device count (the sampler stream depends
    #     on the shard partition).
    cache_layout: str = "replicated"

    def __post_init__(self):
        _check_enum("data.source", self.source, ("synthetic", "hdf5"))
        if self.hflip_mirror_axis not in (0, 1, 2):
            raise ValueError(
                f"data.hflip_mirror_axis must be 0/1/2, got "
                f"{self.hflip_mirror_axis}")
        if self.hflip_prob > 0 and not self.hflip_pose_mirror:
            import warnings

            warnings.warn(
                "data.hflip_prob > 0 without data.hflip_pose_mirror: flipped "
                "images keep the unflipped pose label, which adds label "
                "noise to image->pose training. Set hflip_pose_mirror=True "
                "(with hflip_mirror_axis/center matching your camera "
                "geometry) or hflip_prob=0.",
                stacklevel=3)
        if not (0.0 <= self.jitter_hue <= 0.5):
            raise ValueError(
                f"data.jitter_hue must be in [0, 0.5] (torchvision "
                f"convention), got {self.jitter_hue}")
        if not (0 < self.crop_ratio[0] <= self.crop_ratio[1]):
            raise ValueError(
                f"data.crop_ratio must be an increasing positive pair, got "
                f"{self.crop_ratio}")
        if self.device_cache and self.augment and not self.augment_device:
            raise ValueError(
                "data.device_cache trains from device-resident frames, so "
                "augmentation must run on device: set "
                "data.augment_device=True (or data.augment=False)")
        if self.device_cache and self.source != "hdf5":
            raise ValueError("data.device_cache applies to the hdf5 image "
                             "source only")
        _check_enum("data.cache_layout", self.cache_layout,
                    ("replicated", "sharded"))
        if self.cache_layout == "sharded" and not self.device_cache:
            raise ValueError(
                "data.cache_layout='sharded' shards the device-resident "
                "frame cache; it requires data.device_cache=True")
        if self.max_demos < 0:
            raise ValueError(
                f"data.max_demos must be >= 0, got {self.max_demos}")
        if self.target_lookahead < 0:
            raise ValueError(f"data.target_lookahead must be >= 0, got "
                             f"{self.target_lookahead}")
        if self.target_lookahead > 0 and self.source != "hdf5":
            raise ValueError(
                "data.target_lookahead applies to the hdf5 source only "
                "(synthetic data has no trajectory time axis)")
        if self.val_path:
            if self.val_fraction > 0:
                raise ValueError(
                    "data.val_path and data.val_fraction are mutually "
                    "exclusive (a separate held-out file vs fraction "
                    "splitting)")
            if self.source != "hdf5":
                raise ValueError(
                    "data.val_path applies to the hdf5 source only")


@dataclass
class TrainConfig:
    """Training loop (C7-C9; BASELINE.json:5)."""

    steps: int = 1000
    optimizer: str = "adam"        # "adam" | "adamw" | "sgd"
    lr: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # "constant" | "cosine" | "multistep"
    # multistep schedule (torch MultiStepLR semantics): at each milestone
    # in lr_decay_steps (units of `steps`, i.e. micro-steps) the lr is
    # multiplied by lr_decay_rate; steps >= milestone run at the decayed
    # rate. Composes with warmup_steps (linear ramp to the current tier).
    lr_decay_steps: Tuple[int, ...] = ()
    lr_decay_rate: float = 0.1
    grad_clip: float = 0.0         # 0 = off
    # accumulate gradients over N micro-batches before each update
    # (effective batch = N * data.batch_size; optax.MultiSteps)
    grad_accum: int = 1
    # apply the optimizer to one flattened parameter vector (optax.flatten)
    # instead of per-leaf: identical math for elementwise transforms,
    # fewer+bigger kernels (see docs/DESIGN.md roofline tail)
    flat_optimizer: bool = False
    # run N optimizer steps per jitted dispatch (lax.scan inside the step;
    # engine/train_step.make_train_step unroll). Identical per-step
    # numerics; amortizes host/runtime dispatch overhead. log/eval/ckpt
    # cadences and `steps` must be multiples of N (validated in fit()).
    steps_per_call: int = 1
    # XLA compile options applied to the jitted train step (string->string;
    # e.g. the measured v5e winner xla_tpu_scoped_vmem_limit_kib=32768 from
    # scripts/flag_sweep.py). Options prefixed xla_tpu_ are dropped on
    # non-TPU backends (the CPU test backend rejects unknown options) --
    # engine/train_step.filter_compiler_options.
    compiler_opts: Dict[str, str] = field(default_factory=dict)
    # loss weighting: L = pos_weight * pos_loss + rot_weight * quat_loss
    pos_weight: float = 1.0
    rot_weight: float = 1.0
    # position loss: "mse" (torch nn.MSELoss, reference parity) | "huber"
    # (torch nn.HuberLoss semantics: 0.5*e^2 within huber_delta, linear
    # beyond -- caps the gradient of demo outliers / mislabeled frames).
    # Note the torch conventions differ by the 0.5 inside the quadratic
    # zone: huber(delta=inf) == 0.5 * mse.
    pos_loss: str = "mse"
    # huber elbow in METERS. Set it between your model's typical (inlier)
    # position error and the outlier distance -- a generous inlier error
    # bound. Too small puts inliers in the linear zone: an L1-like loss
    # whose capped gradients train measurably slower (docs/DESIGN.md
    # "Huber position loss" -- delta=0.05 lost to MSE where residuals
    # were ~0.13 m; delta=0.15 recovered ~40% of a 20%-mislabeled
    # corruption penalty).
    huber_delta: float = 0.05
    rot_loss: str = "chordal"      # "chordal" (1-<q,q'>^2) | "geodesic"
    seed: int = 0
    # exponential moving average of the float32 parameters, updated inside
    # the jitted step (ema = d*ema + (1-d)*params; initialized to the
    # initial params, so no bias correction is needed). 0 = off. When on,
    # EVERY evaluation consumer -- periodic eval during fit(), evaluate(),
    # Predictor, StableHLO export -- uses the EMA weights
    # (TrainState.eval_variables); training gradients always flow through
    # the raw params. Costs one extra f32 param copy in HBM.
    ema_decay: float = 0.0
    # re-estimate BatchNorm running statistics for the serving (EMA)
    # weights by pushing N train-pipeline batches through train-mode
    # forwards -- the torch swa_utils.update_bn recipe. Runs before each
    # periodic eval / best-checkpoint save and before the final save
    # (recalibrated stats ship in those checkpoints; the cadence
    # checkpoints keep the raw training stats so resume is unaffected).
    # 0 = off. Without it, BN running stats track the RAW weights'
    # activations -- serving EMA params with them is a train/serve
    # mismatch measured to dominate the EMA win under constant LR
    # (docs/DESIGN.md EMA rows). No-op for BN-free models (vit, "none").
    ema_bn_recal_batches: int = 0
    # include the global gradient norm in train metrics. Off by default:
    # it costs a per-leaf reduction fan-in every step (~0.3 ms/step on
    # v5e at pr3 scale) and the reference logged nothing comparable.
    log_grad_norm: bool = False
    log_every: int = 50
    eval_every: int = 500
    eval_steps: int = 16           # batches per eval pass
    # stop training when the early-stop metric (train.ckpt_best_metric if
    # set, else eval "loss") fails to improve by more than
    # early_stop_min_delta for this many CONSECUTIVE evaluations. 0 = off.
    # Requires eval_every > 0 (validated in fit()). The final checkpoint is
    # written at the stop step; metrics carry "early_stopped_at". Patience
    # state is in-run only: a resumed run starts its patience fresh.
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    ckpt_every: int = 500
    ckpt_dir: str = "/tmp/rppe_ckpt"
    ckpt_keep: int = 3
    # additionally keep the checkpoint with the best (lowest) value of this
    # eval metric, e.g. "pos_mae_cm" or "loss". "" = off.
    ckpt_best_metric: str = ""
    resume: str = "auto"           # "auto" | "none" | explicit step
    # warm start (the pretrain->finetune recipe; torch: load_state_dict()
    # then train): initialize params + BN/obs stats from another run's
    # checkpoint directory (its SERVING weights -- the EMA average when the
    # source trained with ema_decay; pass ".../ckpt" for the latest step or
    # ".../ckpt/best" for the best-metric checkpoint) while the optimizer,
    # step counter, LR schedule, and data order start fresh. Model shapes
    # must match. Ignored when ckpt_dir already holds a checkpoint: a
    # preempted run resumes its own state rather than re-applying the init.
    init_from: str = ""
    # pretrained-backbone init (the reference's torchvision
    # `pretrained=True` workflow, SURVEY.md section 1.3): path to a
    # torchvision-style backbone state_dict -- ".npz" (numpy archive of
    # the state_dict keys; torch-free) or a torch-pickled ".pt"/".pth"
    # (needs torch on the host, lazily imported). The weights initialize
    # EVERY camera encoder (utils/torch_import mapping for
    # resnet18/34/50 and vit with vit_pool="cls"); head/proprio/fusion
    # params start fresh. Composes with freeze_backbone. Mutually
    # exclusive with init_from; like init_from, ignored once ckpt_dir
    # holds a checkpoint (a preempted run resumes its own state).
    init_from_torch: str = ""
    # graceful-preemption handling: when the process receives SIGTERM (the
    # signal cloud schedulers send before reclaiming a preemptible TPU VM,
    # typically with a ~30 s grace window), finish the in-flight step, save
    # a checkpoint at that exact step, and return cleanly with
    # metrics["preempted_at"]; train.resume="auto" then continues from it.
    # SIGINT (Ctrl-C) is deliberately NOT caught so a hung run can still be
    # aborted. Only installed when fit() runs on the main thread (Python
    # restricts signal handlers to it); the previous handler is restored
    # on exit.
    save_on_signal: bool = True
    # persistent XLA compilation cache directory ("" = off): compiled train/
    # eval steps are reused across process restarts -- a preempted-and-
    # resumed run (save_on_signal above) skips the 20-40 s TPU recompile.
    # Backed by jax_compilation_cache_dir; shared across runs and safe to
    # point at one machine-wide directory.
    compile_cache_dir: str = ""
    metrics_path: str = ""         # JSONL metrics file ("" = ckpt_dir/metrics.jsonl)
    tensorboard: bool = False
    debug_nans: bool = False       # jax_debug_nans mode (SURVEY.md section 6.2)
    # capture a jax.profiler trace window (SURVEY.md section 6.1); view with
    # tensorboard-plugin-profile. "" = off.
    profile_dir: str = ""
    profile_start: int = 10        # first profiled step
    profile_steps: int = 5         # trace window length

    def __post_init__(self):
        _check_enum("train.optimizer", self.optimizer,
                    ("adam", "adamw", "sgd"))
        _check_enum("train.lr_schedule", self.lr_schedule,
                    ("constant", "cosine", "multistep"))
        _check_enum("train.rot_loss", self.rot_loss,
                    ("chordal", "geodesic"))
        _check_enum("train.pos_loss", self.pos_loss, ("mse", "huber"))
        if self.huber_delta <= 0:
            raise ValueError(
                f"train.huber_delta must be > 0, got {self.huber_delta}")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError(
                f"train.ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.lr_schedule == "multistep":
            ms = tuple(self.lr_decay_steps)
            if not ms or any(m <= 0 for m in ms) or list(ms) != sorted(ms):
                raise ValueError(
                    "train.lr_schedule='multistep' needs "
                    "train.lr_decay_steps to be a non-empty increasing "
                    f"tuple of positive steps, got {self.lr_decay_steps}")
            if not (0.0 < self.lr_decay_rate <= 1.0):
                raise ValueError(
                    f"train.lr_decay_rate must be in (0, 1], got "
                    f"{self.lr_decay_rate}")
        if self.ema_bn_recal_batches < 0:
            raise ValueError(
                f"train.ema_bn_recal_batches must be >= 0, got "
                f"{self.ema_bn_recal_batches}")
        if self.early_stop_patience < 0 or self.early_stop_min_delta < 0:
            raise ValueError(
                "train.early_stop_patience/early_stop_min_delta must be "
                f"non-negative, got {self.early_stop_patience}/"
                f"{self.early_stop_min_delta}")


@dataclass
class DistConfig:
    """Parallelism (C12; BASELINE.json:5,11). Pure DP over a 1-D mesh:
    batch sharded on 'data', params replicated, gradient psum compiled into
    the step by XLA over ICI (SURVEY.md section 3.2)."""

    num_devices: int = 0           # 0 = all visible devices
    data_axis: str = "data"
    # multi-host: call jax.distributed.initialize before mesh construction
    multihost: bool = False
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    name: str = "custom"

    # ---- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(dc_cls, sub):
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {dc_cls.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return dc_cls(**kwargs)

        unknown = set(d) - {"model", "data", "train", "dist", "name"}
        if unknown:
            raise KeyError(f"unknown config sections {sorted(unknown)}; "
                           "expected model/data/train/dist/name")
        return cls(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            dist=build(DistConfig, d.get("dist", {})),
            name=d.get("name", "custom"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def override(self, **dotted: Any) -> "Config":
        """Apply dotted-path overrides, e.g. cfg.override(**{"train.lr": 3e-4}).

        A str value for a tuple-valued field is split on commas (elements
        JSON-decoded where possible), so `--set model.cameras=agentview,
        robot0_eye_in_hand` and `--set model.head_hidden=512,256` work
        without JSON-list quoting -- cli._parse_value cannot do this
        itself because bare words aren't valid JSON and NON-tuple fields
        (data.path globs, data.proprio_key) legitimately contain commas."""
        d = self.to_dict()
        for path, value in dotted.items():
            parts = path.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key {path}")
            if isinstance(value, str) and isinstance(node[parts[-1]], tuple):
                def _elem(s: str) -> Any:
                    try:
                        return json.loads(s)
                    except json.JSONDecodeError:
                        return s
                value = tuple(_elem(p.strip())
                              for p in value.split(",") if p.strip())
            node[parts[-1]] = value
        return Config.from_dict(d)


# ---------------------------------------------------------------------------
# The five staged presets (BASELINE.json:7-11) -- the acceptance ladder.
#
# pr3/pr4/pr5 ship the TUNED production knobs the tracked benchmark
# measures (VERDICT r2 weak-3: the bench must measure a config the product
# ships): steps_per_call=8 (bitwise-equivalent unrolled dispatch,
# tests/test_train_smoke.py), stem_s2d (bit-equivalent space-to-depth
# ResNet stem, tests/test_fused_bn.py), and the scoped-vmem compile option
# (+3%, scripts/flag_sweep.py; dropped automatically off-TPU). Cadences in
# those presets are multiples of steps_per_call (fit() validates).
# ---------------------------------------------------------------------------

# the one winner from the 13-option XLA flag sweep on v5e
# (scripts/flag_sweep.py; docs/DESIGN.md "Compiler options")
TUNED_COMPILER_OPTS = {"xla_tpu_scoped_vmem_limit_kib": "32768"}


def _pr1() -> Config:
    """Proprio-only MLP pose regressor on synthetic state vectors, batch 32,
    CPU-runnable (BASELINE.json:7)."""
    return Config(
        name="pr1_proprio_synthetic",
        model=ModelConfig(
            backbone="none", cameras=(), use_proprio=True,
            proprio_dim=32, proprio_hidden=(256, 256), proprio_features=128,
            head_hidden=(256, 128),
        ),
        data=DataConfig(source="synthetic", batch_size=32, augment=False,
                        num_workers=0),
        train=TrainConfig(steps=2000, lr=1e-3, eval_every=500, ckpt_every=1000),
    )


def _pr2() -> Config:
    """Small 4-layer CNN, RGB-only pose regression on 64x64 renders,
    batch 64 (BASELINE.json:8)."""
    return Config(
        name="pr2_cnn_small_64",
        model=ModelConfig(
            backbone="cnn_small", cameras=("agentview",), image_size=64,
            use_proprio=False, image_features=256, head_hidden=(256, 128),
        ),
        data=DataConfig(source="hdf5", batch_size=64, augment=True),
        train=TrainConfig(steps=5000, lr=1e-3),
    )


def _pr3() -> Config:
    """ResNet-18 RGB + proprio-MLP late-fusion on robosuite Lift demos,
    128x128 (BASELINE.json:9)."""
    return Config(
        name="pr3_resnet18_lift_128",
        model=ModelConfig(
            backbone="resnet18", cameras=("agentview",), image_size=128,
            use_proprio=True, image_features=512, proprio_features=128,
            stem_s2d=True,
            # robosuite robot0_proprio-state is mixed-unit (radians,
            # meters, rad/s); unnormalized it measured 102.77 cm MAE vs
            # 9.35 cm normalized (docs/DESIGN.md "Proprio normalization")
            proprio_normalize=True,
        ),
        data=DataConfig(source="hdf5", batch_size=128, augment=True),
        train=TrainConfig(steps=20000, lr=1e-4, optimizer="adamw",
                          weight_decay=1e-4, steps_per_call=8,
                          log_every=40, eval_every=1000, ckpt_every=1000,
                          compiler_opts=dict(TUNED_COMPILER_OPTS)),
    )


def _pr4() -> Config:
    """ResNet-50 fusion, full augmentation, 224x224, bf16 (BASELINE.json:10).

    The 224 rung is evidence-backed: the r5 resolution grid measured 224
    BETTER than 128 in every like-for-like pairing at 160-demo scale
    (~-0.9 cm pos / -5..-13 deg rot on the means; with seed replicas,
    every individual 224 run beat every individual 128 run on both
    metrics; docs/DESIGN.md "The resolution rung (r5)",
    docs/artifacts/res_grid_r5.json). The r4
    readout that 224 "lost ~4 cm to 128" compared an image-only f32@128
    row against this preset's proprio+bf16 configuration -- the gap was
    the uninformative-proprio fusion branch (~4.2 cm at that data scale)
    plus ~0.6 cm of bf16, not resolution. Caveats that DO bind at demo
    scale: ResNet-50 ties ResNet-18 at 224 (capacity is not the
    constraint), and an uninformative proprio stream costs real accuracy
    (model.proprio_dropout / model.use_proprio=false are the knobs)."""
    return Config(
        name="pr4_resnet50_224_bf16",
        model=ModelConfig(
            backbone="resnet50", cameras=("agentview",), image_size=224,
            use_proprio=True, image_features=1024, dtype="bfloat16",
            stem_s2d=True,
            # same mixed-unit robot state as pr3 (102.77 cm unnormalized)
            proprio_normalize=True,
        ),
        data=DataConfig(source="hdf5", batch_size=256, augment=True,
                        num_workers=16),
        train=TrainConfig(steps=50000, lr=3e-4, optimizer="adamw",
                          weight_decay=1e-4, lr_schedule="cosine",
                          warmup_steps=1000, steps_per_call=8,
                          log_every=40, eval_every=1000, ckpt_every=1000,
                          compiler_opts=dict(TUNED_COMPILER_OPTS)),
    )


def _pr5() -> Config:
    """Dual-camera (wrist+agentview) two-encoder fusion with temporal
    stacking, data-parallel on v5e-8 (BASELINE.json:11)."""
    return Config(
        name="pr5_dualcam_temporal_dp8",
        model=ModelConfig(
            backbone="resnet18",
            cameras=("agentview", "robot0_eye_in_hand"),
            image_size=128, use_proprio=True, temporal_frames=3,
            # lstm beat channel-stacking on velocity-dependent labels
            # (11.52 vs 14.60 cm pos MAE) AND channel lost rot MAE to
            # single-frame (20.1 vs 17.4 deg) -- docs/DESIGN.md "Temporal"
            temporal_mode="lstm",
            # without modality dropout a dual-cam model collapses 9.35 ->
            # 33-37 cm when one sensor dies; 0.15 costs ~nothing with both
            # live (docs/DESIGN.md "Dead-camera serving")
            camera_dropout=0.15,
            # mixed-unit robot state: 102.77 cm unnormalized (see pr3)
            proprio_normalize=True,
            dtype="bfloat16", stem_s2d=True,
        ),
        data=DataConfig(source="hdf5", batch_size=1024, augment=True,
                        num_workers=32),
        train=TrainConfig(steps=50000, lr=3e-4, optimizer="adamw",
                          weight_decay=1e-4, lr_schedule="cosine",
                          warmup_steps=1000, steps_per_call=8,
                          log_every=40, eval_every=1000, ckpt_every=1000,
                          compiler_opts=dict(TUNED_COMPILER_OPTS)),
        dist=DistConfig(num_devices=8),
    )


def _pr5la() -> Config:
    """pr5 with PREDICTIVE pose targets: label[t] = pose at t+6
    (data.target_lookahead=6) -- "where will the object be when the
    gripper arrives", the robotically-motivated variant of the flagship
    config. K=6 puts the lookahead term (~18 cm / ~34 deg at the
    flagship scene's motion scale) well above the task's error floor,
    and every measured configuration learns real predictive structure
    (beats the carry-forward bound; docs/DESIGN.md "K=6 supplement").
    Measured caveats, same section: pick the temporal mode empirically
    -- at 240-demo scale channel-stack posted the best position and
    single-frame ties the LSTM whenever proprio or workspace geometry
    leaks target velocity -- and do not expect usable K=6 ROTATION
    prediction unless the spin rate is observable (it saturates to
    chance on the flagship scene). One-command reproduction of the K=6
    composition row: examples/predictive_pose.py."""
    return _pr5().override(**{
        "name": "pr5la_predictive_lookahead6",
        "data.target_lookahead": 6,
    })


PRESETS = {
    "pr1": _pr1,
    "pr2": _pr2,
    "pr3": _pr3,
    "pr4": _pr4,
    "pr5": _pr5,
    "pr5la": _pr5la,
}


def preset(name: str) -> Config:
    """Return one of the five staged acceptance configs (BASELINE.json:7-11)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()

"""A copy of the JAX package's ``utils/viz.py`` (jax-free), for the
port's CLI: ``predict --plot``, ``inspect --sample`` and ``curves``.

Trajectory visualization for `cli predict --plot` (the reference's
test_model.py-style qualitative check, SURVEY.md section 1.3: research
repos judge pose estimators by predicted-vs-ground-truth traces, not only
aggregate MAE).

Renders one PNG per demo: predicted vs target x/y/z position traces over
the trajectory plus per-step position/rotation error panels. matplotlib
is imported lazily with the Agg backend so the package never requires a
display (and never pays the import unless plotting is requested).
"""

from __future__ import annotations

import numpy as np

# prediction = categorical series 1; ground truth = neutral ink, dashed
# (identity is carried by linestyle too, so the pair survives CVD/print)
_PRED = "#2a78d6"
_TARGET = "#52514e"
_GRID = "#d9d8d4"


def plot_trajectory(pred_pos: np.ndarray, target_pos: np.ndarray,
                    pos_err_cm: np.ndarray, rot_err_deg: np.ndarray,
                    path: str, title: str = "") -> str:
    """Write a predicted-vs-target trajectory figure to `path`.

    pred_pos/target_pos: (T, 3) meters; pos_err_cm/rot_err_deg: (T,).
    Returns `path`.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred_pos = np.asarray(pred_pos, np.float32)
    target_pos = np.asarray(target_pos, np.float32)
    t = np.arange(pred_pos.shape[0])

    fig, axes = plt.subplots(5, 1, figsize=(8, 10), sharex=True,
                             constrained_layout=True)
    fig.set_facecolor("#fcfcfb")
    for ax in axes:
        ax.set_facecolor("#fcfcfb")
        ax.grid(True, color=_GRID, linewidth=0.6)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)

    for i, name in enumerate("xyz"):
        ax = axes[i]
        ax.plot(t, target_pos[:, i], color=_TARGET, linestyle="--",
                linewidth=1.4, label="ground truth")
        ax.plot(t, pred_pos[:, i], color=_PRED, linewidth=2.0,
                label="predicted")
        ax.set_ylabel(f"{name} (m)")
    axes[0].legend(loc="upper right", frameon=False, fontsize=9)

    axes[3].plot(t, np.asarray(pos_err_cm, np.float32), color=_PRED,
                 linewidth=2.0)
    axes[3].set_ylabel("pos err (cm)")
    axes[3].set_ylim(bottom=0)
    axes[4].plot(t, np.asarray(rot_err_deg, np.float32), color=_PRED,
                 linewidth=2.0)
    axes[4].set_ylabel("rot err (deg)")
    axes[4].set_ylim(bottom=0)
    axes[4].set_xlabel("trajectory step")
    axes[4].xaxis.set_major_locator(
        matplotlib.ticker.MaxNLocator(integer=True))
    if title:
        axes[0].set_title(title, fontsize=11, loc="left")

    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_sample_grid(cfg, path: str) -> dict:
    """Write a decoded sample-frame grid (rows = cameras, cols = first
    frame of up to 4 demos) through the SAME eval decode/resize path the
    model trains on. The two classic silent data bugs this catches before
    a wasted training run: a wrong `data.image_key_format`/camera name
    (black or mismatched frames) and BGR-stored images (skin/table colors
    inverted). Returns a small summary dict for the inspect report."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        build_dataset,
    )

    cameras = list(cfg.model.cameras)
    if cfg.model.backbone == "none" or not cameras:
        raise ValueError("inspect --sample needs image input "
                         "(model.cameras non-empty, model.backbone set)")
    dataset = build_dataset(cfg, split="all")
    if hasattr(dataset, "emit_image_indices"):
        dataset.emit_image_indices = False   # want pixels, not cache ids

    # first step of each of the first <=4 demos (hdf5); else first samples
    if hasattr(dataset, "_index"):
        starts = [int(np.nonzero(dataset._index[:, 0] == d)[0][0])
                  for d in np.unique(dataset._index[:, 0])[:4]]
        names = [dataset._demo_keys[int(dataset._index[i, 0])]
                 for i in starts]
    else:
        starts = list(range(min(4, len(dataset))))
        names = [f"sample {i}" for i in starts]
    batch = dataset.get_batch(np.asarray(starts), augment=False, seed=0)

    rows, cols = len(cameras), len(starts)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False, constrained_layout=True)
    for r, cam in enumerate(cameras):
        frames = np.asarray(batch["images"][cam])
        if frames.ndim == 5:       # temporal (B, T, H, W, 3): latest frame
            frames = frames[:, -1]
        for c in range(cols):
            ax = axes[r][c]
            ax.imshow(frames[c])
            ax.set_xticks([]), ax.set_yticks([])
            if r == 0:
                ax.set_title(names[c], fontsize=9)
            if c == 0:
                ax.set_ylabel(cam, fontsize=9)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return {"path": path, "cameras": cameras, "frames": names,
            "decoded_hw": int(frames.shape[1])}


# fixed categorical assignment for the metrics curves: the train series
# is always slot 1 (blue), the eval series always slot 2 (orange) --
# identity follows the entity, never panel-local order
_EVAL = "#eb6834"


def plot_metrics(jsonl_path: str, path: str, title: str = "") -> dict:
    """Render training curves from a metrics JSONL (utils/metrics.py
    format: records keyed `step` + `train/...` or `eval/...` scalars) --
    the loss/MAE/throughput view a research user reads after every run.

    Panels (only those with data are drawn): loss (train+eval),
    eval pos MAE cm, eval rot MAE deg, images/sec/chip, learning rate,
    host queue depth. Returns {path, steps, panels}."""
    import json as _json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series: dict = {}
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = _json.loads(line)
            step = rec.get("step")
            if step is None:
                continue
            for k, v in rec.items():
                if k in ("step", "ts") or not isinstance(v, (int, float)):
                    continue
                series.setdefault(k, []).append((step, float(v)))

    def get(key):
        pts = series.get(key)
        if not pts:
            return None
        pts = sorted(pts)
        return (np.array([p[0] for p in pts]),
                np.array([p[1] for p in pts]))

    # panel spec: (title, ylabel, [(key, label, color)], log_y)
    spec = [
        ("loss", "loss", [("train/loss", "train", _PRED),
                          ("eval/loss", "eval", _EVAL)], True),
        ("position MAE", "cm", [("eval/pos_mae_cm", "eval", _EVAL)], False),
        ("rotation MAE", "deg", [("eval/rot_mae_deg", "eval", _EVAL)], False),
        ("throughput", "images/sec/chip",
         [("train/images_per_sec_per_chip", "train", _PRED)], False),
        ("learning rate", "lr", [("train/lr", "train", _PRED)], False),
        ("host queue depth", "batches",
         [("train/host_queue_depth", "train", _PRED)], False),
    ]
    panels = []
    for t, yl, sp, lg in spec:
        lines = [(pts, lab, c) for k, lab, c in sp
                 if (pts := get(k)) is not None]
        if lines:
            panels.append((t, yl, lines, lg))
    if not panels:
        raise ValueError(f"no plottable metrics in {jsonl_path}")

    ncol = 2 if len(panels) > 1 else 1
    nrow = (len(panels) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(5.5 * ncol, 3.2 * nrow),
                             squeeze=False, constrained_layout=True)
    fig.set_facecolor("#fcfcfb")
    flat = [ax for row in axes for ax in row]
    for ax in flat[len(panels):]:
        ax.set_visible(False)
    max_step = 0
    for ax, (ptitle, ylabel, lines, log_y) in zip(flat, panels):
        ax.set_facecolor("#fcfcfb")
        ax.grid(True, color=_GRID, linewidth=0.6)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for (xs, ys), lab, color in lines:
            ax.plot(xs, ys, color=color, linewidth=2.0, label=lab)
            max_step = max(max_step, int(xs.max()))
        if log_y and all((ys > 0).all() for (_, ys), _, _ in lines):
            ax.set_yscale("log")
        ax.set_title(ptitle, fontsize=10, loc="left")
        ax.set_ylabel(ylabel)
        ax.set_xlabel("step")
        if len(lines) > 1:
            ax.legend(loc="upper right", frameon=False, fontsize=9)
    if title:
        fig.suptitle(title, fontsize=11)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return {"path": path, "steps": max_step,
            "panels": [p[0] for p in panels]}

"""Structured observability (SURVEY.md section 6.5).

JSONL metrics stream (step, loss components, MAE, images/sec/chip,
host-queue depth -- the canary for "TPU stalling on input") plus an
optional tensorboard writer. Replaces the reference's prints/tensorboard
(`[RECALL]` SURVEY.md section 2 L7).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, path: str = "", tensorboard: bool = False,
                 tb_dir: str = ""):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tb_dir or os.path.dirname(path) or ".")
            except Exception:  # tensorboard is best-effort observability
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {"ts": time.time(), "step": int(step)}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                # non-scalar (arrays etc.): stringify so the JSONL write
                # can't crash the training loop
                rec[key] = v if isinstance(v, (str, bool, type(None))) else str(v)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("ts", "step"):
                    continue
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None



"""A profiler trace window over training steps (counterpart of the JAX
package's ``utils/prof.py``): with ``train.profile_dir`` set, a
``torch.profiler`` trace of the ``profile_steps`` steps from
``profile_start`` is written to ``<profile_dir>/trace_rank<r>.json``
(Chrome trace format: chrome://tracing or Perfetto), the card's activity
included when the model is on one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class TraceWindow:
    """Start and stop a ``torch.profiler`` trace over a step interval."""

    def __init__(self, trace_dir: str, start_step: int, num_steps: int,
                 device: torch.device, rank: int = 0):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.device = torch.device(device)
        self.path = os.path.join(trace_dir, f"trace_rank{rank}.json")
        self._prof: Optional[torch.profiler.profile] = None
        self._done = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_step(self, step: int) -> None:
        """Call once per step, 1-based, after the step is queued."""
        if not self.trace_dir or self._done:
            return
        if self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        """Stop a running trace (its steps whole) and write it."""
        if self._prof is None:
            return
        self._sync()
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True

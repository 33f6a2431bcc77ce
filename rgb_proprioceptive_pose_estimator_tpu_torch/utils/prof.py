"""The port's tracing: named spans inside the train step and the feed, and
a profiler trace window over training steps (counterpart of the JAX
package's ``utils/prof.py``).

Spans. ``span(name, device=..., step=...)`` is a context manager placed
where the work happens (``engine/train_step``, ``data/pipeline``). It
records while a ``torch.profiler`` trace runs on the calling thread (the
trace window's below, or any other), and costs one check of that
otherwise: it then returns one shared no-op object, reads no clock,
records no CUDA event and opens no ``record_function``. A recorded span
keeps its name, its parent (the span open on the same thread when it
opened), a step id and its host start and end from ``time.time_ns()``,
the clock ``torch.profiler``'s timestamps use; it opens
``torch.profiler.record_function(name)``, so the trace shows the phase
(as a user annotation: a reader of the trace's device time leaves those
out). Given a CUDA ``device`` it records a timing event on the device's
current stream at entry and at exit, and its device time is the time
between the two (on the CPU, its host duration). Spans open only on the
thread that runs the step.

Step ids: a span given no ``step`` takes its parent's; a span outside
any step (the feed's, fetching the batch of the step that follows) takes
the id of the next span opened with one.

``drain()`` synchronises once, resolves the events and returns the
records (with the counters set on them by ``count``), keeping nothing.
The records stay in memory until then, the newest ``MAX_SPANS`` of them.

Trace window: with ``train.profile_dir`` set, a ``torch.profiler`` trace
of the ``profile_steps`` steps from ``profile_start`` is written to
``<profile_dir>/trace_rank<r>.json`` (Chrome trace format: chrome://tracing
or Perfetto), the card's activity included when the model is on one, and
the spans of those steps to ``<profile_dir>/spans_rank<r>.json``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional

import torch

STEP = "rppe.step"                  # the span around a whole train step
MAX_SPANS = 1 << 16                 # records kept between two drains


class _NullSpan:
    """What ``span`` returns while nothing records: does nothing."""

    active = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, name: str, value: float) -> None:
        pass


NULL_SPAN = _NullSpan()


_spans: Deque["_Span"] = collections.deque()    # since the last drain
_local = threading.local()          # each thread's stack of open spans


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One recorded span."""

    active = True
    __slots__ = ("name", "device", "step", "parent", "counters", "start_ns",
                 "end_ns", "stream", "events", "_fn")

    def __init__(self, name: str, device, step: Optional[int]):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.step = step
        self.parent: Optional[_Span] = None
        self.counters: Dict[str, float] = {}
        self.end_ns: Optional[int] = None
        self.events = None

    def __enter__(self) -> "_Span":
        self.start_ns = time.time_ns()
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            if self.step is None:
                self.step = self.parent.step
        stack.append(self)
        _spans.append(self)
        if len(_spans) > MAX_SPANS:
            _spans.popleft()
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(self.stream)
        self._fn.__exit__(*exc)
        _stack().pop()
        self.end_ns = time.time_ns()
        return False

    def count(self, name: str, value: float) -> None:
        """Attach counter ``name`` = ``value`` to the span."""
        self.counters[name] = float(value)


def span(name: str, *, device=None, step: Optional[int] = None):
    """A span named ``name`` (device time on ``device`` when it is a CUDA
    device, step id ``step``) while a profiler trace runs on this thread,
    else ``NULL_SPAN``."""
    if not torch.autograd._profiler_enabled():
        return NULL_SPAN
    return _Span(name, device, step)


def _resolve_steps(spans: List[_Span]) -> None:
    """Give the spans opened outside any step (step still None) the step
    id of the next span opened with one, unless they enclose it."""
    pending: List[_Span] = []
    for s in spans:
        if s.step is None:
            pending.append(s)
            continue
        if pending:
            outer = set()
            p = s.parent
            while p is not None:
                outer.add(id(p))
                p = p.parent
            for q in pending:
                if id(q) not in outer:
                    q.step = s.step
            pending = [q for q in pending if id(q) in outer]


def drain() -> List[Dict]:
    """The spans closed since the last call, in the order they opened:
    ``id``, ``name``, ``parent`` (its id, or None), ``step``, host
    ``start_ns`` and ``end_ns``, ``host_ms``, ``device_ms`` (None for a
    span given no device) and ``counters``. Synchronises each CUDA device
    the spans timed once. Spans still open stay for the next call."""
    global _spans
    spans = [s for s in _spans if s.end_ns is not None]
    _spans = collections.deque(s for s in _spans if s.end_ns is None)
    for dev in {s.device for s in spans if s.events is not None}:
        torch.cuda.synchronize(dev)
    _resolve_steps(spans)
    ids = {id(s): i for i, s in enumerate(spans)}
    out = []
    for i, s in enumerate(spans):
        host_ms = (s.end_ns - s.start_ns) * 1e-6
        if s.events is not None:
            device_ms = s.events[0].elapsed_time(s.events[1])
        else:
            device_ms = host_ms if s.device is not None else None
        out.append({"id": i, "name": s.name,
                    "parent": ids.get(id(s.parent)), "step": s.step,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "host_ms": host_ms, "device_ms": device_ms,
                    "counters": dict(s.counters)})
    return out


def summary(records: List[Dict], per_step: bool = False
            ) -> Dict[str, float]:
    """Per span name: ``<name>.calls`` and the mean ``<name>.host_ms``,
    ``<name>.device_ms`` (for spans with a device) and, for each counter,
    ``<name>.<counter>``: the calls in all and the means per call, or
    with ``per_step`` each summed over a step of a ``rppe.step`` span and
    averaged over those steps (the records of other steps left out)."""
    if per_step:
        steps = {r["step"] for r in records if r["name"] == STEP}
        records = [r for r in records if r["step"] in steps]
    sums: Dict[str, Dict[str, float]] = {}
    for r in records:
        s = sums.setdefault(r["name"], {"calls": 0})
        s["calls"] += 1
        values = dict(r["counters"], host_ms=r["host_ms"])
        if r["device_ms"] is not None:
            values["device_ms"] = r["device_ms"]
        for k, v in values.items():
            s[k] = s.get(k, 0.0) + v
    out: Dict[str, float] = {}
    for name, s in sums.items():
        calls = s.pop("calls")
        n = len(steps) if per_step else calls
        out[f"{name}.calls"] = calls / n if per_step else float(calls)
        for k, v in s.items():
            out[f"{name}.{k}"] = v / n
    return out


class TraceWindow:
    """Start and stop a ``torch.profiler`` trace over a step interval; the
    spans recorded meanwhile are written beside it."""

    def __init__(self, trace_dir: str, start_step: int, num_steps: int,
                 device: torch.device, rank: int = 0):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.device = torch.device(device)
        self.path = os.path.join(trace_dir, f"trace_rank{rank}.json")
        self.spans_path = os.path.join(trace_dir, f"spans_rank{rank}.json")
        self.rank = rank
        self._prof: Optional[torch.profiler.profile] = None
        self._done = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_step(self, step: int) -> Optional[Dict[str, float]]:
        """Call once per step, 1-based, after the step is queued. Returns
        the spans' ``summary`` at the step that closes the window."""
        if not self.trace_dir or self._done:
            return None
        if self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            drain()     # spans of an earlier trace are not this window's
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_step:
            return self.close()
        return None

    def close(self) -> Optional[Dict[str, float]]:
        """Stop a running trace (its steps whole), write it and the spans;
        returns the spans' ``summary`` (None when no trace ran)."""
        if self._prof is None:
            return None
        self._sync()
        self._prof.stop()
        records = drain()
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        with open(self.spans_path, "w") as f:
            json.dump({"rank": self.rank, "spans": records}, f)
        self._prof = None
        self._done = True
        return summary(records)

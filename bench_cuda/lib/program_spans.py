"""The program's own spans over the traced steps, reduced to per-step
means for the per-layer readers.

The port records its spans (``utils/prof.span``: ``rppe.step`` and its
phases in ``engine/train_step``, ``rppe.feed`` and its parts in
``data/pipeline.HostPipeline``) while a ``torch.profiler`` trace runs, so
the traced steps of ``lib/trace.profile`` leave them in the program's
recorder. The first reader to ask drains them (``utils/prof.drain``),
reduces them per step (``utils/prof.summary``) and keeps the reduction in
the readers' shared context, where the others find it. A program without
spans (no ``drain`` in its ``utils/prof``), or a run whose ranks are
other processes, leaves nothing, and each reader returns None.

They are read only beside a device trace (a CPU run has none), so that no
CPU number is reported under the name of a device metric.
"""

from __future__ import annotations

from typing import Dict, Optional


def _summary() -> Dict[str, float]:
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils import prof

    if not hasattr(prof, "drain"):
        return {}
    return prof.summary(prof.drain(), per_step=True)


def read(ctx: Dict, name: str, key: str) -> Optional[float]:
    """``key`` (``device_ms`` or ``host_ms``) of span ``name`` per traced
    step, or None. The spans are drained once per run, into ``ctx``."""
    if "program" not in ctx:
        ctx["program"] = _summary()
    if not ctx["trace"]:
        return None
    return ctx["program"].get(f"{name}.{key}")

"""Share of a step in which no kernel or copy runs on the device: one
minus the device's busy time per traced step (the union of its
operations, averaged over the ranks) over the mean step of the run's
untraced window. The profiler slows the launching host by some
milliseconds a step but leaves the device's work as it is, so this
reads the idle share of the untraced steps, where the traced window's
own (``device.busy_s`` and ``window_s``) adds the profiler's cost. It
reads a little below 0 where the device never idles and the traced
steps' busy time runs over the window's mean step by noise."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["steps"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["steps"] / ctx["step_s"]

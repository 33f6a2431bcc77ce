"""Device time per traced step of the program's ``rppe.step.optimizer``
span: the update (``engine/train_step.Optimizer.step``: the clip, AdamW,
and the EMA's update where there is one), between CUDA events the
program records on the stream (``lib/program_spans``)."""

from bench_cuda.lib import program_spans


def read(ctx):
    return program_spans.read(ctx, "rppe.step.optimizer", "device_ms")

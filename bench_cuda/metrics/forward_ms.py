"""Device time per traced step of the program's ``rppe.step.forward``
span: the train-mode forward pass and the loss (``engine/train_step.
forward_backward``: ``model(batch)`` and ``pose_loss``), between CUDA
events the program records on the stream (``lib/program_spans``)."""

from bench_cuda.lib import program_spans


def read(ctx):
    return program_spans.read(ctx, "rppe.step.forward", "device_ms")

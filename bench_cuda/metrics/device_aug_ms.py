"""Device time per traced step of the program's ``rppe.step.prepare``
span: the batch made ready on the card (``engine/train_step.
prepare_batch``: the frames gathered from the device cache, the
augmentation's draws, then crop, flip and colour jitter), between CUDA
events the program records on the stream (``lib/program_spans``)."""

from bench_cuda.lib import program_spans


def read(ctx):
    return program_spans.read(ctx, "rppe.step.prepare", "device_ms")

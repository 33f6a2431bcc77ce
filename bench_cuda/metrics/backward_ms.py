"""Device time per traced step of the program's ``rppe.step.backward``
span: ``loss.backward()`` (with DDP's all-reduce on a rank of a group),
between CUDA events the program records on the stream
(``lib/program_spans``)."""

from bench_cuda.lib import program_spans


def read(ctx):
    return program_spans.read(ctx, "rppe.step.backward", "device_ms")

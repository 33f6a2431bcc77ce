"""Host time per traced step of the program's ``rppe.feed.wait`` span:
the host blocked on a worker's batch in ``data/pipeline.HostPipeline``
(the future's result), apart from pinning and queueing the copy to the
card (``rppe.feed.h2d``), which ``data_wait_ms``'s benchmark span around
the whole ``__next__`` counts too (``lib/program_spans``)."""

from bench_cuda.lib import program_spans


def read(ctx):
    return program_spans.read(ctx, "rppe.feed.wait", "host_ms")

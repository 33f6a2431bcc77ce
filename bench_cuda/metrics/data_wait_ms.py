"""Host time per step blocked in the feed's ``__next__`` (the trainer
layer: ``data/pipeline.HostPipeline`` and, on the device-cache route,
the index batches it sends), over the traced run's window; a benchmark
span around the program's call."""


def read(ctx):
    return ctx["data_wait_ms"]

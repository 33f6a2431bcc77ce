"""Device time per step of cuDNN's convolution kernels (the encoder's
convolutions, forward and backward), per rank."""

from bench_cuda.lib.trace import CONV_GROUP


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    ms = t["groups"].get(CONV_GROUP, 0.0) / t["steps"] * 1e3
    return ms if ms > 0 else None

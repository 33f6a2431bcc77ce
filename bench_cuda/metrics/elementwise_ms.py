"""Device time per step of the kernels outside cuDNN's convolutions,
the matrix products, NCCL, copies, the optimizer's and the hand-written
kernels (the model and encoder layer's plain-torch elementwise and
reduction work), per rank."""

from bench_cuda.lib.trace import OTHER_GROUP


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    return t["groups"].get(OTHER_GROUP, 0.0) / t["steps"] * 1e3

"""Model-FLOP utilisation of the training step, in percent: the
configuration's frozen operations per sample (``counts/model_counts``:
three forward passes of convolutions and matrix products) times the
samples per second of the run's window, over the cards' published dense
bfloat16 peak (989 TFLOP/s each)."""

from bench_cuda.counts import model_counts as counts


def read(ctx):
    flops = counts.train_flops_per_sample(ctx["model"])
    peak = counts.PEAK_BF16_FLOPS * ctx["chips"]
    return 100.0 * flops * ctx["samples_per_s"] / peak

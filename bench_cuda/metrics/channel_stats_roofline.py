"""Share of its roofline, in percent, that the hand-written
``channel_stats`` kernel of ``ops/fused`` (over ``csrc/fused.cu``)
reaches in a step where it takes the BatchNorm statistics: the least
time its sites' work needs (``counts/model_counts.
channel_stats_bytes_per_step``, each input read and each output written
once, at the card's 3.35 TB/s) over the device time of its kernels;
nothing where none ran."""

from bench_cuda.counts import model_counts as counts


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    took = t["groups"].get("channel_stats", 0.0) / t["steps"]
    if took <= 0:
        return None
    need = counts.channel_stats_bytes_per_step(ctx["model"],
                                               ctx["rows_per_rank"])
    return 100.0 * need / counts.PEAK_HBM_BYTES / took

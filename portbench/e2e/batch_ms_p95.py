"""batch_ms_p95: 95th percentile, over every batch of the window, of the
time from the batch's dispatch until its keypoints and descriptors are
on the host."""

from portbench.lib.stats import p95


def read(ctx):
    return p95(ctx.latencies_s) * 1e3

"""Share of the untraced window in which the device idles, in %: 1 - (the
union of every kernel, copy and set in the CUPTI timeline of the same
steps run again under the profiler) / (the untraced window, first dispatch
to the last step's end). The device's work is read from the trace; the
time it is set against is the untraced run's, which the profiler's
per-launch cost on the host does not stretch."""


def read(ctx):
    if not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)

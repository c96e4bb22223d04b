"""Mean over the traced window's pairs of the benchmark's span around the
pair's match call: host clock from the call to a device sync after it."""


def read(ctx):
    return ctx.span_mean_ms("match")

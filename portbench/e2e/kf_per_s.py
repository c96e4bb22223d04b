"""kf_per_s: frames extracted with descriptors, over the whole window
(host clock)."""


def read(ctx):
    return ctx.steps * ctx.batch / ctx.window_s

"""pairs_per_s: image pairs extracted, matched and verified, over the
whole window (host clock)."""


def read(ctx):
    return ctx.steps / ctx.window_s

"""Host syncs inside one warm call of `extract_batch`, as torch reports
them under `set_sync_debug_mode("warn")`: an exact count."""


def read(ctx):
    return ctx.counters.get("syncs.extract")

"""Device activities a pair launched under the program's `extract` span
(kernels, copies and sets of the traced window, `lib/stages.py`), over
the traced steps: an exact count of extraction's dispatch work."""

from portbench.lib import stages


def read(ctx):
    sp = stages.of(ctx)
    return sp.under(sp.launches, "extract") if sp is not None else None

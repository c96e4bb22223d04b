"""Device ms a step of the per-keypoint stages: the CUPTI time of the
traced window's activities launched under the program's `refine`,
`orientation`, `descriptor` and `select` spans (`lib/stages.py`), over
the traced steps."""

from portbench.lib import stages


def read(ctx):
    sp = stages.of(ctx)
    return sp.leaf_ms(stages.KEYPOINT) if sp is not None else None

"""Device ms a step of the dense stages: the CUPTI time of the traced
window's activities launched under the program's `pyramid`, `extrema` and
`gradients` spans (`lib/stages.py`: the program's span boundaries are
marked on the stream), over the traced steps."""

from portbench.lib import stages


def read(ctx):
    sp = stages.of(ctx)
    return sp.leaf_ms(stages.DENSE) if sp is not None else None

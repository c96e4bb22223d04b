"""Host syncs a pair under the program's `ransac` span: the copies of the
traced window launched under it that the host waits for (device to host,
and host to device from pageable memory; `lib/stages.py`), over the traced
steps. Each is a value the host reads (an error code of a solver, a count)
or hands over; a sync that copies nothing is not seen."""

from portbench.lib import stages


def read(ctx):
    sp = stages.of(ctx)
    return sp.under(sp.syncs, "ransac") if sp is not None else None

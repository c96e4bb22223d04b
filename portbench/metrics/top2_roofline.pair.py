"""Share of its roofline of the top-2 search: the bound time of the best
and second distances between each pair's valid descriptors, every
product once (`lib/work.py::top2_work`; f32 rate, since the kernel runs
outside the tensor cores, and HBM peak) over the CUPTI time of the
kernels named, in %."""

from portbench.lib import work

KERNELS = ("top2_kernel", "merge_kernel")
PEAK_FLOPS = work.H100_F32_FLOPS
PEAK_BYTES_S = work.H100_HBM_BYTES_S


def read(ctx):
    secs, launches = ctx.kernel_seconds(KERNELS)
    if not launches or not ctx.step_stats:
        return None
    bound = sum(work.bound_s(*work.top2_work(s["valid_a"], s["valid_b"]),
                             PEAK_FLOPS, PEAK_BYTES_S)
                for s in ctx.step_stats)
    return 100.0 * bound / secs

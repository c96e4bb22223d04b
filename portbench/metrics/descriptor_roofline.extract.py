"""Share of its roofline of the descriptor pass: the bound time of the
descriptors the window's batches returned (`lib/work.py::descriptor_work`
over their distinct keypoints and valid orientations; f32 rate and HBM
peak) over the CUPTI time of the kernel named, in %."""

from portbench.lib import work

KERNELS = ("descriptor_kernel",)
PEAK_FLOPS = work.H100_F32_FLOPS
PEAK_BYTES_S = work.H100_HBM_BYTES_S


def read(ctx):
    secs, launches = ctx.kernel_seconds(KERNELS)
    if not launches or not ctx.step_stats:
        return None
    bound = sum(work.bound_s(*work.descriptor_work(s["windows"],
                                                   s["orientations"]),
                             PEAK_FLOPS, PEAK_BYTES_S)
                for s in ctx.step_stats)
    return 100.0 * bound / secs

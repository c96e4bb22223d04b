"""Share of its roofline of the Gaussian blur: the bound time of every
blur of the window's extractions (`lib/work.py::blur_work` from the
image size, the batch and the SiftConfig levels; the f32 rate and HBM
peak of `lib/work.py`) over the CUPTI time of the kernels named, in %."""

from portbench.lib import work

KERNELS = ("blur_fused_kernel", "blur_line_kernel")
PEAK_FLOPS = work.H100_F32_FLOPS
PEAK_BYTES_S = work.H100_HBM_BYTES_S


def read(ctx):
    secs, launches = ctx.kernel_seconds(KERNELS)
    if not launches:
        return None
    h, w = ctx.image
    nbytes, nops = work.blur_work(ctx.config["sift"], h, w, ctx.batch)
    bound = ctx.steps * work.bound_s(nbytes, nops, PEAK_FLOPS, PEAK_BYTES_S)
    return 100.0 * bound / secs

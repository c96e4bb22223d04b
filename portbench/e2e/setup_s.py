"""setup_s: seconds from the process's start to the first timed step
(imports, the CUDA context, the kernels' libraries, inputs from the seed,
the warm steps; in a checkout's first run also the kernels' build)."""


def read(ctx):
    return ctx.setup_s

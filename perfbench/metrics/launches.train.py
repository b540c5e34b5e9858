"""Device operations (kernels, copies, memsets) a step, from the profiler."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.stretch.ops / ctx.stretch.units

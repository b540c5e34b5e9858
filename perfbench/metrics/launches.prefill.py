"""Device operations (kernels, copies, memsets) a call, from the profiler."""


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return ctx.stretch.ops / ctx.stretch.units

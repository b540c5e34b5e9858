"""Share of the traced stretch with no operation on the device, in %."""


def read(ctx):
    if ctx.kind != "train":
        return None
    s = ctx.stretch
    return 100.0 * s.idle / s.window

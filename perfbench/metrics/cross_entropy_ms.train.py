"""Device ms a step of the kernels launched inside the program's
``train.cross_entropy`` range (the forward's loss; its backward runs on
autograd's thread, outside the range, and counts as the rest)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.stretch.family_ms("cross_entropy")

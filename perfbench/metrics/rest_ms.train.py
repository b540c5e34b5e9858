"""Device ms a step of every other device operation: not a product, not a
hand-written kernel, not inside the optimizer or cross-entropy ranges."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.stretch.family_ms("rest")

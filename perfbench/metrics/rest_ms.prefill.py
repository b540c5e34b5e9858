"""Device ms a call of every other device operation: not a product, not a
hand-written kernel, not inside the optimizer or cross-entropy ranges."""


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return ctx.stretch.family_ms("rest")

"""Device ms a step of the kernels launched inside the program's
``train.optimizer`` range (AdamW)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.stretch.family_ms("optimizer")

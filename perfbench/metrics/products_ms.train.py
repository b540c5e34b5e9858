"""Device ms a step of the cuBLAS and CUTLASS products (outside the
optimizer and cross-entropy ranges)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.stretch.family_ms("gemm")

"""Device ms a call of the cuBLAS and CUTLASS products (outside the
optimizer and cross-entropy ranges)."""


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return ctx.stretch.family_ms("gemm")

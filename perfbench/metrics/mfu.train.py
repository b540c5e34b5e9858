"""Model FLOPs of the traced steps over the stretch's time at the bf16
peak, in % (``counts.train_flops``)."""

from perfbench import counts


def read(ctx):
    if ctx.kind != "train":
        return None
    flops = sum(counts.train_flops(ctx.cfg, B, T) for B, T in ctx.units)
    return 100.0 * flops / (ctx.stretch.window * counts.PEAK["bf16"])

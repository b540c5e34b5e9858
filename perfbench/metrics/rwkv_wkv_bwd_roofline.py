"""rwkv_wkv_bwd's share of its roofline in training, in %: the bound of
every call of the traced steps (one an rwkv layer a microbatch,
``counts.wkv_bwd_bound_s``) over the device time of rwkv_wkv_bwd's
kernels."""

from perfbench import counts


def read(ctx):
    t = ctx.stretch.kernel_s("rwkv_wkv_bwd")
    if ctx.kind != "train" or ctx.cfg["reference"] != "rwkv6" or t <= 0:
        return None
    L, H, a = ctx.cfg["num_hidden_layers"], ctx.cfg["hidden_size"] // ctx.cfg["head_size"], ctx.accum
    return 100.0 * sum(L * a * counts.wkv_bwd_bound_s(B // a, T, H) for B, T in ctx.units) / t

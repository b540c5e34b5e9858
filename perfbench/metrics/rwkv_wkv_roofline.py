"""rwkv_wkv's share of its roofline in prefill, in %: the bound of
every call of the traced stretch (one an rwkv layer a prefill call,
``counts.wkv_bound_s``) over the device time of rwkv_wkv's kernel."""

from perfbench import counts


def read(ctx):
    t = ctx.stretch.kernel_s("rwkv_wkv")
    if ctx.kind != "prefill" or ctx.cfg["reference"] != "rwkv6" or t <= 0:
        return None
    L, H = ctx.cfg["num_hidden_layers"], ctx.cfg["hidden_size"] // ctx.cfg["head_size"]
    return 100.0 * sum(L * counts.wkv_bound_s(B, T, H) for B, T in ctx.units) / t

"""flash's share of its roofline in prefill, in %: the bound of every
call of the traced stretch (one an attention layer a prefill call,
``counts.flash_bound_s``) over the device time of flash's kernels."""

from perfbench import counts


def read(ctx):
    t = ctx.stretch.kernel_s("flash")
    L = counts.attention_layers(ctx.cfg)
    if ctx.kind != "prefill" or not L or t <= 0:
        return None
    c = ctx.cfg
    bound = sum(L * counts.flash_bound_s(B, T, c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"])
                for B, T in ctx.units)
    return 100.0 * bound / t

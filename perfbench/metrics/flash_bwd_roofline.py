"""flash_bwd's share of its roofline in training, in %: the bound of
every call of the traced steps (one an attention layer a microbatch,
``counts.flash_bwd_bound_s``) over the device time of flash_bwd's kernels."""

from perfbench import counts


def read(ctx):
    t = ctx.stretch.kernel_s("flash_bwd")
    L = counts.attention_layers(ctx.cfg)
    if ctx.kind != "train" or not L or t <= 0:
        return None
    c, a = ctx.cfg, ctx.accum
    bound = sum(L * a * counts.flash_bwd_bound_s(B // a, T, c["num_attention_heads"], c["num_key_value_heads"],
                                                 c["head_dim"]) for B, T in ctx.units)
    return 100.0 * bound / t

"""Each configuration and traffic mix cut to a size a CPU test holds, for
the harness's own tests: the same keys and layer kinds, small widths, short
rows, two layers (rwkv6 eight: its rounding grows layer by layer, and at
two layers the fp8 control stays inside the full model's limits).
``dtype`` "float32" runs the program in float32, where it agrees with the
reference to round-off."""

from __future__ import annotations

import copy


def config(cfg: dict, dtype: str = "float32") -> dict:
    c = copy.deepcopy(cfg)
    if c["reference"] == "decoder":
        c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_experts=4,
                 num_experts_per_tok=2, moe_intermediate_size=32, vocab_size=512, num_hidden_layers=2)
        c["port"].update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4, experts_per_token=2,
                         moe_d_ff=32, d_ff=32, vocab_size=512, num_layers=2)
    elif c["reference"] == "rwkv6":
        c.update(hidden_size=128, attention_hidden_size=128, intermediate_size=256, vocab_size=512,
                 num_hidden_layers=8)
        c["port"].update(d_model=128, num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=512, num_layers=8)
    else:
        raise ValueError(f"no small size for reference {c['reference']!r}")
    c["dtype"] = c["port"]["dtype"] = dtype
    return c


def traffic(tr: dict) -> dict:
    t = copy.deepcopy(tr)
    if t["kind"] == "train":
        t.update(seq_len=40, pool=4)
    else:
        t.update(shapes=[[2, 16], [2, 24], [1, 40]], pool_per_shape=2, cache_extra=8, sample_rows=2)
    return t

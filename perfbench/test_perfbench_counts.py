"""The yardstick's arithmetic pinned to values worked by hand (PERF.md,
"The yardstick's counts")."""

from __future__ import annotations

import pytest

from perfbench import counts, harness

BENCH = harness.load_benchmark()
QWEN = harness.config(BENCH, "qwen3-moe-235b-a22b.l1")
RWKV = harness.config(BENCH, "rwkv6-1.6b")


def test_peaks_are_the_data_sheets():
    assert counts.PEAK == {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12}


def test_parameters_a_token_touches_as_products():
    # qwen3: 2 x 4,096 x 8,192 (q, o) + 2 x 4,096 x 512 (k, v) + 4,096 x 128 (router)
    # + 8 x 3 x 4,096 x 1,536 (the routed experts); head 4,096 x 151,936
    assert counts.product_params(QWEN) == {"layers": 222_822_400, "head": 622_329_856}
    # rwkv6: 24 x (5 x 2,048^2 + 2 x 2,048 x 32 + 2 x 2,048 x 7,168 + 2,048^2); head 2,048 x 65,536
    assert counts.product_params(RWKV) == {"layers": 1_311_768_576, "head": 134_217_728}


def test_model_flops():
    # 6 x 845,152,256 x 8,192 + 6 x 64 x 128 x 2 x 4,096 x 4,097
    assert counts.train_flops(QWEN, 2, 4096) == 41_541_923_684_352 + 1_648_670_097_408
    # 6 x 1,445,986,304 x 32,768, no attention
    assert counts.train_flops(RWKV, 8, 4096) == 284_292_475_256_832
    # 2 x 222,822,400 x 16,384 + 2 x 622,329,856 x 2 + 4 x 64 x 128 x 2 x 8,192 x 8,193 / 2
    assert counts.prefill_flops(QWEN, 2, 8192) == 7_301_444_403_200 + 2_489_319_424 + 2_199_291_691_008
    assert counts.prefill_flops(RWKV, 1, 8192) == 2 * 1_311_768_576 * 8192 + 2 * 134_217_728


@pytest.mark.parametrize("fn, args, ms", [
    # PERF.md section 6's bounds at llama3.2-3b's and rwkv6's shapes
    (counts.flash_bound_s, (2, 4096, 24, 8, 128), 0.2085023),
    (counts.flash_bwd_bound_s, (2, 4096, 24, 8, 128), 0.5212557),
    (counts.wkv_bound_s, (2, 4096, 32), 0.1007909),
    (counts.wkv_bwd_bound_s, (2, 4096, 32), 0.1812364),
    # the cells' own
    (counts.flash_bwd_bound_s, (2, 4096, 64, 4, 128), 1.3900152),
    (counts.flash_bound_s, (2, 8192, 64, 4, 128), 2.2237530),
    (counts.wkv_bound_s, (1, 8192, 32), 0.1004779),
])
def test_kernel_bounds(fn, args, ms):
    assert fn(*args) * 1e3 == pytest.approx(ms, rel=1e-6)


def test_a_bound_is_the_larger_of_bytes_and_operations():
    assert counts.bound_s(3.35e12, 0.0, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(0.0, 989e12, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 989e12, "bf16") == pytest.approx(2.0)

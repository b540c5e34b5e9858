"""The one profile reader on a synthetic event list: every device op in
exactly one family, the families summing to the busy time, busy plus idle
the stretch."""

from __future__ import annotations

import pytest

from perfbench import profile_reader as pr

RANGES = [
    (pr.UNIT, 0.0, 10.0, 1), (pr.UNIT, 10.0, 20.0, 1),
    ("train.cross_entropy", 3.0, 4.0, 1), ("train.optimizer", 5.0, 8.0, 1),
]
LAUNCHES = [(1, 0.5, 1), (2, 3.5, 1), (3, 6.0, 1), (4, 6.5, 2), (5, 10.5, 1), (6, 11.0, 1), (7, 12.0, 1),
            (8, 19.0, 1), (9, -0.5, 1)]
OPS = [
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 1.0, 2.0, 1),  # gemm
    ("at::native::reduce_kernel<logsumexp>", 2.5, 3.0, 2),  # launched inside the cross-entropy range
    ("at::native::vectorized_elementwise_kernel<adam>", 6.0, 7.0, 3),  # inside the optimizer range
    ("at::native::elementwise_kernel<mul>", 7.0, 7.5, 4),  # during it, but from another thread: rest
    ("void flash_kernel_mma<128, 64, 64>(flash::Params)", 11.0, 13.0, 5),  # hand-written
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", 12.0, 14.0, 6),  # overlaps flash by 1
    ("void wkv_bwd_chunk_kernel(float const*)", 15.0, 16.0, 7),  # hand-written
    ("Memcpy HtoD (Pageable -> Device)", 19.5, 21.0, 8),  # clipped at the stretch's end
    ("at::native::fill_kernel", -1.0, 0.5, 9),  # clipped at its start
]


def test_families_sum_to_busy_and_busy_plus_idle_is_the_stretch():
    s = pr.read(OPS, LAUNCHES, RANGES, {5: "flash_attention", 6: "aten::mm"})
    assert (s.start, s.end, s.units, s.ops) == (0.0, 20.0, 2, 9)
    assert s.busy == pytest.approx(0.5 + 1.0 + 0.5 + 1.0 + 0.5 + 2.0 + 1.0 + 1.0 + 0.5)
    assert sum(s.families.values()) == pytest.approx(s.busy)
    assert s.busy + s.idle == pytest.approx(s.window) == 20.0
    assert s.families == pytest.approx({"rest": 0.5 + 0.5 + 0.5, "gemm": 1.0 + 1.0, "cross_entropy": 0.5,
                                        "optimizer": 1.0, "kernel:flash": 2.0, "kernel:rwkv_wkv_bwd": 1.0})
    assert sum(s.gaps.values()) == pytest.approx(s.idle)
    assert s.gaps["flash_attention"] == pytest.approx(3.5)  # 7.5 -> 11.0, ended by flash's launch
    assert s.family_ms("kernel") == pytest.approx(1e3 * 3.0 / 2)
    assert s.kernel_s("flash") == 2.0 and s.kernel_s("flash_bwd") == 0.0


@pytest.mark.parametrize("name, kernel", [
    ("void flash_bwd_kernel_dkv_wgmma<128>(Args)", "flash_bwd"),
    ("flash_kernel_tiles", "flash"),
    ("void wkv_kernel(float const*, float const*)", "rwkv_wkv"),
    ("combine_bwd_fill_kernel", "moe_combine_bwd"),
    ("void combine_kernel<__nv_bfloat16>(...)", "moe_combine"),
    ("void at::native::elementwise_kernel<128, 2>", None),
    ("wkv_kernel_extra", None),
])
def test_hand_written_kernels_are_known_by_their_function_names(name, kernel):
    assert pr.hand_written(name) == kernel


def test_a_trace_without_units_is_refused():
    with pytest.raises(ValueError):
        pr.read(OPS, LAUNCHES, [("train.optimizer", 0.0, 1.0, 1)])

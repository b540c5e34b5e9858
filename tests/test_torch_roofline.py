"""The port's roofline, ``repro_torch.launch.roofline``, on the CPU.

The reference's term math rewritten for the H100's data-sheet peaks;
``model_flops`` against ``repro.launch.roofline.model_flops`` for every
config (equal where the two packages count the same parameters; for
recurrentgemma-2b the port also counts the RG-LRU's two gate matrices,
which the reference leaves out, and the difference is exactly theirs);
``derive`` exact on one product (2mnk flops, (mk + kn + mn) x 4 bytes);
and on a reduced llama train step the counted flops lie above the model's
6ND but within 2.5x of it.  Counts and arithmetic only; nothing is timed."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.launch import roofline as RL


def test_roofline_terms():
    rf = RL.Roofline(
        flops_per_device=989e12,  # exactly one second of bf16 compute
        bytes_per_device=3.35e12 * 2,  # two seconds of memory
        model_flops_global=989e12 / 2,  # half the counted flops are useful
    )
    assert np.isclose(rf.compute_s, 1.0)
    assert np.isclose(rf.memory_s, 2.0)
    assert rf.collective_s == 0.0  # one card
    assert rf.dominant == "memory"
    assert np.isclose(rf.bound_s, 2.0)
    assert np.isclose(rf.mfu_bound, 0.25)  # memory bound halves the compute-bound MFU
    assert np.isclose(rf.useful_flops_ratio, 0.5)
    assert np.isclose(rf.mfu(4.0), 0.125)
    assert rf.summary()["not_counted"] == {} and rf.summary()["collective_s"] == 0.0
    compute_bound = RL.Roofline(flops_per_device=989e12 * 3, bytes_per_device=3.35e12, model_flops_global=989e12 * 3)
    assert compute_bound.dominant == "compute" and np.isclose(compute_bound.mfu_bound, 1.0)


def test_hw_holds_the_h100_data_sheet_peaks():
    assert RL.HW == {
        "peak_flops_bf16": 989e12, "peak_flops_tf32": 495e12, "peak_flops_f32": 67e12, "peak_flops_f64": 34e12,
        "hbm_bw": 3.35e12,
    }


@pytest.mark.parametrize("nbytes,nops,peak,want", [
    (3.35e9, 0.0, None, (1.0, "bytes")),
    (0.0, 67e9, None, (1.0, "operations")),  # float32 outside the tensor cores by default
    (3.35e9, 34e9 * 2, RL.HW["peak_flops_f64"], (2.0, "operations")),
    (3.35e9, 989e9, RL.HW["peak_flops_bf16"], (1.0, "bytes")),  # a tie goes to the bytes
])
def test_bound_ms(nbytes, nops, peak, want):
    got = RL.bound_ms(nbytes, nops) if peak is None else RL.bound_ms(nbytes, nops, peak)
    assert np.isclose(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_matches_the_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for shape in SHAPES.values():
        got, want = RL.model_flops(cfg, shape), ref_roofline.model_flops(ref, shape)
        if arch != "recurrentgemma-2b":
            assert cfg.param_count() == ref.param_count()
            assert got == want, (arch, shape.name)
            continue
        # w_r and w_i, (R, R) each, in every rglru layer
        gates = 2 * cfg.rnn_width**2 * sum(kind == "rglru" for kind in cfg.layer_kinds)
        assert cfg.active_param_count() - ref.active_param_count() == gates
        per_param = want / ref.active_param_count()  # 6 D or 2 D
        assert np.isclose(got - want, per_param * gates, rtol=1e-12), shape.name


def test_model_flops_of_the_phase_16_llama_step():
    cfg = get_config("llama3.2-3b")
    flops = RL.model_flops(cfg, ShapeSpec("step", "train", 4096, 2))
    assert flops == 6.0 * cfg.active_param_count() * 2 * 4096
    assert 1.57e14 < flops < 1.59e14


def test_derive_is_exact_on_one_product():
    m, k, n = 24, 40, 56
    a, b = torch.randn(m, k), torch.randn(k, n)
    cfg = get_config("llama3.2-3b")
    rf = RL.derive(lambda: a @ b, cfg, SHAPES["decode_32k"])
    assert rf.flops_per_device == 2 * m * n * k
    assert rf.bytes_per_device == (m * k + k * n + m * n) * 4
    assert rf.not_counted == {} and rf.collective_s == 0.0
    assert rf.model_flops_global == RL.model_flops(cfg, SHAPES["decode_32k"])


def test_derive_on_a_reduced_llama_train_step():
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.models.model import init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step

    cfg = get_config("llama3.2-3b").reduced()
    T, B = 128, 2
    model = init_params(cfg, seed=0, device="cpu")
    state = init_train_state(model, OptimizerConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B))
    batch = make_host_batch(data, 0, device="cpu")
    step = make_train_step(cfg, TrainConfig(), model)
    rf = RL.derive(lambda: step(state, batch), cfg, ShapeSpec("reduced", "train", T, B))
    # the products of 6ND, plus attention's, which 6ND leaves out; the plain
    # attention computes every (query, key) pair, the masked ones too
    assert 0.4 < rf.useful_flops_ratio <= 1.0
    assert rf.not_counted == {}  # on the CPU every kernel runs as its plain version
    assert rf.bytes_per_device > 4 * cfg.param_count()  # at least the weights read once
    assert rf.dominant == "memory"  # tiny widths: few flops a byte

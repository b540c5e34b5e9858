"""The plain references against the program's CPU path, at each
configuration's small size (``perfbench/small.py``) in float32: the same
training steps (loss, the first gradient as AdamW takes it, each leaf's
change over three steps) and the same prefill (last-position logits, the
cache).  This shows that the reference does the program's maths; only this
test, not the reference, imports the program."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, small
from perfbench.reference import common

BENCH = harness.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _cell(name: str, seed: int):
    w = CELLS[name]
    cfg = small.config(harness.config(BENCH, w["config"]))
    traffic = small.traffic(harness.traffic(w["traffic"]))
    cell = harness.loop(traffic["kind"]).Cell(cfg, traffic, seed, "cpu")
    cell.setup()
    cell.window(0.0 if traffic["kind"] == "train" else 0.3)
    cell.release()
    return cell


@pytest.mark.parametrize("name", ["qwen3moe-train", "rwkv6-train-accum4"])
def test_training_steps_agree_with_the_program(name):
    cell = _cell(name, 2**31 + 17)
    ref = cell.reference_readings(common.Precision("f32"))
    got = cell.readings
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    for n, g in ref["grad"].items():
        assert got["grad"][n] == pytest.approx(g, rel=1e-4, abs=1e-7), n
    for n, d in ref["change"].items():
        assert got["change"][n] == pytest.approx(d, rel=2e-3, abs=1e-7), n
    numbers = cell.compare(got, ref)
    assert max(numbers.values()) < 2e-3


@pytest.mark.parametrize("name", ["qwen3moe-prefill", "rwkv6-prefill"])
def test_prefill_agrees_with_the_program(name):
    cell = _cell(name, 5)
    ref = cell.reference_readings(common.Precision("f32"))
    assert len(cell.readings) == len(ref) >= 2
    for (j, i, lg, cg), (j2, i2, lw, cw) in zip(cell.readings, ref):
        assert (j, i) == (j2, i2)
        torch.testing.assert_close(lg.float(), lw.float(), rtol=1e-4, atol=1e-4 * float(lw.abs().max()))
        for layer_g, layer_w in zip(cg, cw):
            assert set(layer_g) == set(layer_w)
            for key, w in layer_w.items():
                if key == "pos":
                    assert torch.equal(layer_g[key], w)
                else:
                    torch.testing.assert_close(layer_g[key].float(), w.float(), rtol=1e-4,
                                               atol=1e-4 * float(w.abs().max()))
    assert max(cell.compare(cell.readings, ref).values()) < 1e-4

"""``correct`` has to come out false when the timed path is broken, and when
the reference at the precision below the configuration's stands in the
program's place (the control); and true for a sound run.  Each run skips
the harness's look for a card and drives the rest of a run (set-up,
window, the reference's check against the cell's own limits) at the
configuration's small size on the CPU, in float32, where a sound program
agrees with the reference to round-off."""

from __future__ import annotations

import pytest

from perfbench import harness, run, small
from perfbench.reference import common

BENCH = harness.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
TRAIN = ["qwen3moe-train", "rwkv6-train-accum4"]
PREFILL = ["qwen3moe-prefill", "rwkv6-prefill"]


def _run(name: str, faults=(), seed: int = 4_000_000_001):
    w = CELLS[name]
    cfg = small.config(harness.config(BENCH, w["config"]))
    traffic = small.traffic(harness.traffic(w["traffic"]))
    return run.run_cell(BENCH, name, seed, 0.2, False, device="cpu", require_card=False, faults=faults, cfg=cfg,
                        traffic=traffic, log=lambda *a, **k: None)


@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name, fault", [(n, f) for n in TRAIN for f in ("unchanged", "half_batch")]
                         + [(n, f) for n in PREFILL for f in ("answer", "answer_longest", "cache_unwritten")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    r = _run(name, (fault,))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_the_fp8_control_is_not_correct(name):
    # the control steps down from the bfloat16 the configuration states
    w = CELLS[name]
    cfg = small.config(harness.config(BENCH, w["config"]), dtype="bfloat16")
    traffic = small.traffic(harness.traffic(w["traffic"]))
    cell = harness.loop(traffic["kind"]).Cell(cfg, traffic, 77, "cpu")
    cell.setup()
    cell.window(0.0 if traffic["kind"] == "train" else 0.3)
    cell.release()
    ref = cell.reference_readings(common.Precision("f32"))
    control = cell.compare(cell.reference_readings(common.Precision("fp8")), ref)
    limits = harness.limits(name)
    assert any(control[k] > v for k, v in limits.items()), (control, limits)

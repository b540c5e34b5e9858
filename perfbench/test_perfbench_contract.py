"""The benchmark's files against its contract, on the CPU: every cell names
files that exist, every metric's cells report what it moves, names and
units use the allowed characters, a file dropped in is found by name, a
run without a card fails, and nothing of the benchmark imports JAX or the
JAX package."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness, run

BENCH_DIR = Path(harness.__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_size$|_dim$|_rank$|intermediate|latent|expan|experts_per_tok|proj|state)")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and BENCH["command"][1] == "perfbench/run.py"
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with the largest number of cells fits a check's time budget
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_workload_names_an_existing_configuration_and_traffic():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        kind = harness.traffic(w["traffic"])["kind"]
        assert (BENCH_DIR / "loops" / f"{kind}.py").is_file()
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_configuration_files_hold_what_they_run():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "perfbench"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key) and not WIDTH.search(key), key
        assert (BENCH_DIR / "reference" / f"{cfg['reference']}.py").is_file()
        # the program's configuration says what the published keys say
        port = cfg["port"]
        assert port["num_layers"] == cfg["num_hidden_layers"] and port["d_model"] == cfg["hidden_size"]
        assert port["vocab_size"] == cfg["vocab_size"] and port["dtype"] == cfg["dtype"]
        assert port["remat"] == cfg["remat"]
        if cfg["reference"] == "decoder":
            assert (port["num_heads"], port["num_kv_heads"], port["head_dim"]) == (
                cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"])
            assert (port["num_experts"], port["experts_per_token"], port["moe_d_ff"]) == (
                cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"])
            assert port["capacity_factor"] == cfg["capacity_factor"] and port["norm_eps"] == cfg["rms_norm_eps"]
        else:
            assert port["d_ff"] == cfg["intermediate_size"] and port["norm_eps"] == cfg["norm_eps"]
            assert cfg["hidden_size"] // cfg["head_size"] == port["num_heads"]


def test_every_per_layer_metric_is_read_and_its_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    layers = set()
    for m in BENCH["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and _applies(e2e[m["moves"]], cell), (m["name"], cell)
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.add(m["layer"])
    for cell in cells:
        assert _applies(e2e["setup_s"], cell)
        assert any(_applies(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(_applies(m, cell) for m in BENCH["per_layer"])


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m


def test_names_and_units_use_the_allowed_characters():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_a_file_dropped_into_a_copy_is_found_by_name(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(harness.traffic("prefill-8k-mix"), shapes=[[3, 512]])
    (copy / "traffic" / "prefill-3x512.json").write_text(json.dumps(mix))
    (copy / "metrics" / "calls.prefill.py").write_text("def read(ctx):\n    return float(ctx.stretch.units)\n")
    (copy / "limits" / "new-cell.json").write_text(json.dumps({"logits_gap": 0.5}))
    assert harness.traffic("prefill-3x512", bench_dir=copy)["shapes"] == [[3, 512]]
    assert harness.limits("new-cell", bench_dir=copy) == {"logits_gap": 0.5}
    reader = harness.metric_reader("calls.prefill", bench_dir=copy)
    assert reader(type("ctx", (), {"stretch": type("s", (), {"units": 4})})) == 4.0
    # and a configuration by the name BENCHMARK.json gives it
    bench = dict(BENCH, configs=BENCH["configs"] + [dict(BENCH["configs"][0], name="copy-cfg")])
    assert harness.config(bench, "copy-cfg")["reference"] == "decoder"


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "rwkv6-prefill", "--seed", "3000000000", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA card" in out.err


def test_jax_and_the_jax_package_are_found_by_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models.model", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.sim.jax_sim"]) == ["repro"]
    assert run.forbidden_modules(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax", "jaxlib"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax") and not name.startswith(
                ("perfbench.harness", "perfbench.loops", "perfbench.run")), (path, name)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_limits_name_the_numbers_the_loop_compares(workload):
    wl = harness.workload(BENCH, workload)
    kind = harness.traffic(wl["traffic"])["kind"]
    numbers = {"train": {"loss_gap", "grad_gap", "update_gap"},
               "prefill": {"logits_gap", "logits_worst", "cache_gap"}}[kind]
    lim = harness.limits(workload)
    assert lim and set(lim) <= numbers and all(0 < v < 1 for v in lim.values())

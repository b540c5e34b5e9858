"""The port's lint layer, ``repro_torch.analysis`` (rules RT001-RT005).

Each rule flags its bad snippet and passes its good one (the snippets are
the rule's executable spec, inline; RT004's bad snippet is the float64
ladder's float32 retry factor that
``tests/test_torch_replay_ladder.py::test_float64_ladder_multiplies_by_the_float64_factor``
pins).  The engine, baseline and CLI are the reference's with the port's
marker and baseline file: ``line_hash``, ``suppressed_rules_for_line``,
``iter_py_files``, the baseline's round trip and the CLI's exit codes are
held equal to ``repro.analysis``'s on the same inputs.  The tree itself is
clean against the checked-in baseline, every entry of which says why."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis import engine as ref_engine
from repro.analysis import rules as ref_rules
from repro_torch.analysis import baseline, engine
from repro_torch.analysis.rules import RULES, Finding, check_source

REPO = Path(__file__).resolve().parent.parent
ALL_RULES = sorted(RULES)

# rule -> (path the snippet is checked as, bad snippet, good snippet)
SNIPPETS = {
    "RT001": (
        "src/repro_torch/sim/cluster.py",
        "import jax.numpy as jnp\nfrom repro.sim import cluster\n",
        "import torch\nfrom repro_torch.sim import traces\nfrom . import device_timeline\n",
    ),
    "RT002": (
        "src/repro_torch/serve/engine.py",
        "import torch\n"
        "def pick():\n"
        "    return torch.device('cuda' if torch.cuda.is_available() else 'cpu')\n"
        "def run(x, device='cpu'):\n"
        "    return x.to(device)\n"
        "def place(x):\n"
        "    if torch.cuda.is_available():\n"
        "        return x.to('cuda')\n"
        "    return x\n",
        "import torch\n"
        "from repro_torch.device import resolve_device\n"
        "def run(x, device=None):\n"
        "    return x.to(resolve_device(device))\n"
        "def _plain(x, device='cpu'):\n"
        "    return x.to(device)\n"
        "def main():\n"
        "    if not torch.cuda.is_available():\n"
        "        raise SystemExit('no CUDA device')\n",
    ),
    "RT003": (
        "src/repro_torch/kernels/ops.py",
        "from repro_torch.kernels import build, segmax\n"
        "def peaks(y):\n"
        "    try:\n"
        "        return segmax.segmax_cuda(y)\n"
        "    except RuntimeError:\n"
        "        return plain(y)\n"
        "def lib():\n"
        "    try:\n"
        "        return build.library('segmax')\n"
        "    except OSError:\n"
        "        return None\n",
        "from repro_torch.kernels import segmax\n"
        "def peaks(y):\n"
        "    try:\n"
        "        return segmax.segmax_cuda(y)\n"
        "    except RuntimeError as e:\n"
        "        raise RuntimeError('segmax failed') from e\n"
        "def parse(s):\n"
        "    try:\n"
        "        return int(s)\n"
        "    except ValueError:\n"
        "        return None\n",
    ),
    "RT004": (
        "src/repro_torch/kernels/wastage.py",
        "import torch\n"
        "def replay(values, factor, acc_dtype=torch.float64):\n"
        "    f = torch.tensor(factor, dtype=torch.float32)  # the factor rounded to float32\n"
        "    return values * f.to(acc_dtype)\n"
        "def mean(x, dtype):\n"
        "    return x.float().mean().to(dtype)\n",
        "import torch\n"
        "def replay(values, factor, acc_dtype=torch.float32):\n"
        "    f = torch.tensor(factor, dtype=acc_dtype)\n"
        "    bits = torch.int64 if acc_dtype == torch.float64 else torch.int32\n"
        "    wide = torch.float64 if acc_dtype == torch.float64 else torch.float32\n"
        "    return (values * f).to(wide).view(bits)\n"
        "def no_dtype(x):\n"
        "    return x.to(torch.float32)\n",
    ),
    "RT005": (
        "src/repro_torch/sim/device_timeline.py",
        "import torch\n"
        "def place(rows):\n"
        "    out = []\n"
        "    for r in rows:\n"
        "        out.append(r.sum().item())\n"
        "    while rows:\n"
        "        torch.cuda.synchronize()\n"
        "        rows.pop()\n"
        "    return [r.cpu().numpy() for r in out]\n",
        "import torch\n"
        "def place(rows):\n"
        "    total = torch.stack([r.sum() for r in rows])\n"
        "    vals = total.cpu().numpy()\n"
        "    for v in total.tolist():\n"
        "        def later(t):\n"
        "            return t.item()\n"
        "    return vals\n",
    ),
}
FLAGGED_LINES = {"RT001": [1, 2], "RT002": [3, 4, 7], "RT003": [5, 10], "RT004": [3, 6], "RT005": [5, 7, 9]}


def _rules(findings) -> list[str]:
    return [f.rule for f in findings]


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_flags_its_bad_snippet(rule):
    path, bad, _ = SNIPPETS[rule]
    findings = check_source(bad, path)
    assert set(_rules(findings)) == {rule}
    assert [f.line for f in findings] == FLAGGED_LINES[rule], [f.format() for f in findings]


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_passes_its_good_snippet(rule):
    path, _, good = SNIPPETS[rule]
    findings = check_source(good, path)
    assert findings == [], [f.format() for f in findings]


@pytest.mark.parametrize("rule,elsewhere", [
    ("RT001", "tests/test_torch_cluster.py"),  # tests hold the port against the reference
    ("RT002", "src/repro_torch/device.py"),  # the device policy itself
    ("RT004", "tests/test_torch_ladders.py"),
    ("RT005", "src/repro_torch/core/timeline.py"),  # a host module
])
def test_rule_keeps_to_its_scope(rule, elsewhere):
    _, bad, _ = SNIPPETS[rule]
    assert rule not in _rules(check_source(bad, elsewhere))


def test_rt001_reaches_chip_smoke_and_tools_but_not_relative_imports():
    src = "import jax\nfrom . import repro\n"
    assert _rules(check_source(src, "chip_smoke.py")) == ["RT001"]
    assert _rules(check_source(src, "tools/scan_clocks.py")) == ["RT001"]


def test_rt004_reproduces_the_float64_ladder_fault():
    """The float64 ladder once multiplied by a factor rounded to float32."""
    path, bad, _ = SNIPPETS["RT004"]
    line = next(i for i, s in enumerate(bad.splitlines(), 1) if "the factor rounded to float32" in s)
    assert line in [f.line for f in check_source(bad, path) if f.rule == "RT004"]


def test_rt005_reports_a_cpu_numpy_chain_once():
    src = "def f(xs):\n    for x in xs:\n        yield x.cpu().numpy()\n"
    assert [f.message.split()[0] for f in check_source(src, "src/repro_torch/train/x.py")] == [".cpu()"]


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------


def _lines(marker: str, ids: str) -> list[str]:
    m, M = marker, marker.upper()
    return [
        "x = f()",
        f"x = f()  # {m}: ignore",
        f"x = f()  # {m}: ignore[{M}001]",
        f"x = f()  # {M}: Ignore[{m}003, {M}005]",
        f"x = f()  #{m}:ignore[]",
        f"x = f()  # {m}: ignore[{ids}]",
        "x = f()  # ignore",
    ]


def test_suppressed_rules_for_line_is_the_reference_s():
    port = [engine.suppressed_rules_for_line(s) for s in _lines("rt", "RT999")]
    ref = [ref_engine.suppressed_rules_for_line(s) for s in _lines("ra", "RA999")]
    assert port == [None if r is None else {x.replace("RA", "RT") for x in r} for r in ref]
    assert port[1] == {"*"} and port[3] == {"RT003", "RT005"} and port[0] is None
    # the reference's marker suppresses nothing here, and the port's nothing there
    assert engine.suppressed_rules_for_line("x  # ra: ignore") is None
    assert ref_engine.suppressed_rules_for_line("x  # rt: ignore") is None


def test_suppressions_and_unknown_ids(tmp_path):
    f = tmp_path / "repro_torch" / "sim" / "batch_engine.py"
    f.parent.mkdir(parents=True)
    f.write_text(
        "def f(xs):\n"
        "    for x in xs:\n"
        "        a = x.item()  # rt: ignore[RT005]\n"
        "        b = x.item()  # rt: ignore\n"
        "        c = x.item()  # rt: ignore[RT004]\n"
        "        d = x.item()  # rt: ignore[RT999]\n"
    )
    result = engine.analyze_paths([f])
    assert _rules(result.active) == ["RT005", "RT005"] and len(result.suppressed) == 2
    assert "ignore[RT004]" in result.active[0].source_line and "ignore[RT999]" in result.active[1].source_line
    assert engine.unknown_rules({"RT005", "RT999", "RA001"}) == {"RT999", "RA001"}
    assert _rules(engine.analyze_paths([f], rules={"RT004"}).active) == []


# ---------------------------------------------------------------------------
# engine and baseline against the reference's
# ---------------------------------------------------------------------------


def test_line_hash_is_the_reference_s():
    for line in ["x = t.item()", "  x = t.item()  ", "", "return (torch.randn(shape) * std).to(dtype)", "é"]:
        assert baseline.line_hash(line) == ref_baseline.line_hash(line)


def test_iter_py_files_is_the_reference_s(tmp_path):
    for rel in ("a/b.py", "a/__pycache__/c.py", "a/analysis_fixtures/d.py", "a/.git/e.py", "a/x.txt",
                "a/deep/f.py", "g.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("x = 1\n")
    for args in ([tmp_path], [tmp_path / "a"], [tmp_path / "a" / "analysis_fixtures" / "d.py", tmp_path / "g.py"]):
        got = engine.iter_py_files(args)
        assert got == ref_engine.iter_py_files(args)
    assert [p.name for p in engine.iter_py_files([tmp_path])] == ["b.py", "f.py", "g.py"]
    for fn in (engine.iter_py_files, ref_engine.iter_py_files):
        with pytest.raises(FileNotFoundError):
            fn([tmp_path / "missing"])


def test_baseline_round_trip_is_the_reference_s(tmp_path):
    fields = [("RT005", "src/a.py", 3, 4, "m", "x = t.item()"), ("RT005", "src/a.py", 9, 4, "m", "x = t.item()"),
              ("RT004", "src/b.py", 1, 0, "m", "y = z.float()"), ("RT001", "src\\c.py", 2, 0, "m", "import jax")]
    port = [Finding(*f) for f in fields]
    ref = [ref_rules.Finding(*f) for f in fields]
    notes = {("RT004", "src/b.py", baseline.line_hash("y = z.float()")): "why"}
    baseline.Baseline.from_findings(port[:3], notes).save(tmp_path / "port.json")
    ref_baseline.Baseline.from_findings(ref[:3], notes).save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    bl, rbl = baseline.Baseline.load(tmp_path / "port.json"), ref_baseline.Baseline.load(tmp_path / "ref.json")
    assert bl.entries == rbl.entries and bl.notes == rbl.notes == notes
    active, baselined, stale = bl.partition(port[:2] + port[3:])  # one RT005 line twice, b.py gone
    r_active, r_baselined, r_stale = rbl.partition(ref[:2] + ref[3:])
    assert [f.__dict__ for f in active] == [f.__dict__ for f in r_active] and len(active) == 1
    assert [f.__dict__ for f in baselined] == [f.__dict__ for f in r_baselined] and len(baselined) == 2
    assert stale == r_stale == [("RT004", "src/b.py", baseline.line_hash("y = z.float()"))]
    (tmp_path / "bad.json").write_text(json.dumps({"version": 2, "entries": []}))
    for load in (baseline.Baseline.load, ref_baseline.Baseline.load):
        with pytest.raises(ValueError, match="unsupported baseline version"):
            load(tmp_path / "bad.json")


# ---------------------------------------------------------------------------
# CLI + the tree itself
# ---------------------------------------------------------------------------


def _run_cli(package: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{package}.analysis", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"},
        timeout=120,
    )


def _bad_file(tmp_path: Path, rule: str) -> Path:
    path, bad, _ = SNIPPETS[rule]
    f = tmp_path / rule / path
    f.parent.mkdir(parents=True)
    f.write_text(bad)
    return f


def test_cli_exit_codes_are_the_reference_s(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    cases = {
        "list rules": ((["--list-rules"], ["--list-rules"]), 0),
        "no paths": (([], []), 2),
        "unknown rule": ((["--rule", "RT999", "src"], ["--rule", "RA999", "src"]), 2),
        "missing path": ((["no/such/path"], ["no/such/path"]), 2),
        "a finding": (([str(_bad_file(tmp_path, "RT005"))], ["tests/analysis_fixtures/ra001_flag.py"]), 1),
        "a syntax error": (([str(broken)], [str(broken)]), 1),
        "clean": (([str(clean)], [str(clean)]), 0),
    }
    for name, ((port_args, ref_args), rc) in cases.items():
        port, ref = _run_cli("repro_torch", *port_args), _run_cli("repro", *ref_args)
        assert (port.returncode, ref.returncode) == (rc, rc), (name, port.stderr, ref.stderr)
    listed = _run_cli("repro_torch", "--list-rules").stdout
    assert all(rule in listed for rule in ALL_RULES) and "RA001" not in listed
    payload = json.loads(_run_cli("repro_torch", "--json", str(_bad_file(tmp_path / "j", "RT003"))).stdout)
    assert payload["ok"] is False and [f["rule"] for f in payload["active"]] == ["RT003", "RT003"]


@pytest.mark.parametrize("rule", ALL_RULES)
def test_cli_exits_1_on_each_bad_snippet(tmp_path, rule):
    out = _run_cli("repro_torch", str(_bad_file(tmp_path, rule)))
    assert out.returncode == 1 and rule in out.stdout, out.stdout + out.stderr


def test_tree_is_clean_against_the_checked_in_baseline():
    """The acceptance invariant: the port's tree, chip_smoke.py, the tools and
    the tests have no finding the baseline does not hold, and the baseline
    holds nothing stale and nothing without its reason."""
    out = _run_cli("repro_torch", "src/repro_torch", "chip_smoke.py", "tools", "tests")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "stale baseline entry" not in out.stderr, out.stderr
    raw = json.loads((REPO / baseline.DEFAULT_BASELINE).read_text())
    assert raw["entries"] and all(e.get("note", "").strip() for e in raw["entries"])
    result = engine.analyze_paths([REPO / "src" / "repro_torch", REPO / "tests"])
    assert result.files_checked > 100 and not result.errors

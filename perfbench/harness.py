"""What the traffic loops share: the benchmark's files found by name, the program
built from a configuration with the benchmark's weights, the reference and
its comparison numbers.

The program under test is ``repro_torch`` (under ``src/`` of the
checkout); it is imported only inside the functions that build it.  The
reference (``perfbench/reference/<name>.py``, named by the configuration's
``reference``) imports nothing of it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from pathlib import Path

import torch

from perfbench import weights
from perfbench.reference import common

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


# ---------------------------------------------------------------------------
# Files by name
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str, bench_dir: Path = BENCH) -> dict:
    return json.loads((bench_dir / "limits" / f"{workload_name}.json").read_text())


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def loop(kind: str):
    return importlib.import_module(f"perfbench.loops.{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The program, built from a configuration
# ---------------------------------------------------------------------------


def port_config(cfg: dict):
    """The program's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs.base import ModelConfig

    kw = dict(cfg["port"])
    kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def build_model(cfg: dict, seed: int, device):
    """The program's model with the benchmark's weights, by parameter
    name.  Raises unless the program's parameters are the specs', name for
    name, shape for shape, dtype for dtype."""
    from repro_torch.models.model import Transformer

    specs = reference(cfg).param_specs(cfg)
    model = Transformer(port_config(cfg), seed=None, device=device).eval()
    params = dict(model.named_parameters())
    want = {n: (tuple(s), d) for n, s, d, _ in specs}
    have = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch.")) for n, p in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise ValueError(f"the program's parameters are not the configuration's: {diff[:6]}")
    with torch.no_grad():
        for name, t in weights.leaves(specs, seed, device):
            params[name].copy_(t)
    return model


def upload(batch: dict, device) -> dict:
    """A host batch onto the device, as the program's trainer uploads one."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Comparison numbers
# ---------------------------------------------------------------------------


def norm(t: torch.Tensor) -> float:
    """The float64 norm of a tensor, slice by slice."""
    return math.sqrt(common.sq_norm(t.detach()))


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """The float64 norm of a - b, slice by slice."""
    return math.sqrt(sum(common.sq_norm(x.float() - y.float())
                         for x, y in zip(common.slices(a.detach()), common.slices(b.detach()))))


def worst(gaps) -> float:
    """The largest gap; infinite where one is not a number."""
    gaps = list(gaps)
    return max(gaps, default=0.0) if all(math.isfinite(g) for g in gaps) else math.inf


def norm_gap(got: dict[str, float], want: dict[str, float], names=None) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = sorted(want.values())[len(want) // 2]
    return worst(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in (want if names is None else names))


def row_gap(got: torch.Tensor, want: torch.Tensor, row: int) -> float:
    """The largest relative error of a row of ``row`` numbers: |got - want|
    over |want|, or over a millionth of the largest row's norm for a row
    that is all but zero (an empty cache slot)."""
    g = got.detach().float().reshape(-1, row)
    w = want.detach().float().reshape(-1, row)
    if not torch.isfinite(g).all():
        return math.inf
    wn = w.norm(dim=1)
    den = torch.clamp(wn, min=1e-6 * float(wn.max()) + 1e-30)
    return float(((g - w).norm(dim=1) / den).max())

"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload) names a configuration
(``perfbench/configs/``), whose ``reference`` names the plain reference
(``perfbench/reference/``), and a traffic file (``perfbench/traffic/``),
whose ``kind`` names its loop (``perfbench/loops/``); the limits of
its comparison are ``perfbench/limits/<workload>.json`` and each per-layer
metric is read by ``perfbench/metrics/<metric>.py``.  The program under
test is ``repro_torch``, from ``src/`` of the checkout; its kernels build
into its own directory there on a checkout's first run.

Set-up (``setup_s``, from the start of this process): the weights drawn on
the card from the seed, the traffic drawn on the host, the program built,
every shape warmed.  Then the window of ``--seconds``; with ``--trace 1`` a
steady stretch of it runs under ``torch.profiler`` and the line carries
the per-layer metrics instead of the end-to-end ones.  Once the window has
closed the peak memory is read, the program is freed, and the reference
checks what the window produced.  The last line of standard output is one
JSON object; the numbers compared and their limits are also the last lines
of standard error.  Without a card (or with fewer than the cell asks for),
or with JAX or the JAX package loaded once the window has closed, it exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
GIB = 1024**3


class Refused(Exception):
    """The run cannot give a result (no card, JAX loaded)."""


def forbidden_modules(names=None) -> list[str]:
    """The top-level names of JAX or the JAX package among ``names`` (the
    loaded modules), compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def run_cell(bench: dict, workload_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             require_card: bool = True, faults: tuple[str, ...] = (), cfg=None, traffic=None, log=print,
             after=None) -> dict:
    """Run a cell; returns the result line's object (the last key,
    ``checks``, the numbers compared beside their limits).  ``cfg`` and
    ``traffic`` stand in for the files (the harness's own tests run a cell
    at a small size on the CPU, with ``require_card`` off and faults
    planted).  ``after(cell, ref, numbers)``, where given, is called once
    every number is compared, with the cell, the float32 reference's
    readings and all the numbers (``calibrate.py`` reads the control and
    the detail there)."""
    import torch

    from perfbench import harness
    from perfbench.reference import common

    wl = harness.workload(bench, workload_name)
    if require_card:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: the benchmark measures the card and does not fall back to the CPU")
        if torch.cuda.device_count() < wl["chips"]:
            raise Refused(f"the cell asks for {wl['chips']} cards, {torch.cuda.device_count()} found")
    cfg = harness.config(bench, wl["config"]) if cfg is None else cfg
    traffic = harness.traffic(wl["traffic"]) if traffic is None else traffic
    limits = harness.limits(workload_name)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = harness.loop(traffic["kind"]).Cell(cfg, traffic, seed, device, faults=faults)
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    cell.window(seconds, traffic["trace_units"] if trace else 0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if trace:
        from perfbench import profile_reader

        t = time.perf_counter()
        events = profile_reader.from_profiler(cell.profile)
        stretch = profile_reader.read(*events)
        matched = sum(1 for op in events[0] if op[3] in events[3])
        log(f"trace: {len(events[0])} device ops, {matched} matched to their launch, {stretch.units} units, "
            f"read in {time.perf_counter() - t:.1f} s", file=sys.stderr)
        cell.profile = None
        ctx = types.SimpleNamespace(kind=cell.kind, cfg=cfg, traffic=traffic, stretch=stretch, units=cell.units,
                                    accum=traffic.get("accum_steps", 1))
        for m in bench["per_layer"]:
            if workload_name in m.get("workloads", [workload_name]):
                v = harness.metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = stretch.busy
        device_info["window_s"] = stretch.window
        top = sorted(stretch.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(stretch.gaps.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": [[n[:160], s] for n, s in gaps]}
        log("families (ms a unit): " + ", ".join(f"{k} {1e3 * v / stretch.units:.3f}"
                                                  for k, v in sorted(stretch.families.items())), file=sys.stderr)
    else:
        values = dict(cell.e2e, setup_s=setup_s, peak_hbm_gib=peak / GIB)
        for m in bench["end_to_end"]:
            if workload_name in m.get("workloads", [workload_name]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    cell.release()
    with common.no_tf32():
        ref = cell.reference_readings(common.Precision("f32"))
        numbers = cell.compare(cell.readings, ref)
        if after is not None:
            after(cell, ref, numbers)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else 1e300, "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        from perfbench import harness

        bench = harness.load_benchmark()
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
        found = forbidden_modules()
        if found:
            raise Refused(f"modules of JAX or the JAX package are loaded: {found}")
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

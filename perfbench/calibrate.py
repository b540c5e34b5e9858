"""The readings the limits of ``correct`` are set from, on the card, in one
process:

    python3 perfbench/calibrate.py --workload <name> --seeds 11 12 ... [--control 11 12 13]
        [--faults half_batch --fault-seeds 11 12 13] [--seconds 5]

For each seed it runs the cell as a benchmark run does (``run.run_cell``
with a window of ``--seconds``) and prints every number the run compares:
the lower reading of each limit is the largest of these over the seeds.
For the seeds in ``--control`` it also puts the reference itself in the
program's place at the precision below the configuration's (fp8 products,
``Precision("fp8")``) and prints the same numbers for it against the
float32 reference: the upper reading is the smallest of those.  For the
seeds in ``--fault-seeds`` it also runs the cell with each of ``--faults``
planted (``loops.<kind>._broken``) and prints its numbers, the readings of
those faults.  One JSON line a seed, then a summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    import torch

    from perfbench import harness, run
    from perfbench.reference import common

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    quiet = lambda *a, **k: None  # noqa: E731

    def numbers(seed: int, faults=(), control=False) -> dict:
        got = {}

        def after(cell, ref, program):
            got["program"] = program
            got["attempted"] = cell.attempted
            if control:
                got["control"] = cell.compare(cell.reference_readings(common.Precision("fp8")), ref)
            got["detail"] = detail(cell, ref)

        run.run_cell(bench, args.workload, seed, args.seconds, False, faults=faults, log=quiet, after=after)
        gc.collect()
        torch.cuda.empty_cache()
        return got

    rows = []
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            got = numbers(seed, control=seed in args.control)
            row = {"workload": args.workload, "seed": seed, **got}
            if seed in args.fault_seeds:
                row["faults"] = {f: numbers(seed, (f,))["program"] for f in args.faults}
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
    except run.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    names = rows[0]["program"].keys()
    summary = {"workload": args.workload,
               "lower": {k: max(r["program"][k] for r in rows) for k in names},
               "upper": {k: min((r["control"][k] for r in rows if "control" in r), default=None) for k in names},
               "faults": {f: {k: min(r["faults"][f][k] for r in rows if "faults" in r) for k in names}
                          for f in args.faults},
               "seeds": args.seeds, "control_seeds": args.control}
    print(json.dumps(summary), flush=True)
    return 0


def detail(cell, ref) -> dict:
    """Where each number comes from: the worst leaves of a training cell,
    each sampled call's gaps of a prefill cell."""
    if cell.kind == "train":
        got = cell.readings
        med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
        g = sorted(((abs(got["grad"][n] - w) / max(w, med), n) for n, w in ref["grad"].items()), reverse=True)[:3]
        u = sorted(((abs(got["change"][n] - w) / max(w, 1e-30), n) for n, w in ref["change"].items()),
                   reverse=True)[:3]
        return {"loss": got["loss"], "ref_loss": ref["loss"], "grad_worst": g, "change_worst": u}
    calls = []
    for (j, i, lg, cg), (_, _, lw, cw) in zip(cell.readings, ref):
        lg, lw = lg.float(), lw.float()
        rows = (lg - lw).norm(dim=-1) / (lw - lw.mean(-1, keepdim=True)).norm(dim=-1)
        calls.append({"shape": cell.shapes[j], "prompt": i, "logits_rows": [round(float(x), 6) for x in rows],
                      "cache_by_layer": [cell.compare([(j, i, lg, [c_g])], [(j, i, lw, [c_w])])["cache_gap"]
                                         for c_g, c_w in zip(cg, cw)]})
    return {"calls": calls}


if __name__ == "__main__":
    sys.exit(main())

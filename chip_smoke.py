#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run on a wrong result:

1. build the segmax and wastage kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the largest bucket of the main path (peaks and fail indices
   exact, wastage within rtol 1e-5 / atol 1e-4 GiB*s), and time both;
3. the paper's Fig. 7 grid at full corpus size on the card (cold and warm),
   with the launch counts of that run, held against the port's own CPU run
   (every Fig. 7a cell within rtol 1e-3);
4. the Fig. 8 k-sweep (k = 1..15) on a sawtooth and a ramp/staged task, on
   the card against the CPU.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero without
a card, or when anything disagrees.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NoReturn

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CORPUS_SCALE = 1.0  # the paper's corpus: 33 eligible tasks
FIG8_KS = tuple(range(1, 16))


def _fail(msg: str) -> NoReturn:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(fn) -> dict:
    """One ``fn()`` under torch.profiler: wall time, device time of the
    kernels and of the copies, kernel launches, the engine's two phases
    (host time, and device span of their annotations) and the busiest
    kernels with their launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _wall(fn)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    phases_host: dict[str, float] = {}
    phases_device: dict[str, float] = {}
    device: dict[str, list] = {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith("torch_sim."):
            into = phases_host if e.device_type == cpu else phases_device
            into[e.name] = into.get(e.name, 0.0) + ms
        elif e.device_type == cuda:
            acc = device.setdefault(e.name, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
    copies = {n: v for n, v in device.items() if n.startswith(("Memcpy", "Memset"))}
    kernels = {n: v for n, v in device.items() if n not in copies}
    return dict(
        wall_s=wall,
        kernel_ms=sum(v[0] for v in kernels.values()),
        copy_ms=sum(v[0] for v in copies.values()),
        launches=sum(v[1] for v in kernels.values()),
        phases_host_ms=phases_host,
        phases_device_ms=phases_device,
        top=sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6],
    )


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_phase(batch, cfg, dev) -> dict[str, dict]:
    """Each kernel against its plain version at the largest bucket's shapes."""
    import torch

    from repro_torch.core.allocation import attempt_outcomes_batch
    from repro_torch.core.segmentation import segment_peaks_dynamic
    from repro_torch.kernels import segmax, wastage
    from repro_torch.sim import torch_sim
    from repro_torch.sim.batch_engine import GRID_METHODS

    L, B, T = batch.shape
    S = L * B
    y = torch.as_tensor(batch.y.reshape(S, T)).to(dev)
    lengths = torch.as_tensor(batch.lengths.reshape(S)).to(dev)
    series = torch.arange(S, dtype=torch.int32, device=dev)
    valid = torch.clamp(lengths.to(torch.int64), max=T)
    out = {}

    print(f"kernels phase: largest bucket L={L} B={B} T={T} ({batch.y.nbytes / 1e6:.1f} MB of series)")
    for k_max, k_eff in (
        (cfg.ksegments.k, torch.full((S,), cfg.ksegments.k, dtype=torch.int32, device=dev)),
        (15, (torch.arange(S, device=dev) % 15 + 1).to(torch.int32)),
    ):
        got = segmax.segmax_cuda(y, lengths, series, k_eff, k_max)
        want = segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            _fail(f"segmax k_max={k_max}: {(got != want).sum().item()} peaks differ from the plain version")
        ms = _cuda_ms(lambda: segmax.segmax_cuda(y, lengths, series, k_eff, k_max), 50)
        plain_ms = _cuda_ms(lambda: segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max), 5)
        print(f"  segmax k_max={k_max}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if k_max == cfg.ksegments.k:  # the main path's shape
            nbytes = 4 * valid.sum().item() + 4 * 3 * S + 4 * S * k_max
            bound_ms, bound_by = _bound(nbytes, valid.sum().item())
            out["segmax"] = dict(max_abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)

    # wastage on the first replay round of the bucket: every method row of
    # every non-empty execution, with the engine's own predictions
    kc = cfg.ksegments
    x = torch.as_tensor(batch.x, dtype=torch.float32).to(dev)
    bounds, values = torch_sim.predict_lanes(
        x - x[:, :1], y, lengths, series.view(L, B), torch.as_tensor(batch.default_mib, dtype=torch.float32).to(dev),
        torch.full((L,), kc.k, dtype=torch.int32, device=dev), methods=GRID_METHODS, k=kc.k,
        interval_s=kc.interval_s, floor_mib=kc.floor_mib, cap_mib=cfg.node_cap_mib, error_mode=kc.error_mode,
        insample_window=kc.insample_window,
    )
    M, k = len(GRID_METHODS), kc.k
    rows = torch.nonzero(lengths.repeat_interleave(M) > 0).squeeze(1)
    rs = series.repeat_interleave(M)[rows].contiguous()
    b = bounds.reshape(-1, k)[rows].contiguous()
    v = torch.clamp(values.reshape(-1, k)[rows], max=cfg.node_cap_mib).contiguous()
    interval = kc.interval_s
    w_k, f_k = wastage.wastage_cuda(y, lengths, rs, b, v, interval)
    w_p, f_p = attempt_outcomes_batch(y[rs], lengths[rs], interval, b, v)
    torch.cuda.synchronize()
    if not torch.equal(f_k, f_p):
        _fail(f"wastage: {(f_k != f_p).sum().item()} fail indices differ from the plain version")
    if not torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-4):
        _fail(f"wastage: max abs difference {(w_k - w_p).abs().max().item()} GiB*s beyond rtol 1e-5 / atol 1e-4")
    ms = _cuda_ms(lambda: wastage.wastage_cuda(y, lengths, rs, b, v, interval), 50)
    plain_ms = _cuda_ms(lambda: attempt_outcomes_batch(y[rs], lengths[rs], interval, b, v), 5)
    R = rows.numel()
    n_failed = (f_k >= 0).sum().item()
    print(f"  wastage rows={R} (failed {n_failed}): fail indices exact, max |dw| "
          f"{(w_k - w_p).abs().max().item():.3e} GiB*s; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # bytes: each distinct series read once, each row's schedule and outputs;
    # operations: per valid sample t, k compares, a - y, the sum and y > a,
    # and for failed rows the second pass up to the kill
    row_len = valid[rs.long()]
    nbytes = 4 * valid.sum().item() + 4 * S + R * (4 + 8 * k + 8)
    nops = (row_len.sum().item() * (k + 5)) + ((f_k[f_k >= 0].to(torch.int64) + 1).sum().item() * (k + 3))
    bound_ms, bound_by = _bound(nbytes, nops)
    out["wastage"] = dict(max_abs_err=(w_k - w_p).abs().max().item(), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return out


def _retry_diffs(got, want) -> int:
    return sum(int((g.retries != w.retries).sum()) for g, w in zip(got, want))


def grid_phase(wfs, cfg):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim.batch_engine import simulate_grid
    from repro_torch.sim.simulator import fig7a_mean_wastage, fig7b_lowest_counts, fig7c_mean_retries

    ops.reset_launch_counts()
    res, cold = _wall(lambda: simulate_grid(wfs, cfg=cfg))
    counts = ops.launch_counts()
    print(f"grid phase: cuda cold {cold:.3f} s; launches {counts}")
    if min(counts.values()) < 1:
        _fail(f"a kernel was not launched on the grid path: {counts}")
    _, warm = _wall(lambda: simulate_grid(wfs, cfg=cfg))
    prof = _profile(lambda: simulate_grid(wfs, cfg=cfg))
    busy = prof["kernel_ms"] / 1e3 / prof["wall_s"]
    print(f"  profiled warm run: wall {prof['wall_s']:.3f} s; kernels {prof['kernel_ms']:.2f} ms on the device "
          f"({100 * busy:.2f}% busy, {prof['launches']} launches); copies {prof['copy_ms']:.2f} ms")
    print(f"  phases, host ms {json.dumps({k: round(v, 2) for k, v in prof['phases_host_ms'].items()})}; "
          f"device span ms {json.dumps({k: round(v, 2) for k, v in prof['phases_device_ms'].items()})}")
    for name, (ms, n) in prof["top"]:
        print(f"    {ms:8.3f} ms {n:6d} x  {name[:100]}")
    t0 = time.perf_counter()
    ref = simulate_grid(wfs, cfg=cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    print(f"  cuda warm {warm:.3f} s; cpu {cpu_s:.3f} s; {len(res)} rows")
    if len(res) != len(ref) or any(
        (a.task, a.method, a.train_frac, a.n_test) != (b.task, b.method, b.train_frac, b.n_test) for a, b in zip(res, ref)
    ):
        _fail("grid rows differ between cuda and cpu")
    if not all(np.isfinite(r.wastage_gib_s).all() and len(r.wastage_gib_s) == r.n_test for r in res):
        _fail("grid wastage not finite or of the wrong length")
    wa, wr = fig7a_mean_wastage(res), fig7a_mean_wastage(ref)
    ra, bl = fig7c_mean_retries(res), fig7b_lowest_counts(res)
    worst = max(abs(wa[c] - wr[c]) / max(abs(wr[c]), 1e-12) for c in wr)
    n_diff = _retry_diffs(res, ref)
    print(f"  fig7a cells cuda vs cpu: max rel diff {worst:.3e} (limit 1e-3); executions whose retries differ: {n_diff}")
    if worst > 1e-3:
        _fail(f"fig7a cell off by {worst:.3e} (rtol 1e-3) between cuda and cpu")
    methods = sorted({m for m, _ in wa}, key=[r.method for r in res].index)
    fracs = sorted({f for _, f in wa})
    print("  fig7a mean wastage GiB*s (fig7c mean retries, fig7b lowest counts):")
    for m in methods:
        print("    " + f"{m:20s}" + "".join(f"  {f:.2f}: {wa[(m, f)]:10.2f} ({ra[(m, f)]:.3f}, {bl[(m, f)]:2d})" for f in fracs))
    best = min(wa[(m, 0.75)] for m in ("witt-lr", "ppm", "ppm-improved"))
    print(f"  ksegments-selective@0.75 reduction vs best baseline: {100 * (1 - wa[('ksegments-selective', 0.75)] / best):.2f}% "
          "(paper: 29.48%, information only)")
    return counts, cold, warm


def sweep_phase(wfs, cfg):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim.batch_engine import simulate_ksweep

    eligible = [t for wf in wfs for t in wf.eligible_tasks(cfg.min_executions)]
    saw = next(t for t in eligible if t.family == "sawtooth")
    smooth = next(t for t in eligible if t.family in ("ramp", "staged"))
    ops.reset_launch_counts()
    for trace in (saw, smooth):
        got, cold = _wall(lambda: simulate_ksweep(trace, FIG8_KS, 0.5, cfg))
        _, warm = _wall(lambda: simulate_ksweep(trace, FIG8_KS, 0.5, cfg))
        ref = simulate_ksweep(trace, FIG8_KS, 0.5, cfg, device="cpu")
        worst = max(abs(got[k].mean_wastage - ref[k].mean_wastage) / max(abs(ref[k].mean_wastage), 1e-12) for k in FIG8_KS)
        n_diff = _retry_diffs([got[k] for k in FIG8_KS], [ref[k] for k in FIG8_KS])
        print(f"sweep phase: {trace.name} ({trace.n_executions} executions, T={trace.max_samples()}): cuda cold {cold:.3f} s, "
              f"warm {warm:.3f} s; mean wastage max rel diff vs cpu {worst:.3e}; retries differ on {n_diff}")
        print("  mean wastage by k: " + " ".join(f"{k}:{got[k].mean_wastage:.1f}" for k in FIG8_KS))
        if worst > 1e-3 or not all(np.isfinite(got[k].wastage_gib_s).all() for k in FIG8_KS):
            _fail(f"k-sweep of {trace.name} disagrees with the cpu run (rtol 1e-3) or is not finite")
    counts = ops.launch_counts()
    print(f"  sweep launches {counts}")
    if min(counts.values()) < 1:
        _fail(f"a kernel was not launched on the sweep path: {counts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic corpus")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.ksegments import KSegmentsConfig
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.sim.simulator import SimConfig
    from repro_torch.sim.traces import generate_suite, pack_traces

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip()
    dev = resolve_device()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({', '.join(built) or 'cached'})")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # The paper's corpus and the benchmark's grid configuration: k = 4, bounded
    # insample offsets over 64 executions, fractions 0.25/0.5/0.75.
    t0 = time.perf_counter()
    wfs = generate_suite(seed=args.seed, scale=CORPUS_SCALE)
    cfg = SimConfig(min_executions=20, ksegments=KSegmentsConfig(k=4, error_mode="insample", insample_window=64))
    tasks = [t for wf in wfs for t in wf.eligible_tasks(cfg.min_executions)]
    batches = pack_traces(tasks)
    print(f"corpus: {len(tasks)} eligible tasks in {len(batches)} buckets, "
          f"{sum(b.y.nbytes for b in batches) / 1e6:.1f} MB padded series ({time.perf_counter() - t0:.2f} s)")

    per_kernel = kernels_phase(max(batches, key=lambda b: b.y.nbytes), cfg, dev)
    counts, _, _ = grid_phase(wfs, cfg)
    sweep_phase(wfs, cfg)

    sources = {
        "segmax": ("src/repro_torch/kernels/csrc/segmax.cu", "src/repro/kernels/segmax.py:55"),
        "wastage": ("src/repro_torch/kernels/csrc/wastage.cu", "src/repro/kernels/wastage.py:77"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": counts[name],
         **per_kernel[name], "library_ms": None}
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

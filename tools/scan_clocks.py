"""The scan kernels' phase clocks, the card's add latency, and the scan's
device time at the predict phase's calls across source trees.

    python tools/scan_clocks.py                      # add latency, SM clock, phase clocks
    python tools/scan_clocks.py --trees OLD NEW      # device ms of each tree's scan, in turns
    python tools/scan_clocks.py --trees OLD NEW --grid   # and the Fig. 7 grid's warm wall

The first form builds ``csrc/scan.cu`` with ``-DSCAN_CLOCKS`` and runs each
kernel once at every call of ``chip_smoke.scan_shapes`` (L 4, B 1,536, k 4),
f32 and f64, printing the clock64 cycles (and microseconds at the measured
SM clock) of each phase in one thread of the launch's middle block; XLA's
order is also forced onto ``xla_kernel`` (a block a line, the earlier
design).  The second times ``chip_smoke.scan_timings`` (every kernel in the
profiled window) with each tree's ``src`` first on the path, in the order
OLD, NEW, NEW, OLD, in a process each.  Both print one JSON object a line.
They need a CUDA card and ``nvcc``; libraries go to the kernels' build
directory.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
L, B, K = 4, 1536, 4  # the grid's largest bucket: lanes, executions, segments

# A chain of dependent adds in one thread, timed with clock64, and the SM
# clock from clock64 against the global nanosecond timer.
LATENCY_CU = r"""
#include <cuda_runtime.h>

template <typename T>
__global__ void chain(T* x, long long* cycles, int n) {
  T a = x[0];
  const T b = x[1];
  const long long t0 = clock64();
#pragma unroll 64
  for (int i = 0; i < n; ++i) a = a + b;
  const long long t1 = clock64();
  x[2] = a;
  cycles[0] = t1 - t0;
}

__global__ void sm_clock(long long* out, long long ns) {
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  } while (g1 - g0 < ns);
  out[0] = clock64() - c0;
  out[1] = g1 - g0;
}

extern "C" int add_cycles(int dtype, int n, void* x, long long* cycles) {
  if (dtype == 0) chain<float><<<1, 1>>>((float*)x, cycles, n);
  else chain<double><<<1, 1>>>((double*)x, cycles, n);
  return (int)cudaGetLastError();
}

extern "C" int clock_ratio(long long* out, long long ns) {
  sm_clock<<<1, 1>>>(out, ns);
  return (int)cudaGetLastError();
}
"""

# Phase names of each kernel's clock slots (csrc/scan.cu)
SLOTS = {
    "chain_kernel": ("chain: wait for and read the next chunk", "chain: the adds and writing the sums",
                     "copy warps: wait for a chunk to land", "copy warps: wait for the chain two chunks back",
                     "copy warps: issue the next chunk", "store warps: wait for the sums",
                     "store warps: store them"),
    "line_kernel": ("copy in and level 0", "level 1 (shuffles)", "level 2 and the prefixes", "copy out"),
    "tile_kernel": ("loads and level 0", "barrier 1", "levels (warp 0)", "barrier 2", "prefixes and stores"),
    "xla_kernel": ("loads", "the levels (fold_levels)", "prefixes and stores"),
}


def _library(name: str, source: Path | str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    text = source.read_text() if isinstance(source, Path) else source
    flags = (*build.nvcc_flags("scan"), *defines, "-I", str(build.CSRC))
    digest = hashlib.sha256(text.encode())
    for header in sorted(build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    out = build.BUILD_DIR / "tools" / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        run = subprocess.run([build._nvcc(), *flags, "-o", str(out), str(src)], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def add_latency() -> dict:
    """Cycles of one dependent f32 and f64 add on the card (a chain of 65,536
    in one thread, less a chain of 64 for the clock reads' own cost), and
    the SM clock in Hz over 20 ms."""
    import torch

    lib = _library("add_latency", LATENCY_CU)
    lib.add_cycles.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.clock_ratio.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    out = {}
    cycles = torch.zeros(2, dtype=torch.int64, device="cuda")
    for code, dtype in enumerate((torch.float32, torch.float64)):
        x = torch.tensor([1.0, 1e-30, 0.0], dtype=dtype, device="cuda")
        counts = []
        for n in (64, 65_536 + 64):
            for _ in range(3):  # the last of three: warm instruction cache
                if lib.add_cycles(code, n, x.data_ptr(), cycles.data_ptr()):
                    raise RuntimeError("add latency launch failed")
            torch.cuda.synchronize()
            counts.append(int(cycles[0]))
        out[str(dtype)[6:]] = (counts[1] - counts[0]) / 65_536
    if lib.clock_ratio(cycles.data_ptr(), 20_000_000):
        raise RuntimeError("clock launch failed")
    torch.cuda.synchronize()
    out["sm_hz"] = int(cycles[0]) / int(cycles[1]) * 1e9
    return out


def _kernel_of(shape, dim, sequential, path) -> str:
    """The kernel ``scan_launch_path`` runs (``csrc/scan.cu``'s ``launch``)."""
    import math

    import torch

    n, inner = shape[dim], math.prod(shape[dim + 1:])
    cols = math.prod(shape[:dim]) * inner
    if sequential:
        return "chain_kernel"
    if path == -1 and n <= 2048 and (inner == 1 or cols < 32 * torch.cuda.get_device_properties(0).multi_processor_count):
        return "line_kernel"
    return "tile_kernel" if path == -1 and inner > 1 else "xla_kernel"


def phase_clocks() -> list[dict]:
    """One launch of each kernel at each call, clocks of its phases."""
    import math

    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import _same_bits, _scan_rows, scan_shapes
    from repro_torch.kernels import scan

    lib = _library("scan_clocks", ROOT / "src/repro_torch/kernels/csrc/scan.cu", ("-DSCAN_CLOCKS",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scan_launch_path.argtypes = [p, i, i, i, i, i, p, p, p, i]
    lib.scan_clocks.argtypes = [p]
    hz = add_latency()["sm_hz"]
    slots = (ctypes.c_longlong * 8)()
    rows = []
    for name, shape, dim, sequential in scan_shapes(L, B, K):
        outer, n, inner = math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:])
        for dtype in (torch.float32, torch.float64):
            a = _scan_rows(shape, dtype, n + len(name), "cuda")
            block = n if sequential else scan.XLA_SCAN_BLOCK
            want = scan.prefix_sum_plain(a, dim, block)
            for path in (-1,) if sequential else (-1, 0):
                got = torch.empty_like(a)
                stream = torch.cuda.current_stream().cuda_stream
                for _ in range(2):  # warm, then the clocked launch
                    lib.scan_clocks(slots)
                    err = lib.scan_launch_path(a.data_ptr(), outer, n, inner, int(sequential), 0 if dtype == torch.float32
                                               else 1, got.data_ptr(), None, stream, path)
                    if err:
                        raise RuntimeError(f"scan_launch_path failed with CUDA error {err}")
                    torch.cuda.synchronize()
                lib.scan_clocks(slots)
                kernel = _kernel_of(shape, dim, sequential, path)
                cyc = {ph: slots[j] for j, ph in enumerate(SLOTS[kernel])}
                rows.append(dict(call=name, shape=list(shape), axis=dim, dtype=str(dtype)[6:], kernel=kernel,
                                 bitwise=_same_bits(got, want), cycles=cyc,
                                 us={ph: c / hz * 1e6 for ph, c in cyc.items()}))
    return rows


def _time_tree(tree: str, grid: bool) -> dict:
    """The tree's scan at every call (profiled device ms) and, with grid,
    the Fig. 7 grid's warm wall as ``chip_smoke.py`` runs it (s, the
    median of three, after a cold run)."""
    import statistics

    import torch

    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke

    got = chip_smoke.scan_timings(L, B, K, torch.device("cuda"), kernels="")
    out = {"device_ms": {f"{name} {str(dtype)[6:]}": row["device_ms"] for (name, dtype), row in got.items()}}
    if grid:
        from repro_torch.core.ksegments import KSegmentsConfig
        from repro_torch.sim.batch_engine import simulate_grid
        from repro_torch.sim.simulator import SimConfig
        from repro_torch.sim.traces import generate_suite

        wfs = generate_suite(seed=0, scale=chip_smoke.CORPUS_SCALE)
        cfg = SimConfig(min_executions=20, ksegments=KSegmentsConfig(k=4, error_mode="insample", insample_window=64))
        chip_smoke._wall(lambda: simulate_grid(wfs, cfg=cfg))
        out["grid_warm_s"] = statistics.median(chip_smoke._wall(lambda: simulate_grid(wfs, cfg=cfg))[1] for _ in range(3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), help="time two source trees' scan in turns")
    ap.add_argument("--grid", action="store_true", help="with --trees: also the Fig. 7 grid's warm wall")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_clocks: no CUDA device is available", file=sys.stderr)
        return 2
    if args.time_tree:
        print(json.dumps({"tree": args.time_tree, **_time_tree(args.time_tree, args.grid)}))
        return 0
    if args.trees:
        old, new = args.trees
        for tree in (old, new, new, old):
            cmd = [sys.executable, __file__, "--time-tree", tree] + (["--grid"] if args.grid else [])
            run = subprocess.run(cmd, capture_output=True, text=True)
            if run.returncode:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                return run.returncode
            print(run.stdout.strip().splitlines()[-1])
        return 0
    print(json.dumps({"add_latency": add_latency()}))
    for row in phase_clocks():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

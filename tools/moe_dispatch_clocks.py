"""The MoE dispatch kernel's device time at ``chip_smoke.MOE_CASES``, the
card's write and copy rates, and the kernel's phase clocks.

    python tools/moe_dispatch_clocks.py                   # this tree: times, rates, phase clocks
    python tools/moe_dispatch_clocks.py --trees OLD NEW   # each tree's dispatch, in turns

The first form times this tree's ``moe_dispatch_cuda`` at every shape of
``chip_smoke.MOE_CASES`` (the inputs ``chip_smoke._moe_case`` makes): bit
for bit against ``moe_dispatch_plain``, the mean over back-to-back calls
(CUDA events), the profiled device time of each kernel a call launches (by
name), ``index_select`` of the same rows given a slot table (the table's
making not timed), and both byte counts of the bound: every row of x, and
only the rows of tokens with a kept assignment.  Beside them it times the
card's write rate (``buf.zero_()`` over the prefill's ``buf``) and copy rate
(``torch.empty_like(buf).copy_(buf)``), then builds the kernel with
``-DMOE_CLOCKS`` and prints, at each shape, the clock64 cycles of each
phase in thread 0 of the launch's middle block (in microseconds at the SM
clock of ``tools/scan_clocks.py``), each block's end by the global timer
with its rows, and that build's back-to-back time.  The second form times each tree in a process of
its own, its ``src`` first on the path, in the order OLD, NEW, NEW, OLD.
Both print one JSON object a line.  They need a CUDA card and ``nvcc``.
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
REPS, SMALL_REPS, PROF_CALLS = 20, 200, 64

# Per-block stats of csrc/moe_dispatch.cu (MOE_CLOCKS: kStatBlocks, kStats)
STAT_BLOCKS = 1024
STATS = ("start_ns", "ranked_ns", "end_ns", "stores", "zero_rows")
# Phase names of the clock slots of csrc/moe_dispatch.cu (MOE_CLOCKS)
SLOTS = ("count the ids outside the range", "count the range", "offsets, totals, zero shares", "rank the range",
         "the copies (the ring and the zero rows, to the last wait)")


def _blocks(stats) -> dict:
    """The clocked launch's blocks: when each was ranked and ended (us
    after the first block's start, by the global timer), the spread of
    those ends, and the latest blocks with their bulk stores and zero
    rows."""
    import statistics

    rows = [dict(zip(STATS, stats[b * len(STATS):(b + 1) * len(STATS)])) for b in range(STAT_BLOCKS)]
    rows = [dict(r, block=b) for b, r in enumerate(rows) if r["start_ns"] > 0]
    t0 = min(r["start_ns"] for r in rows)
    for r in rows:
        r["end_us"] = (r["end_ns"] - t0) / 1e3
    ends = sorted(r["end_us"] for r in rows)
    late = sorted(rows, key=lambda r: -r["end_us"])[:6]
    return dict(n=len(rows), start_spread_us=(max(r["start_ns"] for r in rows) - t0) / 1e3,
                ranked_us=statistics.median((r["ranked_ns"] - t0) / 1e3 for r in rows),
                end_us={"min": ends[0], "median": statistics.median(ends), "max": ends[-1]},
                stores=sum(r["stores"] for r in rows), zero_rows=sum(r["zero_rows"] for r in rows),
                latest=[{k: r[k] for k in ("block", "stores", "zero_rows", "end_us")} for r in late],
                earliest=[{k: r[k] for k in ("block", "stores", "zero_rows", "end_us")}
                          for r in sorted(rows, key=lambda r: r["end_us"])[:3]])


def _case(N: int, k: int, E: int, C: int, D: int, skew: float, dev):
    """``chip_smoke._moe_case``'s dispatch inputs: bf16 rows, ids from
    biased random logits."""
    import torch

    g = torch.Generator(device=dev).manual_seed(N + E)
    logits = torch.randn((N, E), generator=g, device=dev) - skew * torch.arange(E, device=dev) / E
    top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    ids = top.indices[:, :k].to(torch.int32).contiguous()
    x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    return x, ids


def _per_kernel(call, n: int) -> dict[str, float]:
    """Profiled device ms of each kernel name over ``n`` calls, a launch
    (the profiler drops a window's first device events)."""
    import chip_smoke

    prof = chip_smoke._profile(lambda: [call() for _ in range(n)])
    return {name: ms / cnt for name, (ms, cnt) in prof["top_all"]}


def time_tree() -> dict:
    """This process's ``repro_torch`` dispatch at every case."""
    import torch

    import chip_smoke
    from repro_torch.kernels import moe_dispatch

    dev = torch.device("cuda")
    out = {"kernel_source": str(Path(moe_dispatch.__file__).resolve().parent / "csrc" / "moe_dispatch.cu"), "cases": {}}
    for name, N, k, E, C, D, skew in chip_smoke.MOE_CASES:
        x, ids = _case(N, k, E, C, D, skew, dev)
        buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
        want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
        bitwise = torch.equal(pos, want_pos) and torch.equal(buf.view(torch.int16), want_buf.view(torch.int16))
        kept = (pos >= 0) & (pos < C)
        rows_read = int(kept.any(-1).sum())
        tok = torch.arange(N, device=dev)[:, None].expand(N, k)
        slot = torch.full((E * C,), N, dtype=torch.int64, device=dev)
        slot[(ids.long() * C + pos.long())[kept]] = tok[kept]
        xz = torch.cat([x, torch.zeros((1, D), dtype=x.dtype, device=dev)])
        reps = REPS if N > 64 else SMALL_REPS
        call = lambda: moe_dispatch.moe_dispatch_cuda(x, ids, E, C)  # noqa: E731
        small = 4 * (ids.numel() + pos.numel())
        out["cases"][name] = dict(
            bitwise=bitwise, kept=int(kept.sum()), dropped=N * k - int(kept.sum()), rows_read=rows_read,
            ms=chip_smoke._cuda_ms(call, reps), device_ms=_per_kernel(call, max(reps, PROF_CALLS)),
            index_select_ms=chip_smoke._cuda_ms(lambda: torch.index_select(xz, 0, slot), reps),
            bytes_all_rows=2 * (buf.numel() + x.numel()) + small,
            bytes_kept_rows=2 * (buf.numel() + rows_read * D) + small)
        del buf, want_buf, xz
    torch.cuda.empty_cache()
    return out


def rates() -> dict:
    """The card's write rate (``buf.zero_()``) and copy rate
    (``torch.empty_like(buf).copy_(buf)``, a read and a write a byte) over
    the prefill's buf."""
    import torch

    import chip_smoke

    _, N, k, E, C, D, _ = chip_smoke.MOE_CASES[0]
    buf = torch.empty((E, C, D), dtype=torch.bfloat16, device="cuda")
    nbytes = buf.numel() * buf.element_size()
    zero_ms = chip_smoke._cuda_ms(buf.zero_, REPS)
    copy_ms = chip_smoke._cuda_ms(lambda: torch.empty_like(buf).copy_(buf), REPS)
    return dict(buf_bytes=nbytes, zero_ms=zero_ms, write_tb_s=nbytes / zero_ms / 1e9, copy_ms=copy_ms,
                copy_tb_s=2 * nbytes / copy_ms / 1e9)


def _clock_library() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    source = build.CSRC / "moe_dispatch.cu"
    flags = (*build.nvcc_flags("moe_dispatch"), "-DMOE_CLOCKS")
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    out = build.BUILD_DIR / "tools" / f"libmoe_dispatch_clocks-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        run = subprocess.run([build._nvcc(), *flags, "-o", str(out), str(source)], capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on moe_dispatch.cu -DMOE_CLOCKS:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def phase_clocks() -> list[dict]:
    """One clocked launch at each case, after a warm one: the cycles of
    each phase in thread 0 of the launch's middle block, each block's
    stats, and the clocked build's mean time over back-to-back launches."""
    import torch

    import chip_smoke
    from repro_torch.kernels import moe_dispatch

    sys.path.insert(0, str(ROOT / "tools"))
    from scan_clocks import add_latency

    lib = _clock_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch_launch.argtypes = [p, i, i, p, i, i, i, p, p, p, p]
    lib.moe_dispatch_launch.restype = i
    lib.moe_dispatch_clocks.argtypes = [p]
    hz = add_latency()["sm_hz"]
    lib.moe_dispatch_block_stats_read.argtypes = [p]
    slots = (ctypes.c_longlong * len(SLOTS))()
    stats = (ctypes.c_longlong * (STAT_BLOCKS * len(STATS)))()
    rows = []
    dev = torch.device("cuda")
    for name, N, k, E, C, D, skew in chip_smoke.MOE_CASES:
        x, ids = _case(N, k, E, C, D, skew, dev)
        pos = torch.empty((N, k), dtype=torch.int32, device=dev)
        buf = torch.empty((E, C, D), dtype=x.dtype, device=dev)
        pool = torch.zeros(2, dtype=torch.int32, device=dev)

        def launch():
            err = lib.moe_dispatch_launch(x.data_ptr(), N, D * x.element_size(), ids.data_ptr(), k, E, C,
                                          pos.data_ptr(), buf.data_ptr(), pool.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"moe_dispatch_launch failed with CUDA error {err}")

        ms = chip_smoke._cuda_ms(launch, REPS if N > 64 else SMALL_REPS)
        for _ in range(2):  # warm, then the clocked launch
            lib.moe_dispatch_clocks(slots)
            launch()
            torch.cuda.synchronize()
        lib.moe_dispatch_block_stats_read(stats)
        lib.moe_dispatch_clocks(slots)
        want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
        cyc = {ph: slots[j] for j, ph in enumerate(SLOTS)}
        rows.append(dict(case=name, clocked_build_ms=ms, sm_hz=hz, bitwise=torch.equal(pos, want_pos)
                         and torch.equal(buf.view(torch.int16), want_buf.view(torch.int16)),
                         cycles=cyc, us={ph: c / hz * 1e6 for ph, c in cyc.items()}, blocks=_blocks(stats)))
        del buf, want_buf
    torch.cuda.empty_cache()
    return rows


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), help="time two source trees' dispatch in turns")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("moe_dispatch_clocks: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.time_tree:
        sys.path.insert(0, str(Path(args.time_tree).resolve() / "src"))
        print(json.dumps({"tree": args.time_tree, **time_tree()}))
        return 0
    print(json.dumps({"card": _card(), "torch": torch.__version__, "cuda": torch.version.cuda}))
    if args.trees:
        old, new = args.trees
        for tree in (old, new, new, old):
            run = subprocess.run([sys.executable, __file__, "--time-tree", tree], capture_output=True, text=True)
            if run.returncode:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                return run.returncode
            print(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"rates": rates()}))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(time_tree()))
    print(json.dumps({"rates": rates()}))
    for row in phase_clocks():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

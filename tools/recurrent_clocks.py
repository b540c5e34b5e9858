"""The WKV and RG-LRU kernels' device time at ``chip_smoke.WKV_CASES`` and
``chip_smoke.RGLRU_CASES``.

    python tools/recurrent_clocks.py                   # this tree's two kernels
    python tools/recurrent_clocks.py --trees OLD NEW   # each tree's kernels, in turns
    python tools/recurrent_clocks.py --parts           # the WKV kernel without its parts

The first form times this tree's ``rwkv_wkv_cuda`` and ``rglru_scan_cuda``
at every case, on the inputs ``chip_smoke._wkv_args`` / ``_rglru_args``
make: checked against the plain version (WKV within ``chip_smoke.WKV_TOL``
of max |o| and of max |S|, RG-LRU bit for bit), the mean over back-to-back
calls (CUDA events), the profiled device time a call and the device
launches a call (``chip_smoke._device_ms`` / ``_device_launches``), beside
the bound.  The third builds the WKV kernel again without its products
(``-DWKV_WITHOUT_PRODUCTS``), without its copies and stores of o
(``-DWKV_WITHOUT_COPIES``) and without both, and times each build beside
the whole kernel at every prefill case (CUDA events; the parts left out
give wrong results and are not checked).  The second form times each tree in a process of its own, its
``src`` first on the path, in the order OLD, NEW, NEW, OLD; OLD is a
checkout of another commit (``git archive``).  Both print one JSON object a
line.  They need a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROF_CALLS = 64


def _case(kernel: str, args: tuple, nbytes: float, nops: float) -> dict:
    import torch

    import chip_smoke
    from repro_torch.kernels import rglru_scan, rwkv_wkv

    if kernel == "rwkv_wkv":
        call, plain = (lambda: rwkv_wkv.rwkv_wkv_cuda(*args)), (lambda: rwkv_wkv.wkv_plain(*args))
    else:
        call, plain = (lambda: rglru_scan.rglru_scan_cuda(*args)), (lambda: rglru_scan.rglru_scan_plain(*args))
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for g, w in zip(got, want)]
    ok = all(torch.equal(g, w) for g, w in zip(got, want)) if kernel == "rglru_scan" else max(err) <= chip_smoke.WKV_TOL
    device_name = chip_smoke.RECURRENT_KERNELS[kernel]
    launched = chip_smoke._device_launches(call, PROF_CALLS)
    bound_ms, bound_by = chip_smoke._bound(nbytes, nops)
    device_ms = chip_smoke._device_ms(call, device_name, PROF_CALLS)
    return dict(ok=ok, rel_err=err, ms=chip_smoke._cuda_ms(call, 20 if nbytes > 1e8 else 200), device_ms=device_ms,
                launches_a_call=sum(launched.values()) / PROF_CALLS,
                only_its_kernel=all(device_name in name for name in launched), bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / device_ms)


def time_tree() -> dict:
    """This process's ``repro_torch`` kernels at every case."""
    import torch

    import chip_smoke
    from repro_torch.kernels import rwkv_wkv

    dev = torch.device("cuda")
    out = {"kernel_dir": str(Path(rwkv_wkv.__file__).resolve().parent / "csrc"), "rwkv_wkv": {}, "rglru_scan": {}}
    for name, B, T, H, stateful in chip_smoke.WKV_CASES:
        out["rwkv_wkv"][name] = _case("rwkv_wkv", *chip_smoke._wkv_args(B, T, H, stateful, dev))
        torch.cuda.empty_cache()
    for name, B, T, R, stateful in chip_smoke.RGLRU_CASES:
        out["rglru_scan"][name] = _case("rglru_scan", *chip_smoke._rglru_args(B, T, R, stateful, dev))
        torch.cuda.empty_cache()
    return out


PARTS = {"whole": (), "without products": ("-DWKV_WITHOUT_PRODUCTS",),
         "without copies": ("-DWKV_WITHOUT_COPIES",),
         "without both": ("-DWKV_WITHOUT_PRODUCTS", "-DWKV_WITHOUT_COPIES")}


def parts() -> dict:
    """The WKV kernel built with each of ``PARTS``' flags, timed at every
    prefill case of ``WKV_CASES``."""
    import ctypes
    import hashlib

    import torch

    import chip_smoke
    from repro_torch.kernels import build

    source = build.CSRC / "rwkv_wkv.cu"
    libs = {}
    for name, extra in PARTS.items():
        flags = (*build.nvcc_flags("rwkv_wkv"), *extra)
        digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out = build.BUILD_DIR / "tools" / f"librwkv_wkv_parts-{digest}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            run = subprocess.run([build._nvcc(), *flags, "-o", str(out), str(source)], capture_output=True, text=True)
            if run.returncode:
                raise RuntimeError(f"nvcc failed on rwkv_wkv.cu {' '.join(extra)}:\n{run.stdout}{run.stderr}")
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_wkv_launch.argtypes = [p] * 6 + [i, i, i, p, p, p]
        lib.rwkv_wkv_launch.restype = i
        libs[name] = lib
    rows = {}
    for case, B, T, H, stateful in chip_smoke.WKV_CASES:
        if T == 1:
            continue
        args, _, _ = chip_smoke._wkv_args(B, T, H, stateful, torch.device("cuda"))
        o, S = torch.empty_like(args[0]), torch.empty_like(args[5])
        rows[case] = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.rwkv_wkv_launch(*(t.data_ptr() for t in args), B, T, H, o.data_ptr(), S.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"rwkv_wkv_launch failed with CUDA error {err}")

            rows[case][name] = chip_smoke._cuda_ms(launch, 20)
        del args, o, S
        torch.cuda.empty_cache()
    return rows


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), help="time two source trees' kernels in turns")
    ap.add_argument("--parts", action="store_true", help="time the WKV kernel without its products or copies")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("recurrent_clocks: no CUDA device is available", file=sys.stderr)
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
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    if args.parts:
        print(json.dumps({"parts_ms": parts()}))
        return 0
    print(json.dumps(time_tree()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

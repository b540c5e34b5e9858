"""The WKV and RG-LRU kernels' device time at ``chip_smoke.WKV_CASES`` and
``chip_smoke.RGLRU_CASES``, and their backward kernels' at the same cases
(phase 16 (k)'s).

    python tools/recurrent_clocks.py                   # this tree's kernels
    python tools/recurrent_clocks.py --trees OLD NEW   # each tree's kernels, in turns
    python tools/recurrent_clocks.py --parts           # what each design leaves on the table

The first form times this tree's ``rwkv_wkv_cuda`` and ``rglru_scan_cuda``
at every case, on the inputs ``chip_smoke._wkv_args`` / ``_rglru_args``
make: checked against the plain version (WKV within ``chip_smoke.WKV_TOL``
of max |o| and of max |S|, RG-LRU bit for bit), the mean over back-to-back
calls (CUDA events), the profiled device time a call and the device
launches a call (``chip_smoke._device_ms`` / ``_device_launches``), beside
the bound, and a digest of the outputs' bytes (two trees' forwards are the
same bit for bit where their digests are); the WKV forward also with its
checkpoint output, where the tree has one.  Then ``rwkv_wkv_bwd_cuda``
(fed by the forward's checkpoints, where the tree's takes them) and
``rglru_scan_bwd_cuda`` at every case, checked once against their plain
versions (WKV within ``chip_smoke.WKV_TOL`` of each output's max |plain|,
RG-LRU bit for bit, with a digest) and against a second run (bit for
bit), timed back to back and profiled launch by launch (each device
kernel's mean time and launches a call, by name, whatever the tree's
kernels are called).  The second form times each tree in a process of its own, its
``src`` first on the path, in the order OLD, NEW, NEW, OLD; OLD is a
checkout of another commit (``git archive``).  The third builds the WKV
kernels again without their products (``-DWKV_WITHOUT_PRODUCTS``),
without their copies and stores (``-DWKV_WITHOUT_COPIES``) and without
both, and times each build beside the whole kernel at every prefill case
(CUDA events; the parts left out give wrong results and are not checked):
the forward, and the backward's three launches; then the RG-LRU backward,
timed and checked bit for bit, and built with ``-DRGLRU_CLOCKS``, whose
chain warps count their cycles in all and waiting on the ring, a token.  All print one JSON object a line.
They need a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROF_CALLS = 64


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _takes_ckpt(fn) -> bool:
    return "ckpt" in inspect.signature(fn).parameters


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
    out = dict(ok=ok, rel_err=err, digest=_digest(got))
    device_name = chip_smoke.RECURRENT_KERNELS[kernel]
    launched = chip_smoke._device_launches(call, PROF_CALLS)
    bound_ms, bound_by = chip_smoke._bound(nbytes, nops)
    device_ms = chip_smoke._device_ms(call, device_name, PROF_CALLS)
    reps = 20 if nbytes > 1e8 else 200
    out.update(ms=chip_smoke._cuda_ms(call, reps), device_ms=device_ms,
               launches_a_call=sum(launched.values()) / PROF_CALLS,
               only_its_kernel=all(device_name in name for name in launched), bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / device_ms)
    if kernel == "rwkv_wkv" and _takes_ckpt(rwkv_wkv.rwkv_wkv_cuda):
        B, T, H, _ = args[0].shape
        ckpt = torch.empty(rwkv_wkv.checkpoint_shape(B, T, H), device=args[0].device)
        with_ckpt = lambda: rwkv_wkv.rwkv_wkv_cuda(*args, ckpt)  # noqa: E731
        out.update(same_with_ckpt=all(torch.equal(g, w) for g, w in zip(got, with_ckpt())),
                   ms_with_ckpt=chip_smoke._cuda_ms(with_ckpt, reps),
                   device_ms_with_ckpt=chip_smoke._device_ms(with_ckpt, device_name, PROF_CALLS))
    return out


def _launch_parts(call, n: int = PROF_CALLS) -> dict:
    """Each device kernel ``call()`` launches, by name: its mean profiled
    time a launch and its launches a call (the window opens with 64 fills,
    in the place of the first device events the profiler drops)."""
    import torch

    import chip_smoke

    pad = torch.empty(1, device="cuda")

    def run():
        for _ in range(64):
            pad.fill_(0.0)
        for _ in range(n):
            call()

    parts = {}
    for name, (ms, count) in chip_smoke._profile(run)["top_all"]:
        if "FillFunctor" in name:
            continue
        short = re.search(r"(\w+_kernel)", name)
        parts[short.group(1) if short else name] = [ms / count, count / n]
    return parts


def _bwd_case(kernel: str, B: int, T: int, W: int, stateful: bool) -> dict:
    """A backward kernel at one case: its error against the plain version,
    whether two runs agree, CUDA-event ms and each launch's profiled ms."""
    import torch

    import chip_smoke
    from repro_torch.kernels import rglru_scan, rglru_scan_bwd, rwkv_wkv, rwkv_wkv_bwd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B * T + W + 1)
    if kernel == "rwkv_wkv_bwd":
        args, _, _ = chip_smoke._wkv_args(B, T, W, stateful, dev)
        grads = (torch.randn(args[0].shape, generator=g, device=dev), torch.randn(args[5].shape, generator=g,
                                                                                   device=dev))
        kw = {}
        if _takes_ckpt(rwkv_wkv_bwd.rwkv_wkv_bwd_cuda):  # the forward's checkpoints, as the train step has them
            kw["ckpt"] = torch.empty(rwkv_wkv.checkpoint_shape(B, T, W), device=dev)
            rwkv_wkv.rwkv_wkv_cuda(*args, kw["ckpt"])
        call, plain = (lambda: rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, *grads, **kw)), (
            lambda: rwkv_wkv_bwd.wkv_bwd_plain(*args, *grads))
    else:
        (a, b, h0), _, _ = chip_smoke._rglru_args(B, T, W, stateful, dev)
        h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
        grads = (torch.randn(a.shape, generator=g, device=dev), torch.randn(h0.shape, generator=g, device=dev))
        call, plain = (lambda: rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, *grads)), (
            lambda: rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, *grads))
    got, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    err = [(x - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for x, w in zip(got, want)]
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = same and (all(torch.equal(x, w) for x, w in zip(got, want)) if kernel == "rglru_scan_bwd"
                   else max(err) <= chip_smoke.WKV_TOL)
    out = dict(ok=ok, rel_err=err, run_to_run=same, digest=_digest(got))
    del got, again, want
    parts = _launch_parts(call)
    out.update(ms=chip_smoke._cuda_ms(call, 20 if T > 1 else 200), parts=parts,
               device_ms=sum(ms * n for ms, n in parts.values()))
    return out


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
    for kernel, cases in (("rwkv_wkv_bwd", chip_smoke.WKV_CASES), ("rglru_scan_bwd", chip_smoke.RGLRU_CASES)):
        out[kernel] = {name: _bwd_case(kernel, *case) for name, *case in cases}
        torch.cuda.empty_cache()
    return out


def _variant(name: str, extra: tuple[str, ...]):
    """``csrc/<name>.cu`` built with ``extra`` flags into a library of its
    own (named by the source, the headers and the flags)."""
    import ctypes

    from repro_torch.kernels import build

    flags = (*build.nvcc_flags(name), *extra)
    h = hashlib.sha256((build.CSRC / f"{name}.cu").read_bytes())
    for header in sorted(build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    out = build.BUILD_DIR / "tools" / f"lib{name}_variant-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        run = subprocess.run([build._nvcc(), *flags, "-o", str(out), str(build.CSRC / f"{name}.cu")],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu {' '.join(extra)}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


PARTS = {"whole": (), "without products": ("-DWKV_WITHOUT_PRODUCTS",),
         "without copies": ("-DWKV_WITHOUT_COPIES",),
         "without both": ("-DWKV_WITHOUT_PRODUCTS", "-DWKV_WITHOUT_COPIES")}


def parts() -> dict:
    """The WKV forward and backward built with each of ``PARTS``' flags,
    timed at every prefill case of ``WKV_CASES`` (the backward launch by
    launch, profiled); the RG-LRU backward's chain clocks at every prefill
    case of ``RGLRU_CASES``."""
    import ctypes

    import torch

    import chip_smoke
    from repro_torch.kernels import rwkv_wkv

    p, i = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = {}, {}
    for name, extra in PARTS.items():
        fwd[name] = _variant("rwkv_wkv", extra).rwkv_wkv_launch
        fwd[name].argtypes, fwd[name].restype = [p] * 6 + [i, i, i, p, p, p, p], i
        bwd[name] = _variant("rwkv_wkv_bwd", extra).rwkv_wkv_bwd_launch
        bwd[name].argtypes, bwd[name].restype = [p] * 9 + [i, i, i] + [p] * 9, i
    rows = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for case, B, T, H, stateful in chip_smoke.WKV_CASES:
        if T == 1:
            continue
        args, _, _ = chip_smoke._wkv_args(B, T, H, stateful, torch.device("cuda"))
        ptrs = [t.data_ptr() for t in args]
        o, S = torch.empty_like(args[0]), torch.empty_like(args[5])
        ckpt = torch.empty(rwkv_wkv.checkpoint_shape(B, T, H), device="cuda")
        rwkv_wkv.rwkv_wkv_cuda(*args, ckpt)
        do, dS = torch.randn_like(args[0]), torch.randn_like(args[5])
        grads = [torch.empty_like(args[0]) for _ in range(4)]
        du, dS0, dS_ck = torch.empty_like(args[4]), torch.empty_like(S), torch.empty_like(ckpt)
        du_part = torch.empty((B * H * ckpt.shape[2], 64), device="cuda")
        rows[case] = {"forward": {}, "backward": {}}
        for name in PARTS:
            def launch_fwd(fn=fwd[name]):
                if fn(*ptrs, B, T, H, o.data_ptr(), S.data_ptr(), None, stream()):
                    raise RuntimeError("rwkv_wkv_launch failed")

            def launch_bwd(fn=bwd[name]):
                if fn(*ptrs, do.data_ptr(), dS.data_ptr(), ckpt.data_ptr(), B, T, H,
                      *(t.data_ptr() for t in grads), du.data_ptr(), dS0.data_ptr(), dS_ck.data_ptr(),
                      du_part.data_ptr(), stream()):
                    raise RuntimeError("rwkv_wkv_bwd_launch failed")

            rows[case]["forward"][name] = chip_smoke._cuda_ms(launch_fwd, 20)
            rows[case]["backward"][name] = dict(ms=chip_smoke._cuda_ms(launch_bwd, 20), parts=_launch_parts(launch_bwd))
        del args, o, S, ckpt, do, dS, grads, dS_ck
        torch.cuda.empty_cache()
    return {"wkv_parts_ms": rows, "rglru_bwd_chain": _rglru_clocks()}


def _rglru_clocks() -> dict:
    """The RG-LRU backward at every prefill case: the launch's time and the
    outputs against the plain version (bit for bit), and from a
    -DRGLRU_CLOCKS build its chain warps' cycles a token in all and waiting
    on the ring (the rest is the chain warp's own stream)."""
    import ctypes

    import torch

    import chip_smoke
    from repro_torch.kernels import rglru_scan, rglru_scan_bwd

    p, i = ctypes.c_void_p, ctypes.c_int
    lib, clocked = _variant("rglru_scan_bwd", ()), _variant("rglru_scan_bwd", ("-DRGLRU_CLOCKS",))
    for one in (lib, clocked):
        one.rglru_scan_bwd_launch.argtypes, one.rglru_scan_bwd_launch.restype = [p] * 5 + [i, i, i, p, p, p, p], i
    clocked.rglru_scan_bwd_clocks.argtypes, clocked.rglru_scan_bwd_clocks.restype = [p], i
    out = {}
    for case, B, T, R, stateful in chip_smoke.RGLRU_CASES:
        if T == 1:
            continue
        (a, b, h0), _, _ = chip_smoke._rglru_args(B, T, R, stateful, torch.device("cuda"))
        h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
        dh_seq, dh_last = torch.randn_like(a), torch.randn_like(h0)
        da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
        counts = (ctypes.c_ulonglong * 3)()
        want = rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)

        def launch(lib=lib):
            if lib.rglru_scan_bwd_launch(a.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), dh_seq.data_ptr(),
                                         dh_last.data_ptr(), B, T, R, da.data_ptr(), db.data_ptr(), dh0.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("rglru_scan_bwd_launch failed")

        ms = chip_smoke._cuda_ms(launch, 20)
        bitwise = all(torch.equal(x, y) for x, y in zip((da, db, dh0), want))
        clocked.rglru_scan_bwd_clocks(counts)  # zero
        launch(clocked)
        torch.cuda.synchronize()
        if clocked.rglru_scan_bwd_clocks(counts):
            raise RuntimeError("rglru_scan_bwd_clocks failed")
        cycles, waiting, tokens = (int(x) for x in counts)
        out[case] = dict(ms=ms, bitwise=bitwise, cycles_a_token=cycles / tokens, waiting_a_token=waiting / tokens,
                         own_a_token=(cycles - waiting) / tokens)
        del a, b, h0, h_seq, dh_seq, da, db
        torch.cuda.empty_cache()
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), help="time two source trees' kernels in turns")
    ap.add_argument("--parts", action="store_true", help="time the WKV kernels without their products or copies, "
                                                         "and count the RG-LRU backward's chain cycles")
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
        print(json.dumps({"parts": parts()}))
        return 0
    print(json.dumps(time_tree()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

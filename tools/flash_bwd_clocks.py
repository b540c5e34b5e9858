"""flash_bwd's device time at ``chip_smoke.BWD_CASES``, launch by launch.

    python tools/flash_bwd_clocks.py                   # this tree's kernel
    python tools/flash_bwd_clocks.py --trees OLD NEW   # each tree's kernel, in turns

The first form times this tree's ``flash_bwd_cuda`` in bf16 at every case,
on the inputs ``chip_smoke._flash_case_inputs`` makes and the forward
kernel's output and lse: checked against the tree's plain backward (within
``chip_smoke.BWD_TOL`` of max |plain| of dq, dk and dv), the mean over
back-to-back calls (CUDA events), the profiled device time a call, split
into the dK/dV launch, the dQ launch and the prep (the tile summaries, D
and, where the tree has it, E), and the device launches a call, beside
SDPA's backward on the same inputs (where there is no softcap; timed in the
same process) and the bound.  The second form times each tree in a process
of its own, its ``src`` first on the path, in the order OLD, NEW, NEW, OLD;
OLD is a checkout of another commit (``git archive``).  Both print one JSON
object a line.  They need a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROF_CALLS = 10


@functools.cache
def _roofline():
    """This checkout's ``repro_torch.launch.roofline``, loaded from its file:
    the bound is the tool's own, whichever tree's ``src`` is first on the
    path (trees older than the module have none)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_checkout_roofline", ROOT / "src/repro_torch/launch/roofline.py")
    mod = sys.modules.setdefault(spec.name, importlib.util.module_from_spec(spec))
    spec.loader.exec_module(mod)
    return mod


def _part(name: str) -> str:
    """The launch family of a flash_bwd kernel name (``chip_smoke.
    _bwd_device_ms``'s parts)."""
    return "dkv" if "_dkv" in name else "dq" if "_dq" in name else "prep"


def _case(case, seed: int, dev) -> dict:
    import torch

    import chip_smoke
    from repro_torch.kernels import flash, flash_bwd

    roofline = _roofline()
    name, (B, T, H, KV, hd), causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v, qp, kp = chip_smoke._flash_case_inputs(B, T, T, H, KV, hd, torch.bfloat16, seed, dev)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    dout = dout.to(torch.bfloat16)
    out, lse = flash.flash_attention_lse_cuda(q, k, v, qp, kp, **kw)
    call = lambda: flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, qp, kp, **kw)  # noqa: E731
    got = call()
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, qp, kp, **kw)
    torch.cuda.synchronize()
    err = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item() for a, b in zip(got, want)]
    del got, want
    ms = chip_smoke._cuda_ms(call, 10)
    device_ms, parts = chip_smoke._bwd_device_ms(call, PROF_CALLS)
    split = {"dkv": 0.0, "dq": 0.0, "prep": 0.0}
    for part, (t, n) in parts.items():
        split[_part(part)] += t / max(n, 1) * (2 if part.endswith("_tiles") else 1)
    mask = chip_smoke._flash_mask(qp, kp, causal, window)
    pairs = mask.sum().item() * H
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel() + 4 * (qp.numel() + kp.numel())
    bound_ms, bound_by = roofline.bound_ms(nbytes, 2.5 * 4 * hd * pairs, roofline.HW["peak_flops_bf16"])
    sdpa_ms = None if cap is not None else chip_smoke._sdpa_bwd_ms(q, k, v, dout, mask, causal, window, 10)[0]
    del mask
    torch.cuda.empty_cache()
    return dict(ok=max(err) <= chip_smoke.BWD_TOL["bfloat16"], rel_err=err, ms=ms, device_ms=device_ms,
                dkv_ms=split["dkv"], dq_ms=split["dq"], prep_ms=split["prep"],
                launches_a_call=sum(n for _, n in parts.values()) / PROF_CALLS,
                parts={p: [t, n] for p, (t, n) in parts.items()}, sdpa_bwd_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / device_ms)


def time_tree() -> dict:
    """This process's ``repro_torch`` flash_bwd at every case."""
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_bwd

    dev = torch.device("cuda")
    out = {"kernel_dir": str(Path(flash_bwd.__file__).resolve().parent / "csrc"), "cases": {}}
    for i, case in enumerate(chip_smoke.BWD_CASES):
        out["cases"][case[0]] = _case(case, 300 + i, dev)
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), help="time two source trees' kernels in turns")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_clocks: no CUDA device is available", file=sys.stderr)
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
    print(json.dumps(time_tree()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

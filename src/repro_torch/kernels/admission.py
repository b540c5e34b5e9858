"""The launch wrapper of ``csrc/admission.cu``: the batched admission
controller's decision scan in one launch.

No TPU kernel corresponds to it: it replaces the ``lax.scan`` of the
reference's ``admission_program`` (``repro/sim/device_timeline.py:374``).
Its plain version is ``sim.device_timeline.admission_scan_plain``;
``kernels.ops.admission_scan`` picks between the two by the tensors'
device.  The kernel's decisions are the plain version's, bit for bit.

Precondition: the probes ``P`` are sorted ascending (no NaN), as
``core.timeline.shared_probe_set`` returns them.  The kernel finds each
candidate's windows and splits on them by binary search and does not check
the order: on unsorted probes its decisions are undefined.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

PLAN_KEYS = ("tier", "threads", "chunk", "smem", "scratch")
TIERS = ("global", "registers")  # plan()["tier"] indexes this
_fns: dict = {}  # launcher name -> its ctypes function


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("admission"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "admission_plan": [i, i, i, p],
            "admission_launch": [p, p, i, p, p, p, p, p, p, p, p, p, i, i, ctypes.c_double, p, p, p],
        }[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def plan(Pp: int, C: int, k: int) -> dict[str, int]:
    """How a launch over Pp probes and C candidates of k segments runs:
    ``tier`` where each thread's consecutive probes keep their profile reads
    and ``extra`` (``TIERS[tier]``: registers, up to 8 probes a thread and
    8,192 probes; past that global memory, with ``extra`` in a scratch of
    ``scratch`` bytes), ``threads``, ``chunk`` candidates staged at a time
    and ``smem`` bytes of dynamic shared memory (the stage, and the probes
    for the first chunk's searches)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = _launcher("admission_plan")(Pp, C, k, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"admission: no launch plan for Pp={Pp}, C={C}, k={k} (CUDA error {err})")
    return dict(zip(PLAN_KEYS, out))


def admission_cuda(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget: float) -> torch.Tensor:
    """``admission_scan_plain`` on the card in one launch: the same
    arguments (float64, ``live`` and ``valid`` bool, all contiguous on one
    card; ``P`` sorted ascending) and the same admits (C,) bool."""
    global launches
    build.check_cuda("admission", P)
    dev = P.device
    Pp = P.shape[0]
    if bnd.dim() != 2 or bnd.shape[1] < 1:
        raise ValueError(f"admission: need (C, k) boundaries with k >= 1, got {tuple(bnd.shape)}")
    C, k = bnd.shape
    f64, b = torch.float64, torch.bool
    args = dict(P=(P, f64, (Pp,)), prof=(prof, f64, (Pp,)), starts=(starts, f64, (C,)), ends=(ends, f64, (C,)),
                rels=(rels, f64, (C,)), bnd=(bnd, f64, (C, k)), val=(val, f64, (C, k)),
                valext=(valext, f64, (C, k + 1)), sw=(sw, f64, (C, k)), live=(live, b, (C, k)),
                valid=(valid, b, (C,)))
    for name, (t, dtype, shape) in args.items():
        build.check_arg(f"admission {name}", t, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"admission {name}: need shape {shape}, got {tuple(t.shape)}")
    admits = torch.empty(C, dtype=torch.bool, device=dev)
    if C == 0:
        return admits
    scratch_bytes = plan(Pp, C, k)["scratch"]
    scratch = torch.empty(scratch_bytes // 8, dtype=f64, device=dev) if scratch_bytes else None
    err = _launcher("admission_launch")(
        P.data_ptr(), prof.data_ptr(), Pp, starts.data_ptr(), ends.data_ptr(), rels.data_ptr(), bnd.data_ptr(),
        val.data_ptr(), valext.data_ptr(), sw.data_ptr(), live.data_ptr(), valid.data_ptr(), C, k, float(budget),
        admits.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"admission launch failed with CUDA error {err}")
    launches += 1
    return admits

"""The launch wrapper of ``csrc/admission_epoch.cu``: one batch of the
sharded admission controller's carried epoch (releases, clock fold,
decisions, splice) for every shard in one launch.

No TPU kernel corresponds to it: it replaces the reference's carried program
``admission_epoch`` / ``_admission_shard``
(``repro/sim/device_timeline.py:1292``, ``:1080``).  Its plain version is
``sim.device_timeline.admission_epoch_plain``; ``kernels.ops.admission_epoch``
picks between the two by the tensors' device.  The kernel's decisions and
new state are the plain version's, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

PLAN_KEYS = ("threads", "smem", "scratch")
STATE = ("base0", "tl_t", "tl_d", "tl_c", "slot_fold")
_fns: dict = {}  # launcher name -> its ctypes function


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("admission_epoch"), name)
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = {
            "admission_epoch_plan": [i, i, i, i, i, p],
            "admission_epoch_launch": [p] * 13 + [i] * 7 + [d, d] + [p] * 8,
        }[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def plan(L: int, Lp: int, Smax: int, Cb: int, k: int) -> dict[str, int]:
    """How a launch runs at these sizes: ``threads`` a block (one block a
    shard), ``smem`` bytes of dynamic shared memory, and ``scratch`` bytes of
    global memory a shard (0: the working row, scans, probes and candidate
    tables all fit in shared memory)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = _launcher("admission_epoch_plan")(L, Lp, Smax, Cb, k, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"admission_epoch: no launch plan for L={L}, Lp={Lp}, Smax={Smax}, Cb={Cb}, k={k} "
                         f"(CUDA error {err})")
    return dict(zip(PLAN_KEYS, out))


def admission_epoch_cuda(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid,
                         t0: float, budget: float, Lp: int | None = None, out=None):
    """``admission_epoch_plain`` on the card in one launch.  State: base0
    (S,), tl_t/tl_d (S, L) float64, tl_c (S, L) int32, slot_fold (S, Smax)
    float64; batch: rel_codes (S, Rb) int32, starts/ends/rels (S, Cb),
    bnd/val (S, Cb, k) float64, codes (S, Cb) int32, valid (S, Cb) bool; all
    contiguous on one card.  ``out`` is a second set of state buffers the
    new state is written into (allocated when None; never the input's).

    Returns ``(res, base0, tl_t, tl_d, tl_c, slot_fold)``: res (S, Cb + 2)
    int32 holds each shard's admits, its overflow flag and its live count."""
    global launches
    build.check_cuda("admission_epoch", tl_t)
    dev = tl_t.device
    if tl_t.dim() != 2 or bnd.dim() != 3:
        raise ValueError(f"admission_epoch: need (S, L) rows and (S, Cb, k) plans, got {tuple(tl_t.shape)}, "
                         f"{tuple(bnd.shape)}")
    S, L = tl_t.shape
    _, Cb, k = bnd.shape
    Smax, Rb = slot_fold.shape[1], rel_codes.shape[1]
    Lp = L if Lp is None else min(int(Lp), L)
    f64, i32 = torch.float64, torch.int32
    args = dict(base0=(base0, f64, (S,)), tl_t=(tl_t, f64, (S, L)), tl_d=(tl_d, f64, (S, L)),
                tl_c=(tl_c, i32, (S, L)), slot_fold=(slot_fold, f64, (S, Smax)), rel_codes=(rel_codes, i32, (S, Rb)),
                starts=(starts, f64, (S, Cb)), ends=(ends, f64, (S, Cb)), rels=(rels, f64, (S, Cb)),
                bnd=(bnd, f64, (S, Cb, k)), val=(val, f64, (S, Cb, k)), codes=(codes, i32, (S, Cb)),
                valid=(valid, torch.bool, (S, Cb)))
    for name, (t, dtype, shape) in args.items():
        build.check_arg(f"admission_epoch {name}", t, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"admission_epoch {name}: need shape {shape}, got {tuple(t.shape)}")
    state = (base0, tl_t, tl_d, tl_c, slot_fold)
    if out is None:
        out = tuple(torch.empty_like(t) for t in state)
    for name, t, o in zip(STATE, state, out):
        build.check_arg(f"admission_epoch out {name}", o, t.dtype, t.dim(), dev)
        if o.shape != t.shape or o.data_ptr() == t.data_ptr():
            raise ValueError(f"admission_epoch out {name}: need a second {tuple(t.shape)} buffer")
    res = torch.empty((S, Cb + 2), dtype=i32, device=dev)
    if S == 0:
        return (res, *out)
    scratch_bytes = plan(L, Lp, Smax, Cb, k)["scratch"]
    scratch = torch.empty(S * scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    err = _launcher("admission_epoch_launch")(
        *(t.data_ptr() for t, _, _ in args.values()), S, L, Lp, Smax, Rb, Cb, k, float(t0), float(budget),
        *(o.data_ptr() for o in out), res.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"admission_epoch launch failed with CUDA error {err}")
    launches += 1
    return (res, *out)

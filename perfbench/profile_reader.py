"""The one profile reader: every device operation of a traced stretch in
exactly one family, the busy time, and the idle gaps.

Input, in plain records (``from_profiler`` makes them from a
``torch.profiler`` run, a test makes them by hand):
* device ops: (name, start, end, correlation id), seconds;
* launches: (correlation id, host start, host thread), the host call
  (``cudaLaunchKernel``, a copy, a memset) that queued each device op;
* host ranges: (name, start, end, thread), the program's own profiler
  ranges (``train.optimizer``, ``train.cross_entropy``) and the
  benchmark's ``perfbench.unit`` around each step or call.

Families, first match wins: ``optimizer`` (launched inside a
``train.optimizer`` range on its thread), ``cross_entropy`` (inside
``train.cross_entropy``), ``kernel:<name>`` (a hand-written kernel, by the
names in ``HAND_WRITTEN``), ``gemm`` (cuBLAS or CUTLASS products, by name),
``rest``.  Where device ops overlap, each instant is counted once, for the
op that started first, so the families sum to the busy time, and busy plus
idle is the stretch.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

# the program's hand-written kernels (``kernels/csrc``), by the CUDA function names each source defines
HAND_WRITTEN = {
    "flash": ("flash_kernel_tiles", "flash_kernel_mma", "flash_kernel_cores", "flash_kernel_combine"),
    "flash_bwd": ("flash_bwd_kernel_tiles", "flash_bwd_kernel_dot", "flash_bwd_kernel_empty",
                  "flash_bwd_kernel_dkv_wgmma", "flash_bwd_kernel_dq_wgmma", "flash_bwd_kernel_dkv_cores",
                  "flash_bwd_kernel_dq_cores"),
    "moe_dispatch": ("dispatch_kernel",),
    "moe_combine": ("combine_kernel",),
    "moe_combine_bwd": ("combine_bwd_fill_kernel", "combine_bwd_kernel"),
    "rwkv_wkv": ("wkv_kernel",),
    "rwkv_wkv_bwd": ("wkv_bwd_state_kernel", "wkv_bwd_chunk_kernel", "wkv_bwd_du_kernel"),
    "rglru_scan": ("rglru_kernel",),
    "rglru_scan_bwd": ("rglru_bwd_kernel",),
}
RANGES = {"train.optimizer": "optimizer", "train.cross_entropy": "cross_entropy"}
UNIT = "perfbench.unit"
_GEMM = re.compile(r"gemm|cutlass|nvjet|xmma|cublas|sm90_|sm80_|ampere_|hopper", re.IGNORECASE)
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def hand_written(name: str) -> str | None:
    """The hand-written kernel a device op's name belongs to, or None."""
    words = set(_WORD.findall(name))
    for kernel, fns in HAND_WRITTEN.items():
        if words.intersection(fns):
            return kernel
    return None


@dataclasses.dataclass
class Stretch:
    start: float
    end: float
    units: int
    busy: float
    families: dict[str, float]  # seconds a family
    ops: int  # device ops
    by_name: dict[str, float]  # seconds a device op name
    gaps: dict[str, float]  # idle seconds, by the host call that ended the gap
    op_names: dict[str, int]  # device ops a name

    @property
    def window(self) -> float:
        return self.end - self.start

    @property
    def idle(self) -> float:
        return self.window - self.busy

    def family_ms(self, prefix: str) -> float:
        """ms a unit of the families whose name is or starts with ``prefix``."""
        s = sum(v for k, v in self.families.items() if k == prefix or k.startswith(prefix + ":"))
        return 1e3 * s / self.units

    def kernel_s(self, kernel: str) -> float:
        return self.families.get("kernel:" + kernel, 0.0)


def read(device_ops, launches, ranges, launch_names=None) -> Stretch:
    """Reduce a traced stretch.  The stretch is from the first
    ``perfbench.unit`` range's start to the last one's end; device ops are
    clipped to it."""
    units = sorted((r for r in ranges if r[0] == UNIT), key=lambda r: r[1])
    if not units:
        raise ValueError("the trace holds no perfbench.unit range")
    t0, t1 = units[0][1], max(r[2] for r in units)
    spans: dict[str, list[tuple[float, float, object]]] = {}
    for name, a, b, thread in ranges:
        if name in RANGES:
            spans.setdefault(RANGES[name], []).append((a, b, thread))
    for v in spans.values():
        v.sort(key=lambda s: s[0])
    starts = {fam: [s[0] for s in sp] for fam, sp in spans.items()}
    by_corr = {c: (t, th) for c, t, th in launches}

    def family(name: str, corr) -> str:
        hit = by_corr.get(corr)
        if hit is not None:
            t, th = hit
            for fam in ("optimizer", "cross_entropy"):
                sp = spans.get(fam, [])
                i = bisect.bisect_right(starts.get(fam, []), t) - 1
                if i >= 0 and sp[i][0] <= t <= sp[i][1] and (sp[i][2] is None or th is None or sp[i][2] == th):
                    return fam
        k = hand_written(name)
        if k is not None:
            return "kernel:" + k
        return "gemm" if _GEMM.search(name) else "rest"

    ops = sorted(((a, b, n, c) for n, a, b, c in device_ops if b > t0 and a < t1), key=lambda o: (o[0], o[1]))
    families: dict[str, float] = {}
    by_name: dict[str, float] = {}
    op_names: dict[str, int] = {}
    gaps: dict[str, float] = {}
    busy, cover = 0.0, t0
    names = launch_names or {}
    for a, b, name, corr in ops:
        a, b = max(a, t0), min(b, t1)
        if a > cover:
            key = names.get(corr, "?")
            gaps[key] = gaps.get(key, 0.0) + (a - cover)
        own = max(0.0, b - max(a, cover))
        cover = max(cover, b)
        busy += own
        fam = family(name, corr)
        families[fam] = families.get(fam, 0.0) + own
        by_name[name] = by_name.get(name, 0.0) + own
        op_names[name] = op_names.get(name, 0) + 1
    if t1 > cover:
        gaps["(end of stretch)"] = gaps.get("(end of stretch)", 0.0) + (t1 - cover)
    return Stretch(start=t0, end=t1, units=len(units), busy=busy, families=families, ops=len(ops), by_name=by_name,
                   gaps=gaps, op_names=op_names)


def from_profiler(prof):
    """(device ops, launches, host ranges, launch names) from a finished
    ``torch.profiler.profile``, read from its Kineto events, in seconds."""
    from torch.autograd import DeviceType

    device_ops, launches, ranges = [], [], []
    ops_by_id, runtime = {}, []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            # a profiler range is also drawn on the device's timeline, over the work it spans: not an op
            if not (e.is_user_annotation() or e.name() == UNIT or e.name() in RANGES):
                device_ops.append((e.name(), a, b, e.correlation_id()))
            continue
        name = e.name()
        if name == UNIT or name in RANGES:
            ranges.append((name, a, b, e.start_thread_id()))
        if name.startswith(("cuda", "cu")) and e.linked_correlation_id() >= 0:
            runtime.append((e.correlation_id(), a, e.start_thread_id(), e.linked_correlation_id()))
        else:
            ops_by_id[e.correlation_id()] = name
    names = {}
    for corr, a, th, linked in runtime:
        launches.append((corr, a, th))
        names[corr] = ops_by_id.get(linked, "?")
    return device_ops, launches, ranges, names

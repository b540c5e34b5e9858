"""Dispatch audit of the port's loops: launches, transfers, rebuilds, dtypes.

Port of ``repro.analysis.trace_audit``, layer 2 of ``repro_torch.analysis``.
The reference listens on jax's compile events and walks jaxprs.  Eager
PyTorch compiles nothing per shape, so its counterparts are read at
dispatch, through a ``TorchDispatchMode`` that sees every aten op a block
dispatches (views and allocations included), and from the kernels' own
counters:

* ``LaunchCounter`` (for ``CompileCounter``) counts, inside a block, the
  launches of each hand-written kernel (``kernels.ops.launch_counts``: a
  kernel launches through ``ctypes``, which dispatch cannot see), the aten
  ops that launch work (all but ``NO_LAUNCH_OPS``) and their operand and
  result bytes, host read-backs (``_local_scalar_dense``, the op behind
  ``.item()``, ``float(t)`` and ``if t.any()``, and copies from a device to
  the host), uploads from the host and their bytes, and the kernel
  libraries ``kernels.build`` compiled or loaded.
* ``no_rebuilds`` (for ``no_recompiles``): a warm section builds and loads
  no kernel library, and launches what it is expected to.
* ``check_dtypes`` (for ``check_scan_carry_stability``): every floating
  result a function dispatches, against forbidden dtypes; the guard of the
  float64 scheduling programs.
* ``large_uploads`` (for ``closure_constants``): an eager program's baked
  constant is a host tensor it uploads on every call.

torch is imported here, unlike the lint layer's modules.
"""

from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# aten ops that launch nothing on the card: allocations, views, and the
# argument checks' reads of shapes
NO_LAUNCH_OPS = frozenset({"empty", "empty_strided", "select", "slice", "view", "_unsafe_view", "transpose", "alias",
                           "lift_fresh", "as_strided", "expand", "unsqueeze", "detach", "t", "permute", "reshape",
                           "_reshape_alias"})
READBACK_OPS = frozenset({"_local_scalar_dense"})  # a tensor's value read into a Python number


def _op_name(func) -> str:
    return func.__name__.split(".")[0]


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Dispatched(TorchDispatchMode):
    """Calls ``on_op(func, args, kwargs, out)`` after each aten op the block
    dispatches (not the ops inside an op's own implementation)."""

    def __init__(self, on_op: Callable) -> None:
        super().__init__()
        self.on_op = on_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.on_op(func, args, kwargs, out)
        return out


def dispatched_ops(fn: Callable[[], Any]) -> tuple[list[str], Any]:
    """The aten ops ``fn()`` dispatches (their base names), and its result."""
    seen: list[str] = []
    with _Dispatched(lambda func, args, kwargs, out: seen.append(_op_name(func))):
        out = fn()
    return seen, out


def launching_ops(call: Callable[[], Any]) -> int:
    """The aten ops one ``call()`` dispatches that launch work on the card
    (each launches one or more kernels or copies, or reads back to the
    host).  Counted at dispatch, so the count is exact, where the profiler
    drops the first device events of its window.  A hand-written kernel
    launches through its wrapper, not through aten: its wrapper counts it."""
    return sum(op not in NO_LAUNCH_OPS for op in dispatched_ops(call)[0])


@dataclass(frozen=True)
class Upload:
    """One copy of a host tensor to a device."""

    shape: tuple
    dtype: str
    nbytes: int


def _transfer(name: str, args: tuple, out) -> tuple[str, torch.Tensor] | None:
    """("upload" | "readback", the copy's destination) for a copy between the
    host and a device, else None.  ``torch.tensor(data, device=...)`` copies
    out of dispatch's sight and hands the device tensor to ``lift_fresh``."""
    if name == "lift_fresh":
        return ("upload", out) if isinstance(out, torch.Tensor) and out.device.type != "cpu" else None
    if name == "_to_copy":
        src, dst = args[0], out
    elif name == "copy_":
        dst, src = args[0], args[1]
    else:
        return None
    if not isinstance(src, torch.Tensor) or not isinstance(dst, torch.Tensor):
        return None
    on_host = src.device.type == "cpu", dst.device.type == "cpu"
    if on_host == (True, False):
        return "upload", dst
    if on_host == (False, True):
        return "readback", dst
    return None


def _library_counts() -> tuple[int, int]:
    from repro_torch.kernels import build

    return build.builds, build.loads


class LaunchCounter:
    """Context manager counting what a block launches and moves (module
    docstring).

    >>> with LaunchCounter() as lc:
    ...     simulate_grid(wfs, cfg=cfg)
    >>> lc.launches["segmax"], lc.launching_ops, lc.readbacks, lc.upload_bytes

    Counts of the kernels are differences of their counters, so nesting a
    counter, or resetting the counters outside it, is fine; resetting them
    inside the block is not.
    """

    def __init__(self) -> None:
        self.launches: dict[str, int] = {}
        self.aten: collections.Counter = collections.Counter()  # launching aten ops by name
        self.launching_bytes = 0  # their operand and result bytes
        self.readbacks = 0
        self.uploads: list[Upload] = []
        self.builds = 0
        self.loads = 0

    @property
    def launching_ops(self) -> int:
        return sum(self.aten.values())

    @property
    def upload_bytes(self) -> int:
        return sum(u.nbytes for u in self.uploads)

    def _on_op(self, func, args, kwargs, out) -> None:
        name = _op_name(func)
        moved = _transfer(name, args, out)
        if name in READBACK_OPS or (moved is not None and moved[0] == "readback"):
            self.readbacks += 1
        elif moved is not None:
            dst = moved[1]
            self.uploads.append(Upload(tuple(dst.shape), str(dst.dtype), dst.nbytes))
        if name not in NO_LAUNCH_OPS:
            self.aten[name] += 1
            self.launching_bytes += sum(t.nbytes for t in _tensors((args, kwargs)) + _tensors(out))

    def __enter__(self) -> "LaunchCounter":
        from repro_torch.kernels import ops

        self._launches0 = ops.launch_counts()
        self._libs0 = _library_counts()
        self._mode = _Dispatched(self._on_op)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc: object) -> None:
        from repro_torch.kernels import ops

        self._mode.__exit__(*exc)
        self.launches = {k: n - self._launches0.get(k, 0) for k, n in ops.launch_counts().items()}
        builds, loads = _library_counts()
        self.builds, self.loads = builds - self._libs0[0], loads - self._libs0[1]

    def snapshot(self) -> dict:
        return {
            "launches": {k: n for k, n in self.launches.items() if n},
            "launching_ops": self.launching_ops,
            "readbacks": self.readbacks,
            "uploads": len(self.uploads),
            "upload_bytes": self.upload_bytes,
            "builds": self.builds,
            "loads": self.loads,
        }


class RebuildError(AssertionError):
    """A warm section built or loaded a kernel library, or launched other
    than it was expected to."""


@contextlib.contextmanager
def no_rebuilds(
    what: str = "warm section", *, launches: dict[str, int] | None = None, launching_ops: int | None = None
) -> Iterator[LaunchCounter]:
    """Assert the wrapped block builds and loads no kernel library and, where
    given, launches each kernel ``launches[name]`` times (0 for a kernel not
    named) and dispatches ``launching_ops`` aten ops that launch."""
    with LaunchCounter() as lc:
        yield lc
    problems = []
    if lc.builds or lc.loads:
        problems.append(f"{lc.builds} kernel library(ies) built and {lc.loads} loaded")
    if launches is not None:
        off = {k: (launches.get(k, 0), n) for k, n in lc.launches.items() if n != launches.get(k, 0)}
        if off:
            problems.append(f"launches (expected, got) {off}")
    if launching_ops is not None and lc.launching_ops != launching_ops:
        problems.append(f"{lc.launching_ops} launching aten ops, expected {launching_ops}")
    if problems:
        raise RebuildError(f"{what}: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# dtype and upload checks
# ---------------------------------------------------------------------------


def check_dtypes(fn: Callable, *args: Any, forbid_dtypes: tuple[torch.dtype, ...] = (), **kwargs: Any) -> list[str]:
    """Run ``fn(*args, **kwargs)`` and list every floating result it
    dispatches whose dtype is forbidden (empty = clean): e.g.
    ``forbid_dtypes=(torch.float32,)`` over a float64 scheduling program,
    where one float32 op silently truncates every decision after it.  Views
    are skipped: their dtype is their base's, checked where it was made
    (``lift_fresh``, a tensor made from Python data, is no view of another)."""
    problems: list[str] = []

    def on_op(func, args, kwargs, out) -> None:
        if func.is_view and _op_name(func) != "lift_fresh":
            return
        for t in _tensors(out):
            if t.is_floating_point() and t.dtype in forbid_dtypes:
                problems.append(f"{_op_name(func)} gave {t.dtype} {tuple(t.shape)}")

    with _Dispatched(on_op):
        fn(*args, **kwargs)
    return problems


def large_uploads(fn: Callable, *args: Any, min_bytes: int = 1 << 20, **kwargs: Any) -> list[Upload]:
    """Uploads of at least ``min_bytes`` that one ``fn(*args, **kwargs)``
    makes, largest first.  A large host tensor uploaded on every call (in
    place of one kept on the device and passed in) costs its copy each call,
    as a constant captured by closure costs the reference each compile."""
    with LaunchCounter() as lc:
        fn(*args, **kwargs)
    return sorted((u for u in lc.uploads if u.nbytes >= min_bytes), key=lambda u: -u.nbytes)

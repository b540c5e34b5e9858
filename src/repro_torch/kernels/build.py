"""Build and load the CUDA kernels under ``csrc/``, and check their arguments.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``.  Libraries land in ``_build/`` beside this
file (listed in ``.gitignore``), each with its compiler output (``.log``:
registers and spills), named by a hash of the source, the headers under
``csrc/`` and the flags, so a changed source, header or flag rebuilds and an
unchanged one loads at once.  All
missing libraries build in parallel, one ``nvcc`` each.  A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# sm_90a is Hopper's full instruction set.  -Xptxas -v reports registers
# and spills.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
# -fmad=false keeps every f32 multiply and add rounded on its own, as
# PyTorch's elementwise ops round them, so a kernel and its plain version
# agree bit for bit where their arithmetic is the same: the engine's and the
# scheduler's kernels need that, and so does the MoE combine's rounding
# after each multiply and each add (and its backward's weighted rows), and
# the RG-LRU's multiply then add a step, forward and backward (its backward's
# add, then its two multiplies).  flash's inner products, forward and
# backward, the WKV chunk form (its products on the tensor cores) and the WKV
# backward (its state updates and sums) need no bit exactness (their plain
# versions sum in other orders) and keep FMA.
_EXACT = ("-fmad=false",)
SOURCES = {
    "segmax": _EXACT,
    "wastage": _EXACT,
    "rangemax": _EXACT,
    "compaction": _EXACT,
    "fitstats": _EXACT,
    "scan": _EXACT,
    "admission": _EXACT,
    "admission_epoch": _EXACT,
    "moe_dispatch": _EXACT,
    "moe_combine": _EXACT,
    "moe_combine_bwd": _EXACT,
    "rglru_scan": _EXACT,
    "rglru_scan_bwd": _EXACT,
    "flash": (),
    "flash_bwd": (),
    "rwkv_wkv": (),
    "rwkv_wkv_bwd": (),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # compiler output of the builds this process ran
builds = 0  # libraries this process compiled (read by analysis.trace_audit.LaunchCounter)
loads = 0  # libraries this process loaded


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin directory on PATH or set CUDA_HOME")
    return nvcc


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags ``csrc/<name>.cu`` compiles with."""
    return NVCC_FLAGS + SOURCES[name]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: named by a hash of the
    source, every header of ``csrc/`` (a source may include any of them)
    and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> list[str]:
    """Compile every missing library, all at once; returns the names built."""
    global builds
    with _lock:
        todo = [n for n in SOURCES if not library_path(n).exists()]
        if not todo:
            return []
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode == 0:
                library_path(name).with_suffix(".log").write_text(log)
                os.replace(tmp, library_path(name))
            else:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        builds += len(todo) - len(failed)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return todo


def build_log(name: str) -> str:
    """The compiler output of ``csrc/<name>.cu``'s library: this process's
    build, or the one kept beside a library built earlier ("" if neither)."""
    kept = library_path(name).with_suffix(".log")
    return build_logs.get(name) or (kept.read_text() if kept.exists() else "")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    global loads
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
                loads += 1
    return lib


def check_arg(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel's C interface takes."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def check_cuda(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA card: a kernel's wrapper never
    takes the plain version's place."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on {t.device}")

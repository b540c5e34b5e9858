"""Fault-tolerant checkpointing.

Port of ``repro.checkpoint.checkpointer``, on the same layout on disk, so
a checkpoint that either package writes, the other restores:
``<dir>/step_<n>/`` with one ``.npy`` per leaf (named by the CRC32 of its
key) and a ``MANIFEST.json`` carrying each leaf's shape, dtype name and
CRC32.  Writes go to ``step_<n>.tmp``, renamed only after the manifest is
fsync'd, so a crash mid-write never corrupts the latest valid checkpoint,
and ``latest_step`` skips unfinished directories.  bf16 leaves are stored
as their uint16 patterns under the dtype name ``"bfloat16"``.

A tree is nested dicts, lists and tuples whose leaves are tensors or numpy
arrays (``None`` holds no leaf).  A leaf's key joins its path with ``"|"``
as the reference's ``_flatten`` does: dict keys (a dict's in sorted order,
an ``OrderedDict``'s in its own, as JAX flattens them) and sequence
indices.  ``restore`` returns tensors on the card unless asked for the
CPU; the reference's ``shardings`` (re-meshing on restore) is not ported:
the port runs on one card.

``AsyncCheckpointer`` copies the tree to the host (blocking only for the
device-to-host copy) and writes it in a background thread.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "|"
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _map(tree, fn, path: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, in JAX's
    flattening order: a dict's keys sorted, an ``OrderedDict``'s in its own
    order, a sequence's by index; ``None`` holds no leaf."""
    if tree is None:
        return None
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _map(v, fn, path + (k,))) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(c, fn, path + (i,)) for i, c in enumerate(tree))
    return fn(_SEP.join(str(p) for p in path), tree)


def _flatten(tree) -> dict:
    """{key: leaf} in flattening order."""
    out = {}
    _map(tree, out.__setitem__)
    return out


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array written to disk, the dtype name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bf16 etc.): store a uint view
        return arr.view(_UINT[arr.dtype.itemsize]), str(arr.dtype)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Synchronous atomic checkpoint write.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        raw, dtype = _host(leaf)
        fname = f"{zlib.crc32(key.encode()):08x}.npy"
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(raw.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(raw.tobytes()),
        }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"a leaf of dtype {dtype!r} has no torch counterpart")
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like, *, device=None, validate: bool = True):
    """Restore into the structure of ``like`` (a tree whose leaves have a
    ``shape``: tensors, arrays, meta tensors).  Verifies CRCs and shapes.
    The leaves come back as tensors in the checkpoint's dtypes on
    ``device`` (default: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = {}
    for key, ref in _flatten(like).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(d, meta["file"]))
        if validate:
            if zlib.crc32(arr.tobytes()) != meta["crc32"]:
                raise IOError(f"checksum mismatch for {key!r}")
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"shape mismatch for {key!r}: {arr.shape} vs {tuple(ref.shape)}")
        out[key] = _tensor(arr, meta["dtype"]).to(dev)
    return _map(like, lambda key, _: out[key])


def _to_host(_, leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Overlapped checkpointing: snapshot to host, write in the background."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        self.wait()  # one in-flight write at a time
        host_tree = _map(tree, _to_host)  # device -> host

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)

"""MoE dispatch on the card: the launch wrapper of ``csrc/moe_dispatch.cu``,
and its plain PyTorch version.

No TPU kernel: replaces the reference's sort-based dispatch, which it
leaves to XLA (``repro/models/layers.py``, ``_moe_dispatch_compute`` and
``moe``: ``argsort`` over the flat expert ids, ``bincount``, ``cumsum``,
the scatter into ``buf``).  ``kernels.ops.moe_dispatch`` sends CUDA
tensors to the kernel (through ``MoEDispatch`` where autograd records the
call) and CPU tensors to ``moe_dispatch_plain``.

The dispatch's gradient, ``dxf[n] = sum dbuf[e_j, pos_j]`` over token n's
kept assignments in ascending expert id, is ``moe_combine`` with unit
weights: on the card one launch of ``csrc/moe_combine.cu`` (w = 1 rounds
to 1, so it adds the rows as they are, in that order, rounding to the
dtype after each add), and no kernel of its own.  It is the reference's
order: JAX transposes its gather ``xf[s_tok]`` into a scatter-add over the
expert-sorted assignments.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, moe_combine

launches = 0  # calls that launched the kernel, since the last ops.reset_launch_counts()

MAX_EXPERTS = 1024  # experts a call at most (csrc/moe_dispatch.cu:kMaxExperts)
_fn = None
_pools: dict[tuple[int, int], torch.Tensor] = {}


def moe_dispatch_plain(xf: torch.Tensor, ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xf (N, D), ids (N, k) int -> (buf (E, C, D) in xf's dtype, pos (N, k)
    int32).

    The reference's formula: assignment ``f = n * k + j`` takes its position
    in its expert in the order of f (``argsort(stable=True)``, as
    ``jnp.argsort`` is stable), from ``bincount`` and ``cumsum``.  ``pos``
    is -1 for an id outside ``[0, E)`` (another expert slice's).  An
    assignment with ``0 <= pos < C`` is kept and its token's row put at
    ``buf[e, pos]``; every other slot is zero.  The rows are gathered in
    the expert-sorted order, so autograd adds each token's gradient in
    ascending expert id, rounding after each add, as
    ``moe_dispatch_bwd_plain`` does.  On the CPU, ``index_select``'s
    backward (``index_add_``) adds in index order but sums bf16 in f32, and
    an indexing gather's (an accumulating ``index_put_``) rounds each bf16
    add but adds float32 with atomics across threads past 32,768 elements:
    float32 takes the first, bf16 the second."""
    N, k = ids.shape
    flat = ids.reshape(-1).long()
    in_slice = (flat >= 0) & (flat < E)
    key = torch.where(in_slice, flat, E)  # other slices sort to the end
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=E + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(N * k, device=flat.device) - starts[key[order]]
    pos = torch.where(in_slice, pos, -1)
    keep = in_slice & (pos < C)
    buf = torch.zeros((E, C, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    sel = order[keep[order]]  # the kept assignments, expert-sorted
    src = sel // k
    buf[flat[sel], pos[sel]] = xf.index_select(0, src) if xf.dtype == torch.float32 else xf[src]
    return buf, pos.view(N, k).to(torch.int32)


def moe_dispatch_bwd_plain(dbuf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The gradient of ``moe_dispatch_plain``'s xf given buf's, dbuf (E, C,
    D) -> dxf (N, D) in dbuf's dtype: ``moe_combine_plain`` with unit
    weights."""
    return moe_combine.moe_combine_plain(dbuf, ids, pos, torch.ones(ids.shape, dtype=torch.float32,
                                                                     device=dbuf.device))


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("moe_dispatch").moe_dispatch_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, i, i, i, p, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def _pool(dev: torch.device, stream: int) -> torch.Tensor:
    """The stream's claim counters of the kernel's pool of zero rows: two
    int32, zeroed once (each launch leaves them zero; launches on one stream
    run in turn)."""
    key = (dev.index, stream)
    pool = _pools.get(key)
    if pool is None:
        pool = _pools[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return pool


def moe_dispatch_cuda(xf: torch.Tensor, ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_dispatch_plain`` on the card: one device launch (each block
    counts and ranks its range of tokens, reads each kept token's row once
    and writes it to its slots, and writes its share of the empty slots);
    buf bit for bit and pos exact.  E is at most ``MAX_EXPERTS``."""
    global launches
    build.check_cuda("moe_dispatch", xf)
    dev = xf.device
    if xf.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moe_dispatch: xf must be float32 or bfloat16, got {xf.dtype}")
    build.check_arg("xf", xf, xf.dtype, 2, dev)
    build.check_arg("ids", ids, torch.int32, 2, dev)
    N, D = xf.shape
    k = ids.shape[1]
    if ids.shape[0] != N or not 1 <= E <= MAX_EXPERTS or C < 1 or E * C >= 2**31:
        raise ValueError(f"moe_dispatch: xf {tuple(xf.shape)}, ids {tuple(ids.shape)}, E {E}, C {C}")
    pos = torch.empty((N, k), dtype=torch.int32, device=dev)
    buf = torch.empty((E, C, D), dtype=xf.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(xf.data_ptr(), N, D * xf.element_size(), ids.data_ptr(), k, E, C, pos.data_ptr(),
                      buf.data_ptr(), _pool(dev, stream).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch launch failed with CUDA error {err}")
    launches += 1
    return buf, pos


def moe_dispatch_bwd_cuda(dbuf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``moe_dispatch_bwd_plain`` on the card, bit for bit: one launch of the
    combine kernel with unit weights (counted as ``moe_combine``'s), under
    the profiler range ``moe_dispatch.backward``."""
    with torch.profiler.record_function("moe_dispatch.backward"):
        ones = torch.ones(ids.shape, dtype=torch.float32, device=dbuf.device)
        return moe_combine.moe_combine_cuda(dbuf.contiguous(), ids, pos, ones)


class MoEDispatch(torch.autograd.Function):
    """The MoE dispatch on the card with its gradient: the forward kernel,
    then ``moe_dispatch_bwd_cuda``.  ``pos`` is not differentiable.
    Nothing of it calls a plain version."""

    @staticmethod
    def forward(ctx, xf, ids, E, C):
        buf, pos = moe_dispatch_cuda(xf, ids, E, C)
        ctx.mark_non_differentiable(pos)
        ctx.save_for_backward(ids, pos)
        return buf, pos

    @staticmethod
    def backward(ctx, dbuf, _dpos):
        ids, pos = ctx.saved_tensors
        dxf = moe_dispatch_bwd_cuda(dbuf, ids, pos) if ctx.needs_input_grad[0] else None
        return dxf, None, None, None

"""flash attention on the card: the launch wrapper of ``csrc/flash.cu``, and
its plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/flash.py`` (``_flash_kernel`` /
``flash_attention_pallas``): the attention forward with online softmax,
position-based causal mask, sliding window, softcap and GQA, with
``k_pos = -1`` marking empty cache slots.  ``kernels.ops.flash_attention``
sends CUDA tensors to the kernel and CPU tensors to
``flash_attention_plain``, the reference's XLA path
(``repro/models/layers.py:flash_attention``): a loop over KV chunks of 1024
with the score matrix of one chunk at a time.

The kernel takes one of three paths (``kernel_plan``): bf16 prefill on the
tensor cores, f32 prefill on the CUDA cores, and decode (``T * G <= 4``)
split over the KV cache with a combine.  Every path skips the KV tiles in
which no (row, key) pair of a block is valid.  Beside the plain version
stand the plain forms of that decomposition, which the CPU tests hold
against the reference and the card tests hold the kernel's pieces against:
``flash_tile_live`` (the liveness rule), ``flash_attention_tiles_plain``
(attention over the live tiles alone), ``flash_decode_partials_plain`` and
``flash_combine_plain`` (the splits and their combine).  Nothing on the
main path calls them when a card is present.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0  # calls that launched the kernels, since the last ops.reset_launch_counts()

HEAD_DIMS = (16, 64, 80, 128, 256)  # every attention head_dim in configs/, and reduced()'s 16
NEG_INF = -1.0e30  # masked scores, as the reference (not -inf)
KV_CHUNK = 1024
SPLIT_ROWS = 4  # T * G at most this takes decode's split path
CORES_TILE = 64  # keys per KV tile of the CUDA-core kernel, decode's splits included
SPLIT_WAVES = 4  # decode's splits fill the card this many blocks an SM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_sms: dict[torch.device, int] = {}  # SMs of each card, for decode's splits


def kernel_plan(dtype: torch.dtype, hd: int, rows: int) -> tuple[str, int, int]:
    """(path, BM, BN): the kernel ``csrc/flash.cu:launch_hd`` runs for
    ``rows = T * G`` packed query rows, its rows per block and keys per KV
    tile.  ``"split"``: decode, CUDA cores, one block of all rows per run of
    KV tiles; ``"cores"``: f32 prefill on the CUDA cores; ``"mma"``: bf16
    prefill on the tensor cores (8 warps of 16 rows up to hd 64, else 4; 32
    keys a tile at hd 256, where the output accumulators take 128 registers
    a thread)."""
    if rows <= SPLIT_ROWS:
        return "split", SPLIT_ROWS, CORES_TILE
    if dtype == torch.float32:
        return "cores", 64, CORES_TILE
    return "mma", 128 if hd <= 64 else 64, 32 if hd == 256 else 64


def decode_splits(B: int, KV: int, S: int, sms: int) -> int:
    """Runs of KV tiles a (batch, kv head) is split into at decode: equal
    runs of whole tiles, as many as fill ``sms`` SMs ``SPLIT_WAVES`` blocks
    deep (llama3.2-3b's B 2 x KV 8 over 4,112 slots: 33 runs of 2 tiles)."""
    n_tiles = -(-S // CORES_TILE)
    per = max(1, -(-n_tiles * B * KV // (SPLIT_WAVES * sms)))
    return -(-n_tiles // per)


def scratch_layout(B: int, T: int, S: int, H: int, KV: int, hd: int, dtype: torch.dtype,
                   splits: int) -> tuple[int, int]:
    """(offset of decode's partials, bytes): the scratch ``flash_launch``
    takes.  First the tile summaries (16 bytes a KV tile of each batch
    row); then, on the split path, the partials: (B, KV, splits, T * G,
    hd + 2) f32, each row's acc[hd], m, l."""
    path, _, bn = kernel_plan(dtype, hd, T * (H // KV))
    tiles = -(-(B * -(-S // bn) * 16) // 16) * 16
    if path != "split":
        return tiles, tiles
    return tiles, tiles + 4 * B * KV * splits * T * (H // KV) * (hd + 2)


def _attend(q, k, v, q_pos, k_pos, *, causal, window, softcap, kv_chunk, live=None):
    """The reference's online softmax over KV chunks of ``kv_chunk`` ->
    (m, l, acc): (B, T, H), (B, T, H), (B, T, H, hd), f32.  ``live``
    (B, T, H, chunks) bool: where False, a chunk leaves a row's state as it
    is (the kernel's skipped tiles)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    qf = q.float()
    q_pos = q_pos.expand(B, T)[:, :, None]
    m = torch.full((B, T, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, T, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    for i, c0 in enumerate(range(0, S, kv_chunk)):
        kx = k[:, c0 : c0 + kv_chunk].repeat_interleave(G, dim=2).float()
        vx = v[:, c0 : c0 + kv_chunk].repeat_interleave(G, dim=2).float()
        pc = k_pos[:, None, c0 : c0 + kv_chunk]  # (B, 1, C)
        s = torch.einsum("bthd,bchd->bthc", qf, kx) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = pc >= 0
        if causal:
            ok = ok & (pc <= q_pos)
        if window is not None:
            ok = ok & (pc > q_pos - window)
        s = torch.where(ok[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bthc,bchd->bthd", p.to(v.dtype).float(), vx)
        if live is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            lv = live[..., i]
            m, l, acc = torch.where(lv, m_new, m), torch.where(lv, l_new, l), torch.where(lv[..., None], acc_new, acc)
    return m, l, acc


def _mean_v(v: torch.Tensor, G: int) -> torch.Tensor:
    """(B, 1, H, hd) f32: the mean of V over the S slots, what a row with no
    valid key gets (every score -1e30, so every p is 1)."""
    return (v.float().sum(dim=1) / v.shape[1]).repeat_interleave(G, dim=1)[:, None]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    kv_chunk: int = KV_CHUNK,
) -> torch.Tensor:
    """q (B, T, H, hd); k, v (B, S, KV, hd) with H % KV == 0; q_pos (B, T);
    k_pos (B, S), -1 marks empty slots.  Returns (B, T, H, hd) in q.dtype.

    Scores and the PV product take the operands' values in f32 (the
    reference's ``preferred_element_type``); ``p`` is rounded to v's type
    before the PV product, the running sum takes it unrounded."""
    _, l, acc = _attend(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap, kv_chunk=kv_chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_tile_live(
    q_pos: torch.Tensor, k_pos: torch.Tensor, G: int, bm: int, bn: int, *, causal: bool, window: int | None
) -> torch.Tensor:
    """(B, row tiles, KV tiles) bool: the kernel's tile-skipping rule.  Row
    r of a batch row is query r // G; a tile of ``bm`` rows against a tile
    of ``bn`` slots is dead when no slot is valid, or (causal) the least
    valid k_pos exceeds the rows' largest q_pos, or (window) the largest
    valid k_pos is at or below the rows' least q_pos - window.  Min and max
    need no order of positions (rolling caches), and never call a tile dead
    that holds a valid (row, key) pair."""
    B, T = q_pos.shape
    S = k_pos.shape[1]
    rows, big = T * G, 2**40
    n_rt, n_kt = -(-rows // bm), -(-S // bn)
    qr = q_pos.long().repeat_interleave(G, dim=1)  # (B, rows)
    qmin = F.pad(qr, (0, n_rt * bm - rows), value=big).view(B, n_rt, bm).amin(-1)
    qmax = F.pad(qr, (0, n_rt * bm - rows), value=-big).view(B, n_rt, bm).amax(-1)
    kp = F.pad(k_pos.long(), (0, n_kt * bn - S), value=-1).view(B, n_kt, bn)
    ok = kp >= 0
    kmin = torch.where(ok, kp, big).amin(-1)[:, None, :]
    kmax = torch.where(ok, kp, -big).amax(-1)[:, None, :]
    live = ok.any(-1)[:, None, :].expand(B, n_rt, n_kt)
    if causal:
        live = live & (kmin <= qmax[:, :, None])
    if window is not None:
        live = live & (kmax > qmin[:, :, None] - window)
    return live


def flash_attention_tiles_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    bm: int,
    bn: int,
) -> torch.Tensor:
    """Attention over the live tiles alone (``flash_tile_live``), in KV
    chunks of ``bn``, as the kernel skips: a row's state moves only on the
    tiles its row tile keeps.  Rows with no valid key get mean V over the S
    slots, as in the kernel.  On every row with a valid key this equals
    ``flash_attention_plain(..., kv_chunk=bn)`` bit for bit."""
    B, T, H, _ = q.shape
    G = H // k.shape[2]
    q_pos = q_pos.expand(B, T)
    live = flash_tile_live(q_pos, k_pos, G, bm, bn, causal=causal, window=window)
    row = torch.arange(T, device=q.device)[:, None] * G + torch.arange(H, device=q.device) % G  # (T, H)
    m, l, acc = _attend(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap, kv_chunk=bn,
                        live=live[:, row // bm])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((m == NEG_INF)[..., None], _mean_v(v, G), out)
    return out.to(q.dtype)


def flash_decode_partials_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    splits: int,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    tile: int = CORES_TILE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode kernel's partials: the S slots cut into ``splits`` equal
    runs of whole tiles of ``tile`` slots (the last runs may be short or
    empty), the reference's online softmax over each run alone ->
    m (B, splits, T, H), l (B, splits, T, H), acc (B, splits, T, H, hd),
    f32.  A run in which a row has no valid key gives (-1e30, 0, 0): it
    drops out of the combine."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    n_tiles = -(-S // tile)
    per = -(-n_tiles // splits) * tile  # slots a run
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = min(S, i * per), min(S, (i + 1) * per)
        m, l, acc = _attend(q, k[:, lo:hi], v[:, lo:hi], q_pos, k_pos[:, lo:hi], causal=causal, window=window,
                            softcap=softcap, kv_chunk=tile)
        none = m == NEG_INF
        ms.append(m)
        ls.append(torch.where(none, 0.0, l))
        accs.append(torch.where(none[..., None], 0.0, acc))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)


def flash_combine_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The combine: m = max m_i, l = Σ l_i exp(m_i - m), acc = Σ acc_i
    exp(m_i - m), out = acc / max(l, 1e-30) in v's type; a row with no
    valid key in any run (m = -1e30) gets mean V over the S slots."""
    mx = m.amax(dim=1)
    w = torch.exp(m - mx[:, None])
    out = (acc * w[..., None]).sum(dim=1) / torch.clamp((l * w).sum(dim=1), min=1e-30)[..., None]
    out = torch.where((mx == NEG_INF)[..., None], _mean_v(v, m.shape[-1] // v.shape[2]), out)
    return out.to(v.dtype)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("flash").flash_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, i, p, ctypes.c_size_t, p]
        fn.restype = i
        _fn = fn
    return _fn


def _launch(q, k, v, q_pos, k_pos, causal, window, softcap, splits):
    """Check, allocate the output and scratch, launch -> (out, scratch,
    offset of the partials, splits)."""
    global launches
    dev, dt = q.device, q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"flash: need float32 or bfloat16 operands, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_arg(name, t, dt, 4, dev)
    build.check_arg("q_pos", q_pos, torch.int32, 2, dev)
    build.check_arg("k_pos", k_pos, torch.int32, 2, dev)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {hd} has no kernel instance (one of {HEAD_DIMS})")
    if (
        tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd) or KV < 1 or H % KV
        or tuple(q_pos.shape) != (B, T) or tuple(k_pos.shape) != (B, S) or B * KV > 65535
    ):
        raise ValueError(f"flash: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash: q, k and v must start on a 16-byte boundary")
    if kernel_plan(dt, hd, T * (H // KV))[0] != "split":
        splits = 1
    elif splits is None:
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = decode_splits(B, KV, S, _sms[dev])
    offset, nbytes = scratch_layout(B, T, S, H, KV, hd, dt, splits)
    out = torch.empty_like(q)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
        B, T, S, H, KV, hd, _DTYPES[dt], hd**-0.5, int(causal), int(window or 0), float(softcap or 0.0), splits,
        scratch.data_ptr(), nbytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash launch failed with CUDA error {err}")
    launches += 1
    return out, scratch, offset, splits


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
) -> torch.Tensor:
    """The kernel: q (B, T, H, hd), k/v (B, S, KV, hd) in f32 or bf16,
    q_pos (B, T) and k_pos (B, S) int32, all contiguous on one card ->
    (B, T, H, hd) in q's type.  One call counts one launch, whatever the
    number of device launches (2 for prefill, 3 for decode)."""
    return _launch(q, k, v, q_pos, k_pos, causal, window, softcap, None)[0]


def flash_decode_partials_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    splits: int | None = None,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode on the card (``T * G <= 4``), returning its split kernel's
    partials beside the output: (m, l, acc, out), laid out as
    ``flash_decode_partials_plain``'s."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    if kernel_plan(q.dtype, hd, T * (H // KV))[0] != "split":
        raise ValueError(f"flash: {T * (H // KV)} rows take no split path (at most {SPLIT_ROWS})")
    out, scratch, offset, splits = _launch(q, k, v, q_pos, k_pos, causal, window, softcap, splits)
    part = scratch[offset:].view(torch.float32).view(B, KV, splits, T, H // KV, hd + 2)
    part = part.permute(0, 2, 3, 1, 4, 5).reshape(B, splits, T, H, hd + 2)
    return part[..., hd], part[..., hd + 1], part[..., :hd], out

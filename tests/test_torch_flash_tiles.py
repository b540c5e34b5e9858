"""The flash kernel's decomposition, in its plain forms, against the
reference (``repro.models.layers.flash_attention``, the XLA chunk scan).

``csrc/flash.cu`` skips KV tiles that no (row, key) pair of a block can
use, and splits decode over the KV cache with a combine.  The plain forms
beside it (``repro_torch.kernels.flash``) state those rules in PyTorch:
here they are held against the reference on the CPU, and on the card
(``tests/test_torch_cuda.py``) the kernel's pieces are held against them.

1. The split partials and their combine give the reference's result at
   every split count from 1 to S, within the kernel tolerance (atol 3e-5 /
   rtol 1e-4, f32).
2. Attention over the live tiles alone equals the full plain version bit
   for bit on every row with a valid key (causal, window, ragged and
   rolling positions), and the reference within the tolerance on every row.
3. The liveness rule never marks dead a tile that holds a valid pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as ref_flash
from repro_torch.kernels import flash

TOL = dict(atol=3e-5, rtol=1e-4)


def _inputs(seed, B, T, S, H, KV, hd, kpos, qpos):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    return q, k, v, np.ascontiguousarray(qpos, np.int32), np.ascontiguousarray(kpos, np.int32)


def _rolling(S_c, nows, T=1):
    """k_pos of a cache of S_c slots written at pos % S_c, and the T last
    query positions of each row."""
    kpos = np.full((len(nows), S_c), -1)
    for b, now in enumerate(nows):
        for p in range(max(now - S_c + 1, 0), now + 1):
            kpos[b, p % S_c] = p
    return kpos, np.asarray(nows)[:, None] - T + 1 + np.arange(T)[None]


def _case(name):
    """(arrays, kw) of a named position pattern; S is a multiple of no tile."""
    if name == "causal":  # prefill, GQA 3
        pos = np.broadcast_to(np.arange(45)[None], (2, 45))
        return _inputs(1, 2, 45, 45, 6, 2, 16, pos, pos), dict(causal=True, window=None, softcap=None)
    if name == "window":  # prefill with a sliding window and softcap
        pos = np.broadcast_to(np.arange(53)[None], (1, 53))
        return _inputs(2, 1, 53, 53, 4, 4, 16, pos, pos), dict(causal=True, window=9, softcap=30.0)
    if name == "ragged":  # decode, rows hold 37 and 12 tokens of 45 slots
        kpos = np.where(np.arange(45)[None] < np.asarray([[37], [12]]), np.arange(45)[None], -1)
        return _inputs(3, 2, 1, 45, 6, 2, 16, kpos, [[36], [11]]), dict(causal=True, window=None, softcap=None)
    if name == "rolling":  # 3 queries against a wrapped and a part-filled local cache
        kpos, qpos = _rolling(29, (83, 17), T=3)
        return _inputs(4, 2, 3, 29, 4, 2, 16, kpos, qpos), dict(causal=True, window=20, softcap=None)
    if name == "late-keys":  # queries before every key: no valid key
        qpos = np.broadcast_to(np.arange(21)[None], (2, 21))
        kpos = np.broadcast_to(np.arange(45)[None] + 7, (2, 45))
        return _inputs(5, 2, 21, 45, 6, 2, 16, kpos, qpos), dict(causal=True, window=None, softcap=None)
    if name == "window-out":  # decode whose window excludes every filled slot of row 0
        kpos = np.where(np.arange(45)[None] < np.asarray([[30], [40]]), np.arange(45)[None], -1)
        return _inputs(6, 2, 1, 45, 6, 2, 16, kpos, [[60], [39]]), dict(causal=True, window=16, softcap=None)
    raise KeyError(name)


def _valid_rows(arrays, kw):
    """(B, T) bool: rows with at least one valid key."""
    _, _, _, qp, kp = arrays
    ok = kp[:, None, :] >= 0
    if kw["causal"]:
        ok = ok & (kp[:, None, :] <= qp[:, :, None])
    if kw["window"] is not None:
        ok = ok & (kp[:, None, :] > qp[:, :, None] - kw["window"])
    return ok.any(-1)


def _reference(arrays, kw):
    return np.asarray(ref_flash(*(jnp.asarray(a) for a in arrays), **kw))


@pytest.mark.parametrize("name", ["ragged", "rolling", "window-out"])
def test_split_and_combine_match_reference_at_every_split_count(name):
    arrays, kw = _case(name)
    t = [torch.from_numpy(a) for a in arrays]
    want = _reference(arrays, kw)
    S = t[1].shape[1]
    for splits in range(1, S + 1):
        m, l, acc = flash.flash_decode_partials_plain(*t, splits, **kw, tile=1)
        assert m.shape == (t[0].shape[0], splits, *t[0].shape[1:3]) and acc.shape[-1] == t[0].shape[-1]
        got = flash.flash_combine_plain(m, l, acc, t[2])
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"{splits} splits")


def test_split_partials_in_kernel_tiles():
    """At the kernel's own tile (64 slots) a run is whole tiles: 45 slots
    are one tile, so one split holds everything and the others are empty
    and drop out (-1e30, 0, 0)."""
    arrays, kw = _case("ragged")
    t = [torch.from_numpy(a) for a in arrays]
    m, l, acc = flash.flash_decode_partials_plain(*t, 3, **kw)
    assert (m[:, 1:] == flash.NEG_INF).all() and (l[:, 1:] == 0).all() and (acc[:, 1:] == 0).all()
    assert (m[:, 0] > flash.NEG_INF).all()
    np.testing.assert_allclose(flash.flash_combine_plain(m, l, acc, t[2]).numpy(), _reference(arrays, kw), **TOL)


@pytest.mark.parametrize("bm,bn", [(4, 8), (8, 16), (64, 64)])
@pytest.mark.parametrize("name", ["causal", "window", "ragged", "rolling", "late-keys", "window-out"])
def test_live_tiles_alone_equal_the_full_plain_version(name, bm, bn):
    arrays, kw = _case(name)
    t = [torch.from_numpy(a) for a in arrays]
    got = flash.flash_attention_tiles_plain(*t, **kw, bm=bm, bn=bn)
    full = flash.flash_attention_plain(*t, **kw, kv_chunk=bn)
    rows = torch.from_numpy(_valid_rows(arrays, kw))
    assert torch.equal(got[rows], full[rows])  # bit for bit where a key is valid
    np.testing.assert_allclose(got.numpy(), _reference(arrays, kw), **TOL)


def test_tile_skipping_skips():
    """The rule is not vacuous: causal prefill and the window leave dead
    tiles, and so do a ragged cache's empty slots."""
    for name, bm, bn, dead in (("causal", 8, 8, 0.3), ("window", 8, 8, 0.5), ("ragged", 4, 8, 0.3)):
        arrays, kw = _case(name)
        _, _, _, qp, kp = (torch.from_numpy(a) for a in arrays)
        G = arrays[0].shape[2] // arrays[1].shape[2]
        live = flash.flash_tile_live(qp, kp, G, bm, bn, causal=kw["causal"], window=kw["window"])
        assert 1 - live.float().mean().item() >= dead, name


@pytest.mark.parametrize("seed", range(8))
def test_liveness_never_marks_dead_a_tile_with_a_valid_pair(seed):
    """Random positions (shuffled, repeated, -1 holes, queries anywhere):
    every (row tile, KV tile) that holds a valid (row, key) pair is live."""
    rng = np.random.default_rng(seed)
    B, T, S, G = 3, int(rng.integers(1, 9)), int(rng.integers(5, 80)), int(rng.integers(1, 4))
    kp = rng.integers(-1, 60, (B, S))
    kp[rng.random((B, S)) < 0.3] = -1
    qp = rng.integers(0, 70, (B, T))
    for causal in (True, False):
        for window in (None, 1, 7, 25):
            for bm, bn in ((1, 1), (4, 8), (8, 16), (64, 64)):
                live = flash.flash_tile_live(torch.from_numpy(qp), torch.from_numpy(kp), G, bm, bn,
                                             causal=causal, window=window).numpy()
                ok = kp[:, None, :] >= 0
                if causal:
                    ok = ok & (kp[:, None, :] <= qp[:, :, None])
                if window is not None:
                    ok = ok & (kp[:, None, :] > qp[:, :, None] - window)
                ok = np.repeat(np.broadcast_to(ok, (B, T, S)), G, axis=1)  # (B, rows, S): row r is query r // G
                rows, n_rt, n_kt = T * G, live.shape[1], live.shape[2]
                pad = np.zeros((B, n_rt * bm, n_kt * bn), bool)
                pad[:, :rows, :S] = ok
                holds = pad.reshape(B, n_rt, bm, n_kt, bn).any(axis=(2, 4))
                assert not (holds & ~live).any(), (causal, window, bm, bn)


def test_kernel_plan_and_scratch():
    """The wrapper's mirror of ``csrc/flash.cu``'s choice of path, decode's
    split count and the scratch it hands the launch."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert flash.kernel_plan(bf16, 128, 4096 * 3) == ("mma", 64, 64)
    assert flash.kernel_plan(bf16, 256, 8192 * 2) == ("mma", 64, 32)
    assert flash.kernel_plan(bf16, 64, 200) == ("mma", 128, 64)
    assert flash.kernel_plan(f32, 128, 200) == ("cores", 64, 64)
    assert flash.kernel_plan(bf16, 128, 3) == flash.kernel_plan(f32, 16, 4) == ("split", 4, 64)
    # llama3.2-3b's decode: B 2 x KV 8 over 4,112 slots on 132 SMs -> 33 runs of 2 tiles
    assert flash.decode_splits(2, 8, 4112, 132) == 33
    assert flash.decode_splits(1, 1, 45, 132) == 1
    assert flash.decode_splits(1, 8, 8192, 132) == 64
    off, nbytes = flash.scratch_layout(2, 1, 4112, 24, 8, 128, bf16, 33)
    assert off == 2 * 65 * 16 and nbytes == off + 4 * 2 * 8 * 33 * 3 * 130
    assert flash.scratch_layout(2, 4096, 4096, 24, 8, 256, bf16, 1) == (2 * 128 * 16,) * 2


def test_partials_wrapper_refuses_a_prefill_shape():
    q = torch.zeros((1, 8, 4, 64))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="split path"):
        flash.flash_decode_partials_cuda(q, q, q, pos, pos, causal=True, window=None, softcap=None)

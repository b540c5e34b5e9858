"""The port's plain flash attention against the reference's two paths.

``repro_torch.kernels.flash.flash_attention_plain`` (what CPU tensors run,
and what the CUDA kernel is held to on the card) against
``repro.models.layers.flash_attention`` (the XLA chunk scan) and
``repro.kernels.flash.flash_attention_pallas`` in interpret mode, on the
reference's own FLASH_CASES plus a GQA decode against a rolling local cache,
rows with no valid key (which get the mean of V over the S slots), wrapped
rolling caches at hd 128 and 256, and a causal prefill at S = 4,096 + 37.
Float32 at atol 3e-5 / rtol 1e-4, the reference's kernel tolerance
(``tests/test_kernels.py``); bf16 at the card's flash gate (max |d| <= 1e-2,
mean |d| <= 1e-3), since the two sides round p to bf16 after running maxima
that differ in the last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention_pallas
from repro.models.layers import flash_attention as ref_flash
from repro_torch.kernels import flash, ops

TOL = dict(atol=3e-5, rtol=1e-4)

# the reference's FLASH_CASES (tests/test_kernels.py): B, T, S, H, KV, hd,
# causal, window, softcap
FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, None, None),
    (1, 300, 300, 8, 8, 32, True, None, 50.0),  # softcap
    (2, 37, 37, 6, 2, 16, True, 16, None),  # local window
    (2, 1, 80, 4, 4, 16, True, None, None),  # decode (ragged cache)
    (1, 128, 128, 4, 2, 64, False, None, None),  # encoder
]


def _case_inputs(B, T, S, H, KV, hd):
    """The reference test's inputs for one case, as numpy."""
    rng = np.random.default_rng(B * 31 + T)
    q = rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    if T == 1:
        qpos = np.full((B, 1), 40, np.int32)
        kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        kpos = np.where(kpos < 60, kpos, -1).astype(np.int32)
    else:
        qpos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
        kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return q, k, v, qpos, kpos


def _rolling_cache_inputs():
    """GQA decode (H 6 over KV 2) against a local cache of 32 slots written
    at ``pos % 32``: row 0 has wrapped (positions 39..70), row 1 holds 21
    tokens and 11 empty slots."""
    rng = np.random.default_rng(7)
    B, S_c, H, KV, hd = 2, 32, 6, 2, 16
    q = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S_c, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S_c, KV, hd)).astype(np.float32)
    kpos = np.full((B, S_c), -1, np.int32)
    for b, now in enumerate((70, 20)):
        for p in range(max(now - S_c + 1, 0), now + 1):
            kpos[b, p % S_c] = p
    qpos = np.asarray([[70], [20]], np.int32)
    return q, k, v, qpos, kpos


def _late_keys_inputs(B=2, T=20, S=45, H=6, KV=2, hd=16, shift=7):
    """A causal prefill (GQA, G = 3) whose keys sit at positions shift..:
    the queries at positions below ``shift`` have no valid key.  S = 45 is
    a multiple of no tile size."""
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S)[None] + shift, (B, S)).astype(np.int32)
    return q, k, v, qpos, kpos


def _window_out_inputs(B=2, S=45, H=6, KV=2, hd=16, window=16):
    """GQA decode (G = 3) against a ragged cache: row 0 holds 30 tokens and
    queries at 60, so the window excludes every filled slot; row 1 holds 40
    and queries the last of them."""
    rng = np.random.default_rng(12)
    q = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, KV, hd)).astype(np.float32)
    fill = np.asarray([[30], [40]])
    kpos = np.where(np.arange(S)[None] < fill, np.arange(S)[None], -1).astype(np.int32)
    qpos = np.asarray([[60], [39]], np.int32)
    return q, k, v, qpos, kpos


def _wrapped_rolling_inputs(hd, H, KV, S_c=40, T=1, nows=(97, 25), seed=13):
    """A rolling cache of S_c slots written at ``pos % S_c``: row 0 has
    wrapped (k_pos not monotone in the slot), row 1 is part filled; the T
    queries end at each row's newest position."""
    rng = np.random.default_rng(seed)
    B = len(nows)
    q = rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S_c, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S_c, KV, hd)).astype(np.float32)
    kpos = np.full((B, S_c), -1, np.int32)
    for b, now in enumerate(nows):
        for p in range(max(now - S_c + 1, 0), now + 1):
            kpos[b, p % S_c] = p
    qpos = (np.asarray(nows)[:, None] - T + 1 + np.arange(T)[None]).astype(np.int32)
    return q, k, v, qpos, kpos


def _long_prefill_inputs(S=4096 + 37, H=2, KV=1, hd=16):
    """A causal prefill at S = 4,096 + 37: past the reference's 1,024-key
    chunk and 512-key block, and a ragged last tile of every tile size."""
    rng = np.random.default_rng(14)
    q = rng.normal(0, 1, (1, S, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (1, S, KV, hd)).astype(np.float32)
    v = rng.normal(0, 1, (1, S, KV, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    return q, k, v, pos, pos


CASES = [(c, _case_inputs(*c[:6]), dict(causal=c[6], window=c[7], softcap=c[8])) for c in FLASH_CASES]
CASES.append(("gqa-rolling-local", _rolling_cache_inputs(), dict(causal=True, window=32, softcap=None)))
# rows with no valid key (S a multiple of no tile size, G = 3): the
# reference gives them the mean of V over the S slots
NO_VALID_KEY = [
    ("no-valid-key-prefill", _late_keys_inputs(), dict(causal=True, window=None, softcap=None)),
    ("no-valid-key-decode-window", _window_out_inputs(), dict(causal=True, window=16, softcap=None)),
]
CASES += NO_VALID_KEY
CASES += [
    ("wrapped-rolling-hd128", _wrapped_rolling_inputs(128, 6, 2), dict(causal=True, window=24, softcap=None)),
    ("wrapped-rolling-hd256", _wrapped_rolling_inputs(256, 4, 2, T=3), dict(causal=True, window=24, softcap=50.0)),
    ("prefill-4133", _long_prefill_inputs(), dict(causal=True, window=None, softcap=None)),
]


@pytest.mark.parametrize("case,arrays,kw", CASES, ids=[str(c[0]) for c in CASES])
def test_plain_flash_matches_reference_xla_path(case, arrays, kw):
    got = flash.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    want = ref_flash(*(jnp.asarray(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case,arrays,kw", CASES, ids=[str(c[0]) for c in CASES])
def test_plain_flash_matches_reference_pallas_kernel(case, arrays, kw):
    got = flash.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    want = flash_attention_pallas(*(jnp.asarray(a) for a in arrays), **kw, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_no_valid_key_rows_are_the_mean_of_v():
    """What the reference gives a row with no valid key: every score is
    -1e30, so every p is exp(0) = 1 and the row is the mean of V over the
    S slots; the plain version gives the same."""
    for _, arrays, kw in NO_VALID_KEY:
        q, k, v, qp, kp = arrays
        want = np.asarray(ref_flash(*(jnp.asarray(a) for a in arrays), **kw))
        got = flash.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
        ok = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
        if kw["window"] is not None:
            ok &= kp[:, None, :] > qp[:, :, None] - kw["window"]
        none = ~ok.any(-1)  # (B, T)
        assert none.any() and (~none).any()
        mean = np.repeat(v.mean(axis=1), q.shape[2] // v.shape[2], axis=1)  # (B, H, hd)
        for b, t in zip(*np.nonzero(none)):
            np.testing.assert_allclose(want[b, t], mean[b], atol=1e-6)
            np.testing.assert_allclose(got[b, t], mean[b], atol=1e-6)


def _bf16_torch(a):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("case,arrays,kw", NO_VALID_KEY, ids=[c[0] for c in NO_VALID_KEY])
def test_plain_flash_bf16_no_valid_key_matches_reference(case, arrays, kw, path):
    """The same rows in bf16, against both reference paths in bf16."""
    got = flash.flash_attention_plain(*(_bf16_torch(a) for a in arrays), **kw)
    jx = [jnp.asarray(a, dtype=jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a) for a in arrays]
    want = ref_flash(*jx, **kw) if path == "xla" else flash_attention_pallas(*jx, **kw, interpret=True)
    d = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_plain_flash_chunking_does_not_change_the_result():
    """The KV chunk is the plain version's block size, not part of the
    function: chunks of 1024, 64 and 7 agree."""
    arrays, kw = CASES[1][1], CASES[1][2]
    q, k, v, qp, kp = (torch.from_numpy(a) for a in arrays)
    want = flash.flash_attention_plain(q, k, v, qp, kp, **kw)
    for chunk in (64, 7):
        got = flash.flash_attention_plain(q, k, v, qp, kp, **kw, kv_chunk=chunk)
        torch.testing.assert_close(got, want, **TOL)


def test_cpu_tensors_take_the_plain_version():
    arrays, kw = CASES[0][1], CASES[0][2]
    before = flash.launches
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrays), **kw)
    assert flash.launches == before
    want = flash.flash_attention_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        meta = [torch.from_numpy(a).to("meta") for a in arrays]
        ops.flash_attention(*meta, **kw)


def test_kernel_wrapper_refuses_before_building():
    """The wrapper checks type, head_dim and shapes before it loads the
    kernel: what the kernel cannot take never reaches it."""
    pos = torch.zeros((1, 4), dtype=torch.int32)
    q = torch.zeros((1, 4, 2, 96))
    with pytest.raises(ValueError, match="head_dim 96"):
        flash.flash_attention_cuda(q, q, q, pos, pos, causal=True, window=None, softcap=None)
    h = torch.zeros((1, 4, 2, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.flash_attention_cuda(h, h, h, pos, pos, causal=True, window=None, softcap=None)
    q, kv = torch.zeros((1, 4, 3, 64)), torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="shapes"):  # 3 query heads over 2 kv heads
        flash.flash_attention_cuda(q, kv, kv, pos, pos, causal=True, window=None, softcap=None)
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_cuda(q, q.transpose(1, 2), q, pos, pos, causal=True, window=None, softcap=None)

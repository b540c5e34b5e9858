"""The port's plain flash attention against the reference's two paths.

``repro_torch.kernels.flash.flash_attention_plain`` (what CPU tensors run,
and what the CUDA kernel is held to on the card) against
``repro.models.layers.flash_attention`` (the XLA chunk scan) and
``repro.kernels.flash.flash_attention_pallas`` in interpret mode, on the
reference's own FLASH_CASES plus a GQA decode against a rolling local cache.
Float32 at atol 3e-5 / rtol 1e-4, the reference's kernel tolerance
(``tests/test_kernels.py``)."""

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


CASES = [(c, _case_inputs(*c[:6]), dict(causal=c[6], window=c[7], softcap=c[8])) for c in FLASH_CASES]
CASES.append(("gqa-rolling-local", _rolling_cache_inputs(), dict(causal=True, window=32, softcap=None)))


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

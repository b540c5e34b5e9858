"""The port's checkpointer against the reference's, on the CPU.

Both write the same layout (``step_%08d`` directories, one ``.npy`` a leaf
named by the CRC32 of its key, ``MANIFEST.json``), so a checkpoint written
by either restores in the other: every leaf bit for bit, bf16 included, and
the two packages' manifests and leaf files are identical for the same
tree."""

import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.models.model import Transformer, init_params


def _numpy_tree(seed: int = 0) -> dict:
    """A pytree of numpy leaves as the reference's trainer holds them:
    bf16 (ml_dtypes), float32, int32, a 0-d step, nested lists and tuples."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": np.asarray(jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)),
                   "b": rng.normal(size=(4,)).astype(np.float32),
                   "blocks": [{"scale": rng.normal(size=(2,)).astype(np.float32)},
                              {"scale": np.asarray(jnp.asarray(rng.normal(size=(2,)), jnp.bfloat16))}]},
        "opt": {"step": np.asarray(7, np.int32), "mu": (rng.normal(size=(5,)).astype(np.float32), rng.integers(0, 9, (2, 2)).astype(np.int32))},
    }


def _torch_leaf(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.cpu().numpy()
    return np.frombuffer(np.ascontiguousarray(x).tobytes(), np.uint8)


def _leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_a_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _numpy_tree()
    ref_save(str(tmp_path), 3, tree)
    got = restore(str(tmp_path), 3, tree, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got, is_leaf=lambda x: isinstance(x, torch.Tensor))) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tree))
    for want, leaf in zip(jax.tree.leaves(tree), _leaves(got)):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        assert tuple(leaf.shape) == want.shape
        assert (leaf.dtype == torch.bfloat16) == (want.dtype.name == "bfloat16")
        assert np.array_equal(_bits(leaf), _bits(want))


def test_a_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    tree = _numpy_tree(1)
    port_tree = jax.tree.map(_torch_leaf, tree)
    save(str(tmp_path), 5, port_tree)
    got = ref_restore(str(tmp_path), 5, jax.eval_shape(lambda: tree))
    for want, leaf in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert leaf.dtype == want.dtype and leaf.shape == want.shape
        assert np.array_equal(_bits(np.asarray(leaf)), _bits(want))


def test_both_packages_write_the_same_files(tmp_path):
    """The same tree saved by each package: identical MANIFEST.json leaves
    and identical ``.npy`` files."""
    tree = _numpy_tree(2)
    a = ref_save(str(tmp_path / "ref"), 9, tree)
    b = save(str(tmp_path / "port"), 9, jax.tree.map(_torch_leaf, tree))
    ma, mb = (json.load(open(os.path.join(d, "MANIFEST.json"))) for d in (a, b))
    assert ma == mb and list(ma["leaves"]) == list(mb["leaves"])
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert open(os.path.join(a, f), "rb").read() == open(os.path.join(b, f), "rb").read(), f
    assert ma["leaves"]["params|w"]["dtype"] == "bfloat16"


def test_a_model_state_dict_round_trips(tmp_path):
    """A reduced bf16 model's state_dict (an OrderedDict) into a meta
    model's structure, every tensor bit for bit."""
    cfg = get_config("qwen2-vl-72b").reduced()
    sd = init_params(cfg, seed=0, device="cpu").state_dict()
    d = save(str(tmp_path), 1, {"params": sd, "step": torch.tensor(1, dtype=torch.int32)})
    keys = json.load(open(os.path.join(d, "MANIFEST.json")))["leaves"]
    assert list(keys)[:len(sd)] == [f"params|{k}" for k in sd]  # the state_dict's own order
    like = {"params": Transformer(cfg, seed=None, device="meta").state_dict(), "step": torch.zeros(())}
    got = restore(str(tmp_path), 1, like, device="cpu")
    assert isinstance(got["params"], collections.OrderedDict) and list(got["params"]) == list(sd)
    for k, t in sd.items():
        assert got["params"][k].dtype == t.dtype and torch.equal(got["params"][k], t), k
    assert int(got["step"]) == 1


def test_latest_step_skips_an_unfinished_write(tmp_path):
    tree = jax.tree.map(_torch_leaf, _numpy_tree())
    assert latest_step(str(tmp_path / "none")) is None
    save(str(tmp_path), 1, tree)
    save(str(tmp_path), 5, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed write
    assert latest_step(str(tmp_path)) == 5


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_corrupted_leaf_raises(tmp_path, writer):
    tree = _numpy_tree()
    d = (save(str(tmp_path), 2, jax.tree.map(_torch_leaf, tree)) if writer == "port"
         else ref_save(str(tmp_path), 2, tree))
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    path = os.path.join(d, victim)
    raw = np.load(path)
    flipped = raw.view(np.uint8).copy()
    flipped[0] ^= 0xFF
    np.save(path, flipped.view(raw.dtype).reshape(raw.shape))
    with pytest.raises(IOError, match="checksum"):
        restore(str(tmp_path), 2, tree, device="cpu")


def test_a_shape_mismatch_raises(tmp_path):
    tree = _numpy_tree()
    save(str(tmp_path), 3, jax.tree.map(_torch_leaf, tree))
    bad = jax.tree.map(lambda a: a, tree)
    bad["params"]["w"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), 3, bad, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), 3, {"params": {"absent": np.zeros(1)}}, device="cpu")


@pytest.mark.parametrize("keep", [1, 2])
def test_async_checkpointer_keeps_the_last_steps(tmp_path, keep):
    tree = jax.tree.map(_torch_leaf, _numpy_tree())
    ck = AsyncCheckpointer(str(tmp_path), keep=keep)
    for s in (1, 2, 3, 4):
        tree["opt"]["step"] = torch.tensor(s, dtype=torch.int32)
        ck.save(s, tree)
        tree["opt"]["step"] += 100  # the snapshot was taken before save returned
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [1, 2, 3, 4][-keep:]
    got = restore(str(tmp_path), 4, tree, device="cpu")
    assert int(got["opt"]["step"]) == 4
    assert torch.equal(got["params"]["w"], tree["params"]["w"])


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker), keep=2)
    ck.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def test_restore_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    tree = {"x": torch.arange(4)}
    save(str(tmp_path), 1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), 1, tree)
    assert torch.equal(restore(str(tmp_path), 1, tree, device="cpu")["x"], tree["x"])

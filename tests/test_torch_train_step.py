"""The port's train step against the reference's ``make_train_step``, and
the reference's training properties (``tests/test_train.py``) on the port,
on the CPU at ``reduced()`` sizes in float32.

Three steps on the same batches (``SyntheticLMData``'s, bit for bit alike
in both packages) from the same weights, with ``accum_steps`` 1 and 2.
After each: the loss, ce and ``grad_norm`` within 1e-4 relative (the
gradients' tolerance), ``lr`` within 1e-6, the MoE aux loss within 1e-5
(0 on both sides under accumulation); ``mu`` within 1e-4 of each
leaf's max |mu| and ``nu`` within 2e-4 of its max |nu| (the gradients',
and twice it for their squares).  The parameters: all but 1e-4 of the
elements within 1e-5 (1e-4 of the largest |p|), and every one within
twice the sum of the learning rates.  Adam's first update is the
gradient's sign times lr, so an element whose gradient lies within the
gradients' tolerance of zero may move the other way (2 of 102,720 in
reduced llama3.2-3b, by 0.17 lr), and nothing bounds it closer than
that.

rwkv6-1.6b is held step by step: before each step the port takes the
reference's parameters and moments, and the step is held to the same
tolerances.  Its three-step trajectory is not compared, because the
reference's own float32 rounding leaves it: Adam's first update moves a
few elements whose gradient lies near Adam's eps (g / (|g| + eps) follows
g's last bits) apart by a fraction of lr, and the recurrence's decays carry
that into the next gradients.  ``test_rwkv6_port_follows_its_float64_run``
is the arbiter: against a float64 run of the port's own path from the same
weights, the port's mu stays within 2.5e-5 of each leaf's max over three
steps, the reference's reaches 2.3e-3 (CPU, float32; ``pytest -s`` prints
them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.models.convert import params_from_jax
from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step
from repro_torch.train.train_step import _split_batch
from test_torch_train_grads import lm_batch, pair

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    assert (got.float() - want).abs().max().item() <= rtol * max(want.abs().max().item(), 1e-30)


def _port_tree(cfg, tree) -> dict[str, torch.Tensor]:
    return params_from_jax(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), tree))


def _take(state: dict, cfg, rstate) -> None:
    """The reference's parameters and moments into the port's state, in place."""
    with torch.no_grad():
        for mine, theirs in ((state["params"], rstate["params"]), (state["opt"]["mu"], rstate["opt"]["mu"]),
                             (state["opt"]["nu"], rstate["opt"]["nu"])):
            for n, t in _port_tree(cfg, theirs).items():
                mine[n].copy_(t)


def compare_steps(name: str, accum: int, batches, resync: bool = False, **changes):
    """``resync``: each step starts from the reference's state (see the
    module docstring); otherwise the two trajectories run apart."""
    rcfg, params, cfg, model = pair(name, **changes)
    rstate = ref_init_train_state(params, RefOptimizerConfig(**OPT))
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(accum_steps=accum, optimizer=RefOptimizerConfig(**OPT))))
    state = init_train_state(model, OptimizerConfig(**OPT))
    step = make_train_step(cfg, TrainConfig(accum_steps=accum, optimizer=OptimizerConfig(**OPT)), model)
    lr_sum = 0.0
    for batch in batches:
        if resync:
            _take(state, cfg, rstate)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert abs(float(m[key]) - float(rm[key])) <= 1e-4 * abs(float(rm[key])), key
        assert abs(float(m["lr"]) - float(rm["lr"])) <= 1e-6 * float(rm["lr"])
        if accum == 1:  # the MoE aux loss (0 without MoE layers)
            assert abs(float(m["aux"]) - float(rm["aux"])) <= 1e-5 * abs(float(rm["aux"]))
        else:  # 0 under accumulation, as in the reference
            assert float(m["aux"]) == float(rm["aux"]) == 0.0
        assert int(state["step"]) == int(rstate["step"]) == int(state["opt"]["step"])
        lr_sum += float(m["lr"])
        for mine, theirs, rtol in ((state["opt"]["mu"], rstate["opt"]["mu"], 1e-4),
                                   (state["opt"]["nu"], rstate["opt"]["nu"], 2e-4)):
            want = _port_tree(cfg, theirs)
            for n, t in mine.items():
                _close(t, want[n], rtol)
        want = _port_tree(cfg, rstate["params"])
        d = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in state["params"].items()])
        assert (d > 1e-5).float().mean().item() <= 1e-4 and d.max().item() <= 2 * lr_sum
    return state


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b", "qwen3-moe-235b-a22b", "rwkv6-1.6b",
                                  "recurrentgemma-2b"])
def test_three_steps_match_reference(name, accum):
    cfg = pair(name)[2]
    compare_steps(name, accum, [lm_batch(cfg, step=i) for i in range(3)], resync=name == "rwkv6-1.6b")


def test_rwkv6_port_follows_its_float64_run(monkeypatch):
    """Reduced rwkv6-1.6b, three steps from the same weights: the port in
    float32, the reference in float32, and the port's own CPU path in
    float64 (its parameters, moments, casts and states, ``.float()``
    included).  After each step each package's mu against the float64
    one, of each leaf's max: the port within 1e-4, and no farther than the
    reference (which leaves the trajectory at step 2, module
    docstring)."""
    import copy

    from repro_torch.models import layers
    from repro_torch.train import optimizer

    rcfg, params, cfg, model = pair("rwkv6-1.6b")
    model64 = copy.deepcopy(model).double()
    rstate = ref_init_train_state(params, RefOptimizerConfig(**OPT))
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(optimizer=RefOptimizerConfig(**OPT))))
    state = init_train_state(model, OptimizerConfig(**OPT))
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**OPT)), model)
    batches = [lm_batch(cfg, step=i) for i in range(3)]
    mus = []
    for batch in batches:
        rstate, _ = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, _ = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        mus.append(({n: t.clone() for n, t in state["opt"]["mu"].items()}, _port_tree(cfg, rstate["opt"]["mu"])))
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.to(torch.float64))
    monkeypatch.setitem(layers._DTYPES, "float32", torch.float64)
    monkeypatch.setitem(optimizer._MOMENT_DTYPES, "float32", torch.float64)
    state64 = init_train_state(model64, OptimizerConfig(**OPT))
    step64 = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**OPT)), model64)
    for i, batch in enumerate(batches):
        state64, _ = step64(state64, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        exact = state64["opt"]["mu"]
        assert all(t.dtype == torch.float64 for t in exact.values())

        def worst(mu: dict) -> float:
            return max(((mu[n].double() - e).abs().max() / e.abs().max()).item() for n, e in exact.items())

        port, ref = worst(mus[i][0]), worst(mus[i][1])
        print(f"step {i + 1}: mu off the float64 run's by {port:.3e} (port), {ref:.3e} (reference)")
        assert port <= 1e-4 and port <= ref


def test_split_batch_splits_mrope_rows_on_the_batch_axis():
    batch = {"tokens": torch.arange(24).view(4, 6), "mrope_positions": torch.arange(72).view(3, 4, 6)}
    micro = _split_batch(batch, 2)
    assert len(micro) == 2
    assert torch.equal(micro[1]["tokens"], batch["tokens"][2:])
    assert torch.equal(micro[1]["mrope_positions"], batch["mrope_positions"][:, 2:])


def _setup(accum=1, moment_dtype="float32"):
    """The reference test's setup on the port: reduced llama3.2-3b (bf16),
    peak lr 1e-3, B 8 x T 32 from seed 1."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.model import init_params

    cfg = get_config("llama3.2-3b").reduced()
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50, moment_dtype=moment_dtype)
    model = init_params(cfg, seed=0, device="cpu")
    state = init_train_state(model, opt)
    step = make_train_step(cfg, TrainConfig(accum_steps=accum, optimizer=opt), model)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=1))
    return cfg, model, state, step, data


def _batch(data, i):
    return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}


def test_accumulation_equivalence():
    """accum 1 and 4 give (nearly) the same update on one batch: within a
    couple of bf16 steps, as the reference's test holds it."""
    _, _, s1, step1, data = _setup(accum=1)
    _, _, s4, step4, _ = _setup(accum=4)
    n1, m1 = step1(s1, _batch(data, 0))
    n4, m4 = step4(s4, _batch(data, 0))
    assert np.isclose(float(m1["loss"]), float(m4["loss"]), rtol=5e-3)
    for name, a in n1["params"].items():
        np.testing.assert_allclose(a.detach().float().numpy(), n4["params"][name].detach().float().numpy(),
                                   rtol=5e-2, atol=2.5e-3)


def test_loss_decreases():
    _, _, state, step, data = _setup()
    losses = []
    for i in range(40):
        state, metrics = step(state, _batch(data, i))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses[:3] + losses[-3:]


def test_grad_clipping_and_lr_schedule():
    from repro_torch.train.optimizer import schedule
    from repro_torch.train.train_step import make_loss_fn

    opt = OptimizerConfig(peak_lr=1e-2, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(schedule(opt, torch.tensor(0))) == 0.0
    assert np.isclose(float(schedule(opt, torch.tensor(10))), 1e-2, rtol=1e-2)
    assert float(schedule(opt, torch.tensor(100))) >= 1e-3 - 1e-9
    # clip_norm far below the gradient's norm: the first moment takes the
    # clipped gradient, (1 - b1) g clip_norm / |g|
    cfg, model, state, _, data = _setup()
    clip = OptimizerConfig(clip_norm=1e-3)
    batch = _batch(data, 0)
    loss, _ = make_loss_fn(cfg)(model, batch)
    grads = torch.autograd.grad(loss, list(state["params"].values()))
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    step = make_train_step(cfg, TrainConfig(optimizer=clip), model)
    state, m = step(state, batch)
    assert float(m["grad_norm"]) > 100 * clip.clip_norm
    torch.testing.assert_close(m["grad_norm"], gnorm, rtol=1e-5, atol=0.0)
    for (name, mu), g in zip(state["opt"]["mu"].items(), grads):
        torch.testing.assert_close(mu, 0.1 * g.float() * (clip.clip_norm / m["grad_norm"]), rtol=1e-5, atol=1e-12)


def test_moment_dtype_bf16():
    _, _, state, step, data = _setup(moment_dtype="bfloat16")
    assert all(a.dtype == torch.bfloat16 for a in state["opt"]["mu"].values())
    new_state, m = step(state, _batch(data, 0))
    assert np.isfinite(float(m["loss"]))
    assert all(a.dtype == torch.bfloat16 for a in new_state["opt"]["mu"].values())

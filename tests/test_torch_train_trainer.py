"""The port's trainer and training launcher on the CPU: restart from the
latest checkpoint after an injected failure, bit for bit the uninterrupted
run (the data are deterministic in (seed, step), the state is saved
whole), and the k-Segments predictor watching the run."""

import math

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.distributed.fault_tolerance import run_with_recovery
from repro_torch.launch import train as launch_train
from repro_torch.train import OptimizerConfig, TrainConfig, Trainer, TrainerConfig


def _run(ckpt_dir, fail_at_step=None):
    cfg = get_config("llama3.2-3b").reduced()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = TrainerConfig(steps=12, checkpoint_every=5, checkpoint_dir=str(ckpt_dir), monitor_interval_s=0.01,
                       monitor_task_steps=4, log_every=2)
    train_cfg = TrainConfig(optimizer=OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12))
    fails = [fail_at_step] if fail_at_step else []
    trainers = []

    def make():
        trainers.append(Trainer(cfg, data_cfg, train_cfg, tc, fail_at_step=fails.pop(0) if fails else None,
                                device="cpu"))
        return trainers[-1]

    state, restarts = run_with_recovery(make)
    return state, restarts, trainers


def _leaves(state):
    return {"step": state["step"], "opt.step": state["opt"]["step"],
            **{f"params.{n}": p for n, p in state["params"].items()},
            **{f"mu.{n}": t for n, t in state["opt"]["mu"].items()},
            **{f"nu.{n}": t for n, t in state["opt"]["nu"].items()}}


def test_restart_reproduces_the_uninterrupted_run(tmp_path):
    state, restarts, trainers = _run(tmp_path / "failing", fail_at_step=7)
    want, clean_restarts, _ = _run(tmp_path / "clean")
    assert restarts == 1 and clean_restarts == 0
    assert int(state["step"]) == 12
    got, ref = _leaves(state), _leaves(want)
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert torch.equal(t.detach(), ref[name].detach()), name
    log = trainers[-1].metrics_log
    assert [m["step"] for m in log] == [6, 8, 10, 12] and all(math.isfinite(m["loss"]) for m in log)
    plan = trainers[-1].memory_plan()
    assert len(plan.values) >= 1 and (plan.values > 0).all()


def test_launcher_trains_on_cpu(tmp_path):
    res = launch_train.main(["--steps", "12", "--fail-at", "5", "--seq-len", "32", "--global-batch", "4",
                             "--ckpt", str(tmp_path), "--device", "cpu"])
    assert res["restarts"] == 1 and res["step"] == 12
    assert res["log"] and all(math.isfinite(m["loss"]) for m in res["log"])
    assert all(p.device.type == "cpu" for p in res["state"]["params"].values())

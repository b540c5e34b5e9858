"""Training launcher.

Port of ``repro.launch.train``: the same trainer, checkpoint, recovery and
monitoring stack, on the reduced config by default.  Runs on the CUDA card
unless given ``--device cpu``; the port runs on one card, so the
reference's ``--distributed`` (``jax.distributed.initialize`` on a fleet)
has no counterpart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.distributed.fault_tolerance import run_with_recovery
from repro_torch.train import OptimizerConfig, TrainConfig, Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reduced config (on by default, as in the reference)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.global_batch)
    tc = TrainerConfig(
        steps=args.steps,
        checkpoint_every=max(args.steps // 3, 10),
        checkpoint_dir=args.ckpt or os.path.join(tempfile.gettempdir(), f"repro_torch_{cfg.name}"),
        log_every=max(args.steps // 10, 1),
    )
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    fails = [args.fail_at] if args.fail_at else []
    trainers = []

    def make_trainer():
        t = Trainer(cfg, data_cfg, TrainConfig(accum_steps=args.accum, optimizer=opt), tc,
                    fail_at_step=fails.pop(0) if fails else None, device=args.device)
        trainers.append(t)
        return t

    state, restarts = run_with_recovery(make_trainer)
    step = int(state["step"])
    print(f"done: step {step}, {restarts} restart(s)")
    log = [m for t in trainers for m in t.metrics_log]
    for m in trainers[-1].metrics_log[-5:]:
        print(f"  step {m['step']:5d} loss {m['loss']:.4f} ({m['time_s'] * 1e3:.0f} ms)")
    return {"step": step, "restarts": restarts, "state": state, "log": log}


if __name__ == "__main__":
    main()

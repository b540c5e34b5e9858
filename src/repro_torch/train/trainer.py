"""The training loop: the train step, asynchronous checkpoints,
restart-on-failure, and the paper's predictor watching the run.

Port of ``repro.train.trainer``.  k-Segments in the loop, as in the
reference:
* a ``MemoryMonitor`` records the host RSS series of every N-step training
  "task" into the ``TimeSeriesStore`` (the paper's monitoring pipe);
* the ``MemoryPredictorService`` learns the per-task (runtime, memory)
  models online; ``memory_plan`` is the step-function allocation a launcher
  would reserve for the next task;
* a ``StragglerDetector`` reuses the runtime half of the k-Segments model:
  steps slower than the predicted runtime plus offset by a factor are
  flagged.

The reference jits its step and donates the state to it; eager PyTorch has
no counterpart of either, and the port's step updates the state in place.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import uuid

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import StepAllocation
from repro_torch.core.predictor import MemoryPredictorService
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, make_host_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import SimulatedFailure, StragglerDetector
from repro_torch.models.model import Transformer
from repro_torch.monitoring import MemoryMonitor, TimeSeriesStore
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    monitor_interval_s: float = 0.25
    monitor_task_steps: int = 10  # steps per monitored "workflow task"
    log_every: int = 10
    seed: int = 0


class Trainer:
    """Trains ``cfg`` on synthetic data from ``data_cfg`` on ``device``
    (default: the CUDA card; raises without one)."""

    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        train_cfg: TrainConfig | None = None,
        trainer_cfg: TrainerConfig | None = None,
        fail_at_step: int | None = None,  # fault injection for tests and examples
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.tc = trainer_cfg or TrainerConfig()
        self.fail_at_step = fail_at_step
        self.data = SyntheticLMData(data_cfg)
        self.store = TimeSeriesStore(interval_s=self.tc.monitor_interval_s)
        self.predictor = MemoryPredictorService(method="ksegments-selective")
        self.straggler = StragglerDetector()
        self.ckpt = AsyncCheckpointer(self.tc.checkpoint_dir)
        self.metrics_log: list[dict] = []

    # -- state ------------------------------------------------------------

    def init_or_restore(self):
        """(model, state, start step): the model drawn from ``tc.seed``, its
        train state, and, where the checkpoint directory holds one, the
        latest checkpoint's state copied into them."""
        model = Transformer(self.cfg, seed=self.tc.seed, device=self.device)
        state = init_train_state(model, self.train_cfg.optimizer)
        last = latest_step(self.tc.checkpoint_dir)
        if last is None:
            return model, state, 0
        saved = restore(self.tc.checkpoint_dir, last, state, device=self.device)
        with torch.no_grad():
            for live, kept in ((state["params"], saved["params"]), (state["opt"]["mu"], saved["opt"]["mu"]),
                               (state["opt"]["nu"], saved["opt"]["nu"])):
                for name, t in live.items():
                    t.copy_(kept[name])
        state["opt"]["step"], state["step"] = saved["opt"]["step"], saved["step"]
        return model, state, int(saved["step"])

    # -- main loop ----------------------------------------------------------

    def run(self):
        model, state, start = self.init_or_restore()
        step_fn = make_train_step(self.cfg, self.train_cfg, model)
        task_type = f"train:{self.cfg.name}"
        tokens_per_task = self.data_cfg.global_batch * self.data_cfg.seq_len * self.tc.monitor_task_steps
        step = start
        try:
            while step < self.tc.steps:
                # one monitored "workflow task" = monitor_task_steps train steps
                chunk_end = min(step + self.tc.monitor_task_steps, self.tc.steps)
                exec_id = f"{step}-{uuid.uuid4().hex[:6]}"
                with MemoryMonitor(self.store, task_type, exec_id, interval_s=self.tc.monitor_interval_s,
                                   input_size=tokens_per_task):
                    while step < chunk_end:
                        t0 = time.monotonic()
                        batch = make_host_batch(self.data, step, device=self.device)
                        state, metrics = step_fn(state, batch)
                        loss = float(metrics["loss"])
                        dt = time.monotonic() - t0
                        self.straggler.observe(task_type, float(self.data_cfg.seq_len * self.data_cfg.global_batch), dt)
                        step += 1
                        if self.fail_at_step is not None and step == self.fail_at_step:
                            self.fail_at_step = None  # fail once
                            raise SimulatedFailure(step)
                        if step % self.tc.log_every == 0 or step == self.tc.steps:
                            self.metrics_log.append({"step": step, "loss": loss, "time_s": dt})
                        if step % self.tc.checkpoint_every == 0:
                            self.ckpt.save(step, state)
                # feed the finished "task" to the paper's predictor
                series = self.store.series(task_type, exec_id)
                if len(series) >= 2:
                    self.predictor.observe(task_type, tokens_per_task, series)
            self.ckpt.save(step, state)
        finally:  # the last write lands, whether the run ends or fails
            self.ckpt.wait()
        return state

    def memory_plan(self) -> StepAllocation:
        """The k-Segments allocation the launcher would reserve for the next
        training task of this type (the 4,096 MiB default before any
        observation)."""
        task_type = f"train:{self.cfg.name}"
        tokens = self.data_cfg.global_batch * self.data_cfg.seq_len * self.tc.monitor_task_steps
        return self.predictor.predict(task_type, tokens, default_mib=4096.0)

"""Adaptive per-task k selection, the paper's stated future work (Sec. V:
"explore methods of finding k"; Sec. IV-E: "reoptimizing k on each
iteration during online learning appears to be an option").  Port of
``repro.core.ktuner``.

Every ``refresh`` observations the selector replays the task's stored
history under each candidate k through the batched engine
(``sim.torch_sim.simulate_task_methods``, whose inner loops are the segmax
and wastage kernels on the card) and adopts the wastage argmin.  The
history already holds the counterfactual (Fig. 8's wastage-vs-k curve,
recomputed online), so the replay needs no live failures.

The live predictor is a fresh host ``KSegmentsModel`` refit at the chosen k
from the same history, so it predicts as a model that had used that k all
along.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.device import resolve_device

DEFAULT_CANDIDATES = (1, 2, 4, 6, 8, 12)
# The default directive the replay starts from; it only sets the prediction
# before the first observation, which the training prefix masks.
_REPLAY_DEFAULT_MIB = 1024.0


class AdaptiveKSelector:
    """Online k tuner and predictor for one task type.  The replays run on
    the card unless ``device="cpu"``."""

    def __init__(
        self,
        candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
        refresh: int = 16,
        min_history: int = 8,
        config: KSegmentsConfig | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.candidates = candidates
        self.refresh = refresh
        self.min_history = min_history
        self.base = config or KSegmentsConfig()
        self.k = self.base.k
        self._x: list[float] = []
        self._series: list[np.ndarray] = []
        self._model = KSegmentsModel(self._cfg(self.k))
        self.history_k: list[int] = []

    def _cfg(self, k: int) -> KSegmentsConfig:
        return dataclasses.replace(self.base, k=k)

    # -- online protocol ----------------------------------------------------

    def observe(self, input_size: float, series_mib: np.ndarray) -> None:
        self._x.append(float(input_size))
        self._series.append(np.asarray(series_mib, dtype=np.float32))
        self._model.observe(input_size, series_mib)
        n = len(self._x)
        if n >= self.min_history and n % self.refresh == 0:
            best = self._reoptimize()
            self.history_k.append(best)
            if best != self.k:
                self.k = best
                self._model = KSegmentsModel(self._cfg(best))
                for x, s in zip(self._x, self._series):
                    self._model.observe(x, s)

    def predict(self, input_size: float):
        return self._model.predict(input_size)

    # -- the replay (Fig. 8 recomputed online) --------------------------------

    def _padded(self):
        B = len(self._series)
        T = max(len(s) for s in self._series)
        y = np.zeros((B, T), np.float32)
        lengths = np.zeros(B, np.int32)
        for i, s in enumerate(self._series):
            y[i, : len(s)] = s
            lengths[i] = len(s)
        return np.asarray(self._x), y, lengths

    def _reoptimize(self) -> int:
        """The candidate k with the least mean wastage over the history's
        second half, every execution predicted from the ones before it."""
        from repro_torch.sim.torch_sim import simulate_task_methods  # the engine imports core

        x, y, lengths = self._padded()
        n_train = max(len(x) // 2, 1)
        method = "ksegments-selective" if self.base.strategy == "selective" else "ksegments-partial"
        scores = {}
        for k in self.candidates:
            waste, _ = simulate_task_methods(
                x,
                y,
                lengths,
                _REPLAY_DEFAULT_MIB,
                methods=(method,),
                k=k,
                interval_s=self.base.interval_s,
                factor=self.base.retry_factor,
                floor_mib=self.base.floor_mib,
                device=self.device,
            )
            # the reference's float32 numpy mean, on the host
            scores[k] = float(waste[0, n_train:].cpu().numpy().mean())
        return min(scores, key=scores.get)

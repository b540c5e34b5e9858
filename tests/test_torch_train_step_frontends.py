"""The port's train step against the reference's for the modality
frontends, on the CPU at ``reduced()`` sizes in float32: hubert-xlarge
(audio frames, non-causal) and qwen2-vl-72b (patch embeddings, M-RoPE rows
split on their batch axis under accumulation), three steps with
``accum_steps`` 1 and 2, under ``test_torch_train_step``'s tolerances."""

import pytest

from test_torch_cuda import grid_positions
from test_torch_train_frontends import _bf16_normal, _labels
from test_torch_train_grads import B, T, lm_batch, pair
from test_torch_train_step import compare_steps


def _batches(name: str):
    cfg = pair(name)[2]
    if cfg.frontend == "audio_frames":
        return [{"features": _bf16_normal((B, T, cfg.frontend_dim), 10 + i), "labels": _labels(cfg, 20 + i)}
                for i in range(3)]
    return [dict(lm_batch(cfg, step=i), patch_embeds=_bf16_normal((B, cfg.num_patches, cfg.d_model), 30 + i),
                 mrope_positions=grid_positions(B, T, 2, 4)) for i in range(3)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-vl-72b"])
def test_three_steps_match_reference(name, accum):
    compare_steps(name, accum, _batches(name))

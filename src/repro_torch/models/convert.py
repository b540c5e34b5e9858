"""Carry the reference's parameters into the port.

``params_from_jax`` turns the parameter pytree of ``repro.models.
init_params`` (its leaves as numpy arrays: ``jax.tree.map(np.asarray,
params)``) into a ``state_dict`` of ``models.model.Transformer``:

* ``params["blocks"][str(i)]`` holds pattern slot ``i`` of every
  repetition, stacked on a leading axis; repetition ``r`` becomes layer
  ``r * len(pattern) + i``;
* ``params["tail"][str(j)]`` (the layers past the last whole repetition)
  becomes layer ``n_rep * len(pattern) + j``;
* the nested names (``attn/wq``, ``ln1/scale``, ...) are the modules' own;
* ``frontend_proj`` (the audio frontend's projection) keeps its name.

Weight layouts stay the reference's ``(in, out)``.  bf16 leaves arrive with
``ml_dtypes``' bfloat16 dtype, which ``torch.from_numpy`` refuses; they
travel as their 16-bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(prefix: str, tree: dict, out: dict, index: int | None = None) -> None:
    for name, leaf in tree.items():
        key = f"{prefix}.{name}"
        if isinstance(leaf, dict):
            _flatten(key, leaf, out, index)
        else:
            out[key] = _tensor(leaf if index is None else np.asarray(leaf)[index])


def params_from_jax(cfg: ModelConfig, params: dict) -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy leaves) -> the port's state_dict."""
    plen = len(cfg.block_pattern)
    n_rep = cfg.num_layers // plen
    out = {"embed": _tensor(params["embed"])}
    if "frontend_proj" in params:  # audio frames' projection
        out["frontend_proj"] = _tensor(params["frontend_proj"])
    for i in range(plen):
        for r in range(n_rep):
            _flatten(f"layers.{r * plen + i}", params["blocks"][str(i)], out, r)
    for j, tree in params["tail"].items():
        _flatten(f"layers.{n_rep * plen + int(j)}", tree, out)
    out["final_norm.scale"] = _tensor(params["final_norm"]["scale"])
    if "lm_head" in params:
        out["lm_head"] = _tensor(params["lm_head"])
    return out


def load_params(cfg: ModelConfig, params: dict, device=None) -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's parameters."""
    model = Transformer(cfg, seed=None, device=device)
    model.load_state_dict(params_from_jax(cfg, params), strict=True)
    return model.eval()

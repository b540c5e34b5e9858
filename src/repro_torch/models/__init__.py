# The language-model stack of the port (attention, MoE and recurrent
# layers); see models/model.py.
from repro_torch.models.model import Transformer, decode_step, forward, init_cache, init_params

__all__ = ["Transformer", "decode_step", "forward", "init_cache", "init_params"]

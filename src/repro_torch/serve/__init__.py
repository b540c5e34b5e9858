# Serving: prefill/decode step builders over the model's KV caches, and the
# beyond-paper application of the k-Segments predictor, segment-wise HBM
# admission control: the scalar oracle (AdmissionController), the batched
# engine (BatchedAdmissionController.try_admit_many, one decision-scan
# launch a batch on the card), the per-shard oracle
# (ShardedScalarController), and the arrival-stream serving simulator
# (repro_torch.serve.stream) that replays Poisson/bursty/diurnal workloads
# through any of them.  The carried-timeline ShardedAdmissionController is
# ROADMAP Queue 1 item 6(c).
from repro_torch.serve.admission import (
    AdmissionController,
    BatchedAdmissionController,
    RequestPlan,
    ShardedScalarController,
    cache_bytes_per_token,
    shard_of,
)
from repro_torch.serve.engine import greedy_generate, make_admission_controller, make_decode_step, make_prefill_step

__all__ = [
    "AdmissionController",
    "BatchedAdmissionController",
    "RequestPlan",
    "ShardedScalarController",
    "cache_bytes_per_token",
    "greedy_generate",
    "make_admission_controller",
    "make_decode_step",
    "make_prefill_step",
    "shard_of",
]

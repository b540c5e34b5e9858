# Serving: prefill/decode step builders over the model's KV caches, and the
# beyond-paper application of the k-Segments predictor, segment-wise HBM
# admission control: the scalar oracle (AdmissionController), the batched
# engine (BatchedAdmissionController.try_admit_many, one decision-scan
# launch a batch on the card), the per-shard oracle
# (ShardedScalarController), the carried-timeline sharded engine
# (ShardedAdmissionController, one admission_epoch launch a batch for every
# shard), and the arrival-stream serving simulator
# (repro_torch.serve.stream) that replays Poisson/bursty/diurnal workloads
# through any of them.
from repro_torch.serve.admission import (
    AdmissionController,
    BatchedAdmissionController,
    RequestPlan,
    ShardedAdmissionController,
    ShardedScalarController,
    cache_bytes_per_token,
    shard_of,
)
from repro_torch.serve.engine import greedy_generate, make_admission_controller, make_decode_step, make_prefill_step

__all__ = [
    "AdmissionController",
    "BatchedAdmissionController",
    "RequestPlan",
    "ShardedAdmissionController",
    "ShardedScalarController",
    "cache_bytes_per_token",
    "greedy_generate",
    "make_admission_controller",
    "make_decode_step",
    "make_prefill_step",
    "shard_of",
]

# Serving: prefill/decode step builders over the model's KV caches, and the
# beyond-paper application of the k-Segments predictor, segment-wise HBM
# admission control (the scalar AdmissionController; the batched and
# sharded controllers and the stream simulator are ROADMAP Queue 1 item 6).
from repro_torch.serve.admission import AdmissionController, RequestPlan, cache_bytes_per_token
from repro_torch.serve.engine import greedy_generate, make_admission_controller, make_decode_step, make_prefill_step

__all__ = [
    "AdmissionController",
    "RequestPlan",
    "cache_bytes_per_token",
    "greedy_generate",
    "make_admission_controller",
    "make_decode_step",
    "make_prefill_step",
]

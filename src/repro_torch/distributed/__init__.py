# Fault tolerance and straggler mitigation (driven by the paper's runtime
# model).  The reference's sharding rules (``repro.distributed.sharding``)
# and elastic re-meshing (``repro.distributed.elastic``) are not ported:
# they build TPU-pod meshes, and the port runs on one card.
from repro_torch.distributed.fault_tolerance import (
    SimulatedFailure,
    StragglerDetector,
    StragglerEvent,
    run_with_recovery,
)

__all__ = ["SimulatedFailure", "StragglerDetector", "StragglerEvent", "run_with_recovery"]

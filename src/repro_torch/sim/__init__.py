"""Traces, the sequential oracle (``simulator``), the two-phase evaluation
engine and its Fig. 7 and Fig. 8 entry points, and the cluster scheduler
(port of ``repro.sim``)."""

from repro_torch.sim.traces import (
    Execution,
    PaddedTaskBatch,
    TaskTrace,
    WorkflowTrace,
    generate_eager,
    generate_sarek,
    generate_suite,
    pack_traces,
)
from repro_torch.sim.cluster import ClusterResult, NodeState, TaskRecord, run_cluster, run_cluster_batched
from repro_torch.sim.simulator import SimConfig, TaskResult, run_execution, simulate_suite, simulate_task

__all__ = [
    "ClusterResult",
    "NodeState",
    "TaskRecord",
    "run_cluster",
    "run_cluster_batched",
    "Execution",
    "PaddedTaskBatch",
    "TaskTrace",
    "WorkflowTrace",
    "generate_eager",
    "generate_sarek",
    "generate_suite",
    "pack_traces",
    "SimConfig",
    "TaskResult",
    "run_execution",
    "simulate_suite",
    "simulate_task",
]

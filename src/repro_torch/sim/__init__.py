"""ClusterSim: trace-driven wall-clock x accuracy co-simulation.

trace (sim.traces) -> masks + step times (sim.cluster sync policies)
-> one batched decode per run (core.engine), and the decoded-gradient
path through dist.coded_allreduce (``ClusterSim.run_distributed``).
"""

from .cluster import (  # noqa: F401
    AdaptiveDeadline,
    BackupPolicy,
    ClusterRunResult,
    ClusterSim,
    DeadlinePolicy,
    POLICIES,
    SyncPolicy,
    WaitForAll,
    make_policy,
)
from .traces import (  # noqa: F401
    ChurnEvent,
    ChurnScenario,
    LatencyTrace,
    TRACE_SOURCES,
    make_churn_scenario,
    make_trace,
    trace_from_model,
)

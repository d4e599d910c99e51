"""The closed-loop adaptive-balancing subsystem on PyTorch (counterpart of
``repro.cluster``): :class:`EpochDriver`, the scenario and policy zoos,
and the per-epoch metrics."""

from repro_torch.cluster.epoch import ClusterConfig, EpochDriver
from repro_torch.cluster.metrics import (
    EpochMetrics,
    imbalance_stats,
    imbalance_stats_batch,
    latency_percentiles,
    latency_percentiles_batch,
    masked_p99_batch,
    p999_batch,
    summarize,
)
from repro_torch.cluster.policies import POLICIES, Policy, PolicyConfig, make_policy
from repro_torch.cluster.scenarios import (
    SCENARIOS,
    Scenario,
    ScenarioConfig,
    make_scenario,
)
from repro_torch.telemetry import SLO, MetricsConfig, TelemetryConfig

__all__ = [
    "ClusterConfig", "EpochDriver", "EpochMetrics", "imbalance_stats",
    "imbalance_stats_batch", "latency_percentiles", "latency_percentiles_batch",
    "masked_p99_batch", "p999_batch", "summarize", "POLICIES", "Policy",
    "PolicyConfig", "make_policy", "SCENARIOS", "Scenario", "ScenarioConfig",
    "make_scenario", "TelemetryConfig", "MetricsConfig", "SLO",
]

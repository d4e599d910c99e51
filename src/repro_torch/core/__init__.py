"""TurboKV core on PyTorch: keys, directory, routing, store, hop plans,
the DES timing engine, statistics, migration and the controller."""

from repro_torch.core import keys
from repro_torch.core.keys import OP_DEL, OP_GET, OP_PUT, OP_SCAN, hash_key
from repro_torch.core.directory import (
    Directory,
    lookup_range,
    make_directory,
    node_load,
    range_order,
)
from repro_torch.core.routing import (
    QueryBatch,
    RoutingDecision,
    expand_scans,
    make_queries,
    route,
    route_and_lookup,
    route_load_aware,
    route_load_aware_dirty,
)
from repro_torch.core.store import (
    Responses,
    StoreState,
    apply_routed,
    make_store,
    store_fill,
)
from repro_torch.core.coordination import (
    CLIENT_DRIVEN,
    IN_SWITCH,
    MODES,
    SERVER_DRIVEN,
    HopPlan,
    LatencyModel,
    ServiceModel,
    plan_hops,
    simulate_closed_loop_reference,
    simulate_reference,
)
from repro_torch.core import des
from repro_torch.core.des import simulate, simulate_closed_loop, stack_plans
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.migration import MigrationOp
from repro_torch.core.migration import execute as execute_migrations
from repro_torch.core.stats import (
    StatsReport,
    make_sketch,
    pull_report,
    sketch_query,
    sketch_update,
)
from repro_torch.core.hierarchy import PodTable, derive_pod_table, route_pod
from repro_torch.core.dist_store import DistConfig, make_dist_apply

__all__ = [
    "keys", "OP_GET", "OP_PUT", "OP_DEL", "OP_SCAN", "hash_key",
    "Directory", "make_directory", "lookup_range", "node_load", "range_order",
    "QueryBatch", "RoutingDecision", "route", "route_load_aware",
    "route_load_aware_dirty", "route_and_lookup", "expand_scans",
    "make_queries",
    "StoreState", "Responses", "make_store", "apply_routed", "store_fill",
    "LatencyModel", "ServiceModel", "HopPlan", "plan_hops",
    "simulate", "simulate_closed_loop", "simulate_reference",
    "simulate_closed_loop_reference", "stack_plans", "des",
    "IN_SWITCH", "CLIENT_DRIVEN", "SERVER_DRIVEN", "MODES",
    "Controller", "ControllerConfig", "MigrationOp", "execute_migrations",
    "StatsReport", "pull_report", "make_sketch", "sketch_update", "sketch_query",
    "PodTable", "derive_pod_table", "route_pod", "DistConfig", "make_dist_apply",
]

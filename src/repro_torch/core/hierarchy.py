"""Hierarchical indexing (counterpart of ``repro.core.hierarchy``, paper
§6): the AGG/Core switches hold reduced records (only the pod toward the
chain head or tail), the ToR switches the full per-pod directory.  The
pod-level table is derived state, recomputed from the leaf directory's
``node_addr`` registers after every reconfiguration.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys as K
from repro_torch.core.directory import Directory, lookup_range
from repro_torch.core.routing import QueryBatch


@dataclasses.dataclass(frozen=True)
class PodTable:
    """The AGG/Core reduced match-action table (per-record pod directions)."""

    head_pod: torch.Tensor  # (S,) int64 pod of each chain head (writes)
    tail_pod: torch.Tensor  # (S,) int64 pod of each chain tail (reads)
    num_pods: int


def derive_pod_table(directory: Directory, num_pods: int) -> PodTable:
    """Recompute the upper-level tables from the leaf directory.  A dead
    slot's NO_NODE head indexes the last node, as JAX's gather wraps -1."""
    pods = directory.node_addr[:, 0]
    return PodTable(head_pod=pods[directory.head()],
                    tail_pod=pods[directory.tail()], num_pods=num_pods)


def route_pod(table: PodTable, directory: Directory, q: QueryBatch) -> torch.Tensor:
    """Stage-1 routing at the AGG/Core level: matching value -> pod id (no
    chain header is attached here, exactly the paper's reduced records)."""
    mval = K.matching_value(q.key, hash_partitioned=directory.hash_partitioned)
    ridx = lookup_range(directory, mval)
    is_write = (q.opcode == K.OP_PUT) | (q.opcode == K.OP_DEL)
    return torch.where(is_write, table.head_pod[ridx], table.tail_pod[ridx])


def switch_topology(num_pods: int, n_switches: int | None = None) -> list[int]:
    """Propagation order of the coordination-tier switch chain: one ToR a
    pod plus one spine, spine first (chain position 0 holds the lease);
    ``n_switches`` overrides the derived ``num_pods + 1`` width."""
    w = n_switches if n_switches is not None else max(2, num_pods + 1)
    return list(range(w))


def pod_local_view(directory: Directory, pod: int) -> torch.Tensor:
    """(S,) mask of live records whose head or tail lives in this pod (the
    ToR working set)."""
    pods = directory.node_addr[:, 0]
    hit = (pods[directory.head()] == pod) | (pods[directory.tail()] == pod)
    return hit & directory.live

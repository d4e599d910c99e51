"""The slot-pool directory: match-action tables as device tensors
(counterpart of ``repro.core.directory``).

Carriers: spans and the statistics counters are int64 holding uint32
values (masked after every add); chains, chain lengths and the lineage
columns are int64 node / slot ids (``NO_NODE`` / ``NO_SLOT`` = -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K

NO_NODE = -1  # chain slot sentinel (spliced-out / absent replica)
NO_SLOT = -1  # parent sentinel (genesis range, not born by a split)

# dead-slot span sentinels: lo > hi can never match any matching value
DEAD_LO = np.uint32(K.MAX_KEY)
DEAD_HI = np.uint32(0)


@dataclasses.dataclass(frozen=True)
class Directory:
    """Slot-pool match-action table + forwarding and statistics registers.

    slot_lo, slot_hi: (S,) int64 inclusive span (DEAD_LO/DEAD_HI on dead
                      slots); live: (S,) bool; chains: (S, r_max) int64
                      node ids (head first, NO_NODE padded); chain_len:
                      (S,) int64; parent, generation: (S,) int64 lineage;
                      node_addr: (N, 2) int64; read_count, write_count:
                      (S,) int64 uint32 hit counters.
    """

    slot_lo: torch.Tensor
    slot_hi: torch.Tensor
    live: torch.Tensor
    chains: torch.Tensor
    chain_len: torch.Tensor
    parent: torch.Tensor
    generation: torch.Tensor
    node_addr: torch.Tensor
    read_count: torch.Tensor
    write_count: torch.Tensor
    hash_partitioned: bool = False

    @property
    def num_slots(self) -> int:
        return self.chains.shape[0]

    @property
    def r_max(self) -> int:
        return self.chains.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.node_addr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chains.device

    def head(self) -> torch.Tensor:
        """(S,) head node of each chain (write target)."""
        return self.chains[:, 0]

    def tail(self) -> torch.Tensor:
        """(S,) tail node of each chain (read target)."""
        idx = torch.clamp(self.chain_len - 1, min=0)
        return torch.gather(self.chains, 1, idx[:, None])[:, 0]


def directory_from_arrays(arrays: dict, *, hash_partitioned: bool,
                          device) -> Directory:
    """Build a :class:`Directory` on ``device`` from host numpy tables
    (the controller's layout, uint32 spans and counters)."""
    # torch.tensor copies: a CPU tensor must not alias the controller's
    # host tables, which it keeps editing in place
    def t(name):
        return torch.tensor(np.asarray(arrays[name]).astype(np.int64),
                            device=device)

    return Directory(
        slot_lo=t("slot_lo"), slot_hi=t("slot_hi"),
        live=torch.tensor(np.asarray(arrays["live"], bool), device=device),
        chains=t("chains"), chain_len=t("chain_len"), parent=t("parent"),
        generation=t("generation"), node_addr=t("node_addr"),
        read_count=t("read_count"), write_count=t("write_count"),
        hash_partitioned=hash_partitioned,
    )


def make_directory_arrays(num_ranges: int, num_nodes: int, replication: int,
                          *, num_pods: int = 1, r_max: int | None = None,
                          n_slots: int | None = None) -> dict:
    """Host numpy tables of the initial directory (see
    :func:`make_directory`)."""
    if replication > num_nodes:
        raise ValueError(f"replication {replication} > num_nodes {num_nodes}")
    r_max = replication if r_max is None else r_max
    if r_max < replication:
        raise ValueError(f"r_max {r_max} < replication {replication}")
    n_slots = num_ranges if n_slots is None else n_slots
    if n_slots < num_ranges:
        raise ValueError(f"n_slots {n_slots} < num_ranges {num_ranges}")

    edges = np.linspace(0, K.KEY_SPACE, num_ranges + 1)
    bounds = np.minimum(np.round(edges), K.KEY_SPACE - 1).astype(np.uint32)
    bounds[0] = 0
    slot_lo = np.full((n_slots,), DEAD_LO, dtype=np.uint32)
    slot_hi = np.full((n_slots,), DEAD_HI, dtype=np.uint32)
    slot_lo[:num_ranges] = bounds[:-1]
    slot_hi[: num_ranges - 1] = bounds[1:-1] - 1
    slot_hi[num_ranges - 1] = np.uint32(K.MAX_KEY)
    live = np.zeros((n_slots,), dtype=bool)
    live[:num_ranges] = True

    stride = max(1, num_nodes // replication)
    chains = np.full((n_slots, r_max), NO_NODE, dtype=np.int32)
    for i in range(num_ranges):
        for p in range(replication):
            chains[i, p] = (i + p * stride) % num_nodes
        seen: set[int] = set()
        for p in range(replication):
            n = int(chains[i, p])
            while n in seen:
                n = (n + 1) % num_nodes
            chains[i, p] = n
            seen.add(n)
    chain_len = np.zeros((n_slots,), dtype=np.int32)
    chain_len[:num_ranges] = replication

    nodes_per_pod = max(1, num_nodes // num_pods)
    node_addr = np.stack(
        [np.arange(num_nodes) // nodes_per_pod,
         np.arange(num_nodes) % nodes_per_pod],
        axis=1,
    ).astype(np.int32)
    return {
        "slot_lo": slot_lo, "slot_hi": slot_hi, "live": live,
        "chains": chains, "chain_len": chain_len,
        "parent": np.full((n_slots,), NO_SLOT, np.int32),
        "generation": np.zeros((n_slots,), np.int32),
        "node_addr": node_addr,
        "read_count": np.zeros((n_slots,), np.uint32),
        "write_count": np.zeros((n_slots,), np.uint32),
    }


def make_directory(
    num_ranges: int,
    num_nodes: int,
    replication: int = 3,
    *,
    hash_partitioned: bool = False,
    num_pods: int = 1,
    r_max: int | None = None,
    n_slots: int | None = None,
    device=None,
) -> Directory:
    """The initial directory: ``num_ranges`` equal sub-ranges, chains
    striped so every node serves every chain position; ``r_max`` chain
    and ``n_slots`` slot headroom as in the reference."""
    from repro_torch.device import resolve_device

    arrays = make_directory_arrays(
        num_ranges, num_nodes, replication, num_pods=num_pods, r_max=r_max,
        n_slots=n_slots,
    )
    return directory_from_arrays(arrays, hash_partitioned=hash_partitioned,
                                 device=resolve_device(device))


def lookup_range(directory: Directory, mvals: torch.Tensor) -> torch.Tensor:
    """Masked interval match (the plain form): the lowest live slot with
    ``slot_lo <= v <= slot_hi``, a total miss clamped to ``S - 1``."""
    v = K.u32(mvals.to(torch.int64))[..., None]
    hit = directory.live & (v >= directory.slot_lo) & (v <= directory.slot_hi)
    S = directory.num_slots
    iota = torch.arange(S, dtype=torch.int64, device=v.device)
    ridx = torch.where(hit, iota, S).amin(dim=-1)
    return torch.clamp(ridx, max=S - 1)


def range_order(directory: Directory) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-order view of the slot pool: (order, rank).  The sort is
    stable (dead slots keep index order at the tail), on CPU and CUDA."""
    S = directory.num_slots
    sort_key = torch.where(directory.live, directory.slot_lo, K.MAX_KEY)
    _, order = torch.sort(sort_key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(S, dtype=torch.int64, device=order.device)
    return order, rank


def chain_for(directory: Directory, ridx: torch.Tensor):
    """Fetch (chain, chain_len) action data for matched records (``ridx``
    lies in ``[0, S)``: every producer clamps it)."""
    return directory.chains[ridx], directory.chain_len[ridx]


def bump_counters(directory: Directory, ridx: torch.Tensor,
                  is_write: torch.Tensor) -> Directory:
    """One hit per matched record on the read or write counter."""
    S = directory.num_slots
    w = is_write.to(torch.int64)
    reads = torch.zeros(S, dtype=torch.int64, device=ridx.device)
    writes = torch.zeros(S, dtype=torch.int64, device=ridx.device)
    reads.index_add_(0, ridx, 1 - w)
    writes.index_add_(0, ridx, w)
    return dataclasses.replace(
        directory,
        read_count=K.u32(directory.read_count + reads),
        write_count=K.u32(directory.write_count + writes),
    )


def reset_counters(directory: Directory) -> Directory:
    z = torch.zeros_like(directory.read_count)
    return dataclasses.replace(directory, read_count=z, write_count=z.clone())


def wrap_node(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``.at[idx].add(..., mode="drop")`` first normalises a negative
    index numpy-style (``-1`` -> ``n - 1``) and only then drops what is out
    of range.  The reference relies on that for NO_NODE targets, which
    therefore charge node ``n - 1`` (ROADMAP fault F2); reproducing it
    keeps the port bit-identical."""
    return torch.where(idx < 0, idx + n, idx)


def node_load(directory: Directory) -> torch.Tensor:
    """Per-node load units from the counters: reads at the chain tail,
    writes at every live member.  Returns (N,) float32.

    Summed in int64 and converted once: the reference's float32 scatter
    sums of integer counts are exact below 2**24, where both agree."""
    r_max = directory.r_max
    n = directory.num_nodes
    dev = directory.chains.device
    member = torch.arange(r_max, device=dev)[None, :] < directory.chain_len[:, None]
    valid = member & (directory.chains != NO_NODE)
    safe = torch.where(valid, directory.chains, 0)
    wv = torch.where(valid, directory.write_count[:, None], 0)
    w = torch.zeros(n, dtype=torch.int64, device=dev)
    w.index_add_(0, safe.reshape(-1), wv.reshape(-1))
    r = torch.zeros(n, dtype=torch.int64, device=dev)
    r.index_add_(0, wrap_node(directory.tail(), n), directory.read_count)
    return w.to(torch.float32) + r.to(torch.float32)

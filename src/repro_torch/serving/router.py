"""Request/cache routing for serving (counterpart of
``repro.serving.router``).

Each request's KV cache lives on a storage shard chosen by the directory
(hash of the request id -> sub-range -> replica chain); the controller
migrates hot sequences off overloaded shards using the data-plane
counters (the paper's §5.1 load-balancing loop) and splices dead shards
out of the chains (§5.2); the router remembers the dead shards, so no
later migration lands on one.  The lookup runs K1 ``range_match`` on the card
(its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import directory as D
from repro_torch.core import keys as K
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.stats import pull_report
from repro_torch.kernels.range_match.ops import range_match


@dataclasses.dataclass
class SequenceRouter:
    directory: D.Directory
    period: int = 0
    failed: set[int] = dataclasses.field(default_factory=set)

    @classmethod
    def create(cls, n_shards: int, *, n_ranges: int | None = None,
               replication: int = 2, device=None):
        n_ranges = n_ranges or max(16, 8 * n_shards)
        directory = D.make_directory(n_ranges, n_shards, replication,
                                     hash_partitioned=True, device=device)
        return cls(directory=directory)

    def route(self, req_ids: np.ndarray, *, writes: bool = False):
        """req_ids (B,) -> (shard (B,), chain (B, r)) int32 numpy.  Reads
        route to the chain tail, writes (cache appends, migrations) to the
        head."""
        dev = self.directory.device
        keys = torch.tensor(np.asarray(req_ids).astype(np.int64) & K.MASK32,
                            device=dev)
        ops = torch.full(keys.shape, K.OP_PUT if writes else K.OP_GET,
                         dtype=torch.int32, device=dev)
        ridx, target, chain = range_match(self.directory, keys, ops)
        # bump the statistics registers (the switch would do this inline)
        self.directory = D.bump_counters(
            self.directory, ridx.long(),
            torch.full(ridx.shape, writes, dtype=torch.bool, device=dev))
        return target.cpu().numpy(), chain.T.cpu().numpy()

    def rebalance(self, controller_cfg: ControllerConfig | None = None):
        """Run the paper's §5.1 loop: pull counters -> greedy migration.

        Returns the migration ops (sequences to move between shards) and
        the report."""
        report, self.directory = pull_report(self.directory, self.period)
        self.period += 1
        ctl = self._controller(controller_cfg)
        ops = ctl.balance(report)
        self.directory = ctl.directory()
        return ops, report

    def fail_shard(self, shard: int):
        """Splice a dead shard out of every chain (paper §5.2)."""
        ctl = self._controller()
        ops = ctl.handle_node_failure(shard)
        self.failed = set(ctl.failed)
        self.directory = ctl.directory()
        return ops

    def _controller(self, config: ControllerConfig | None = None) -> Controller:
        """A controller over the current tables that knows the failed
        shards, so neither a rebalance nor a later repair places a range on
        one.  (The reference builds a fresh controller for each call, whose
        empty ``failed`` set lets the balancer migrate sequences onto a
        dead shard, ROADMAP F10.)"""
        ctl = Controller(self.directory, config)
        ctl.failed |= self.failed
        return ctl

"""The switch match-action hot path as CUDA kernels (K1 ``range_match``,
K2 ``range_match_spread``, K3 ``range_match_spread_dirty``, K4a
``slab_lookup``, K4b ``range_match_apply``, K5 ``range_match_stale``) with
their plain PyTorch versions."""

from repro_torch.kernels.range_match.kernel import launches, reset_launches
from repro_torch.kernels.range_match.ops import (
    pack_coord_tables,
    pack_dirty,
    pack_tables,
    range_match,
    range_match_apply,
    range_match_spread,
    range_match_spread_dirty,
    range_match_stale,
    slab_lookup,
)

__all__ = ["launches", "reset_launches", "pack_coord_tables", "pack_dirty",
           "pack_tables", "range_match", "range_match_apply",
           "range_match_spread", "range_match_spread_dirty",
           "range_match_stale", "slab_lookup"]

"""The switch match-action hot path as CUDA kernels (K1 ``range_match``,
K2 ``range_match_spread``, K4a ``slab_lookup``) with their plain PyTorch
versions."""

from repro_torch.kernels.range_match.kernel import launches, reset_launches
from repro_torch.kernels.range_match.ops import (
    pack_tables,
    range_match,
    range_match_spread,
    slab_lookup,
)

__all__ = ["launches", "reset_launches", "pack_tables", "range_match",
           "range_match_spread", "slab_lookup"]

"""YCSB-style key-value workload generator (paper §8 'Workloads').

A copy of ``repro_torch.data.ycsb`` for the port (numpy only).

Reproduces the paper's evaluation inputs: 16-byte keys (represented in the
uint32 matching-value space, DESIGN.md §2), 128-byte values (``value_dim``
float32 words), uniform or Zipf-skewed key popularity with the paper's
skew parameters (0.9, 0.95, 0.99, 1.2), and the standard YCSB op mixes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import keys as K

WORKLOAD_PRESETS = {
    # (read, update, insert, scan) ratios — standard YCSB letters
    "A": (0.5, 0.5, 0.0, 0.0),
    "B": (0.95, 0.05, 0.0, 0.0),
    "C": (1.0, 0.0, 0.0, 0.0),
    "D": (0.95, 0.0, 0.05, 0.0),
    "E": (0.0, 0.0, 0.05, 0.95),
    "F": (0.5, 0.5, 0.0, 0.0),
}


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_records: int = 4096          # preloaded keys
    n_ops: int = 8192
    distribution: str = "zipf"     # zipf | uniform
    zipf_theta: float = 0.99
    read_ratio: float = 1.0
    update_ratio: float = 0.0
    insert_ratio: float = 0.0
    scan_ratio: float = 0.0
    scan_span: int = 64            # key-space span of a scan
    value_dim: int = 32            # 128-byte values
    seed: int = 0

    @classmethod
    def preset(cls, letter: str, **kw) -> "WorkloadConfig":
        r, u, i, s = WORKLOAD_PRESETS[letter.upper()]
        return cls(read_ratio=r, update_ratio=u, insert_ratio=i, scan_ratio=s, **kw)

    @classmethod
    def mixed(cls, write_ratio: float, **kw) -> "WorkloadConfig":
        return cls(read_ratio=1 - write_ratio, update_ratio=write_ratio, **kw)


def _zipf_probs(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -theta
    return p / p.sum()


def record_keys(cfg: WorkloadConfig) -> np.ndarray:
    """The preloaded record key set, spread over the full key space."""
    rng = np.random.default_rng(cfg.seed)
    # distinct keys spread uniformly (sorted so ranges mean something)
    keys = rng.choice(np.uint64(K.KEY_SPACE - 2), size=cfg.n_records, replace=False)
    return np.sort(keys).astype(np.uint32)


def load_phase(cfg: WorkloadConfig):
    """(keys, values) to PUT before the run phase (YCSB load)."""
    rng = np.random.default_rng(cfg.seed + 1)
    keys = record_keys(cfg)
    values = rng.normal(size=(cfg.n_records, cfg.value_dim)).astype(np.float32)
    return keys, values


def run_phase(cfg: WorkloadConfig):
    """Generate the op stream: (opcodes, keys, end_keys, values, arrivals)."""
    rng = np.random.default_rng(cfg.seed + 2)
    keys = record_keys(cfg)

    # popularity: rank 1 = hottest; shuffle rank->key so heat is scattered
    if cfg.distribution == "zipf":
        probs = _zipf_probs(cfg.n_records, cfg.zipf_theta)
        perm = rng.permutation(cfg.n_records)
        key_idx = perm[rng.choice(cfg.n_records, size=cfg.n_ops, p=probs)]
    else:
        key_idx = rng.integers(0, cfg.n_records, size=cfg.n_ops)
    op_keys = keys[key_idx]

    ratios = np.array([cfg.read_ratio, cfg.update_ratio, cfg.insert_ratio, cfg.scan_ratio])
    ratios = ratios / ratios.sum()
    draws = rng.choice(4, size=cfg.n_ops, p=ratios)
    opcodes = np.select(
        [draws == 0, draws == 1, draws == 2, draws == 3],
        [K.OP_GET, K.OP_PUT, K.OP_PUT, K.OP_SCAN],
    ).astype(np.int32)
    # inserts use fresh keys
    fresh = rng.integers(0, K.KEY_SPACE - 2, size=cfg.n_ops, dtype=np.uint64).astype(np.uint32)
    op_keys = np.where(draws == 2, fresh, op_keys)

    end_keys = np.where(
        opcodes == K.OP_SCAN,
        np.minimum(op_keys.astype(np.uint64) + cfg.scan_span, K.KEY_SPACE - 2).astype(np.uint32),
        np.uint32(0),
    )
    values = rng.normal(size=(cfg.n_ops, cfg.value_dim)).astype(np.float32)
    arrivals = np.sort(rng.uniform(0, cfg.n_ops * 0.25, size=cfg.n_ops)).astype(np.float32)
    return opcodes, op_keys, end_keys, values, arrivals

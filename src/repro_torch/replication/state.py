"""Versioned chain-replication state, the CRAQ register file (counterpart
of ``repro.replication.state``).

The register file is three device tensors sized like the directory's slot
pool:

* ``version``    (S,)        committed (tail) version per slot record;
* ``acked``      (S, r_max)  highest committed version each chain position
  has seen the ack for; ``acked < version`` is the dirty bit;
* ``key_filter`` (S, F)      the hashed per-key dirty filter (F = 0 turns
  it off with zero storage).

Versions are uint32 counters carried in int64 tensors and masked to 32 bits
after every add (the port's uint32 carrier).  :func:`advance` is one
epoch's protocol round on the device; :func:`apply_events` replays the
controller's reconfiguration journal on the host (control plane, period
boundaries only) and puts the result back on the state's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import keys as K


@dataclasses.dataclass(frozen=True)
class ReplState:
    """version (S,) int64; acked (S, r_max) int64 (uint32 values);
    key_filter (S, F) bool."""

    version: torch.Tensor
    acked: torch.Tensor
    key_filter: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.version.shape[0]

    @property
    def r_max(self) -> int:
        return self.acked.shape[1]

    @property
    def filter_bits(self) -> int:
        return self.key_filter.shape[1]

    @property
    def device(self) -> torch.device:
        return self.version.device


def make_state(n_slots: int, r_max: int, filter_bits: int = 0, *,
               device=None) -> ReplState:
    """Fresh register file: version 0 everywhere, everything clean (the
    load phase commits before epoch 0)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return ReplState(
        version=torch.zeros(n_slots, dtype=torch.int64, device=dev),
        acked=torch.zeros((n_slots, r_max), dtype=torch.int64, device=dev),
        key_filter=torch.zeros((n_slots, filter_bits), dtype=torch.bool,
                               device=dev),
    )


def dirty_bits(state: ReplState) -> torch.Tensor:
    """(S, r_max) bool: position j of slot s holds a version not yet acked
    there.  The tail is exempted at the routing layer, not here."""
    return state.acked < state.version[:, None]


def advance(state: ReplState, ridx: torch.Tensor, is_write: torch.Tensor,
            keys: torch.Tensor | None = None) -> ReplState:
    """One epoch's protocol round: writes bump their slot's committed
    version, and the ack round for everything committed before this epoch
    completes, so the new dirty set is exactly the slots written now.
    Reads consult :func:`dirty_bits` of the state *before* this call.

    With a non-zero-width filter and the batch ``keys``, the filter is
    rebuilt from this epoch's writes alone.  Only the writes are
    scattered (every value True), so duplicate ``(slot, bit)`` pairs
    cannot race on the card."""
    S = state.num_slots
    w = torch.zeros(S, dtype=torch.int64, device=ridx.device)
    w.index_add_(0, ridx.to(torch.int64), is_write.to(torch.int64))
    acked = state.version[:, None].expand_as(state.acked).clone()
    kf = state.key_filter
    F = kf.shape[1]
    if F and keys is not None:
        hb = K.hash_key(keys) % F
        kf = torch.zeros_like(kf)
        kf[ridx[is_write].to(torch.int64), hb[is_write]] = True
    return ReplState(version=K.u32(state.version + w), acked=acked,
                     key_filter=kf)


def summary(state: ReplState) -> dict:
    """Host-side snapshot of the register file."""
    return summary_of(dirty_bits(state).cpu().numpy(),
                      state.version.cpu().numpy())


def summary_of(dirty: np.ndarray, version: np.ndarray) -> dict:
    """:func:`summary` of host copies of the dirty bits and versions."""
    return {
        "max_version": int(version.max()) if version.size else 0,
        "total_commits": int(version.sum()),
        "dirty_positions": int(dirty.sum()),
        "dirty_slots": int(dirty.any(axis=1).sum()),
    }


def apply_events(state: ReplState, events: list[tuple]) -> ReplState:
    """Replay a controller reconfiguration journal onto the register file
    (the grammar of ``Controller.repl_log``):

    * ``("reset", s)``      membership of slot s changed: zero its acks and
      set every filter bit (dirty until the next ack round);
    * ``("inherit", p, c)`` split: child c takes parent p's row;
    * ``("merge", c, p)``   merge: p keeps ``max(version)``, zeroed acks,
      every filter bit set;
    * ``("kill", s)``       slot returned to the pool: zero its row;
    * ``("grow", S')``      pool growth: pad zero rows to S'.

    The same object comes back for an empty journal."""
    if not events:
        return state
    dev = state.device
    version = state.version.cpu().numpy().astype(np.uint32)
    acked = state.acked.cpu().numpy().astype(np.uint32)
    kfilter = state.key_filter.cpu().numpy().copy()
    for ev in events:
        kind = ev[0]
        if kind == "reset":
            acked[ev[1], :] = 0
            kfilter[ev[1], :] = True
        elif kind == "inherit":
            p, c = ev[1], ev[2]
            version[c] = version[p]
            acked[c, :] = acked[p, :]
            kfilter[c, :] = kfilter[p, :]
        elif kind == "merge":
            c, p = ev[1], ev[2]
            version[p] = max(version[p], version[c])
            acked[p, :] = 0
            kfilter[p, :] = True
        elif kind == "kill":
            version[ev[1]] = 0
            acked[ev[1], :] = 0
            kfilter[ev[1], :] = False
        elif kind == "grow":
            pad = int(ev[1]) - version.shape[0]
            if pad > 0:
                version = np.concatenate([version, np.zeros(pad, np.uint32)])
                acked = np.concatenate(
                    [acked, np.zeros((pad, acked.shape[1]), np.uint32)])
                kfilter = np.concatenate(
                    [kfilter, np.zeros((pad, kfilter.shape[1]), bool)])
        else:
            raise ValueError(f"unknown replication event {ev!r}")
    return ReplState(
        version=torch.tensor(version.astype(np.int64), device=dev),
        acked=torch.tensor(acked.astype(np.int64), device=dev),
        key_filter=torch.tensor(kfilter, device=dev),
    )

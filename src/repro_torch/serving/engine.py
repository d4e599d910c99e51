"""Continuous-batching serving engine over the TurboKV-routed cache
(counterpart of ``repro.serving.engine``).

Slot-based continuous batching: a fixed decode batch of ``n_slots`` cache
slots; finished requests free their slot, waiting requests are prefilled
into free slots one at a time.  Every slot belongs to a logical storage
shard: the :class:`~repro_torch.serving.router.SequenceRouter` assigns
each request a shard by hashed request id (K1 on the card); the
controller can migrate slots between shards (load balancing) or fail a
shard over to its chain replica.  Free slots decode too (token 0), as in
the reference, so their lengths keep growing past ``cache_len``: the
cache write drops such rows and decode attention reads the S rows it has;
in a MoE layer they take expert capacity like any token.  Every
decoder-only family serves (the vlm text-only: the engine feeds tokens,
as the reference's does); the encoder-decoder is served through the
model facade.

``device=None`` means the CUDA card.  Sampling is on the host: each
step's logits are copied to the host as float32 and picked with numpy
(argmax, or the engine's numpy generator), as the reference does.

Timings: ``prefill_seconds`` holds each admission's host seconds from its
prefill to its first token (which waits for the device, since the logits
come to the host); on the card ``decode_events`` holds a pair of CUDA
events around each decode step's device work (:meth:`decode_ms`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.keys import hash_key
from repro_torch.device import resolve_device
from repro_torch.models import model as MODEL
from repro_torch.models.transformer import STATE_KEYS, check_param_dtypes
from repro_torch.serving.router import SequenceRouter


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    shard: int | None = None
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: dict, *, n_slots: int = 8,
                 cache_len: int = 256, n_shards: int = 4, eos_token: int = -1,
                 greedy: bool = True, seed: int = 0, device=None):
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the engine feeds tokens only; "
                             "serve an encoder-decoder through the model "
                             "facade (prefill with frames, decode_step)")
        check_param_dtypes(params, cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.eos = eos_token
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.router = SequenceRouter.create(n_shards, device=self.device)
        self.cache = MODEL.empty_cache(cfg, n_slots, cache_len,
                                       device=self.device)
        # K/V and latent rows are sequence-indexed (the Mamba states are
        # not): a prompt and its meta tokens must fit the cache
        self.kv_cache = any(name not in STATE_KEYS
                            for key, entry in self.cache.items()
                            if key != "length" for name in entry)
        self.slot_shard = np.full((n_slots,), -1, np.int32)
        self.free = list(range(n_slots))
        self.active: dict[int, Request] = {}
        self.waiting: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_id = 0
        self.prefill_seconds: list[float] = []
        self.decode_events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        """Queue a request; with a K/V cache, its prompt and the config's
        meta tokens must fit ``cache_len`` (the reference has the same
        limit, where it fails later on the slot's shape)."""
        prompt = np.asarray(prompt, np.int32)
        rows = self.cfg.n_meta_tokens + len(prompt)
        if self.kv_cache and rows > self.cache_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + {self.cfg.n_meta_tokens} "
                f"meta tokens needs {rows} cache positions; the engine's "
                f"cache_len is {self.cache_len}")
        rid = self._next_id
        self._next_id += 1
        self.waiting.append(Request(rid, prompt, max_new_tokens))
        return rid

    # ------------------------------------------------------------------
    def _admit(self):
        """Prefill waiting requests into free slots, one at a time."""
        while self.free and self.waiting:
            req = self.waiting.pop(0)
            slot = self.free.pop(0)
            shard, _chain = self.router.route(np.array([req.req_id]),
                                              writes=True)
            req.slot, req.shard = slot, int(shard[0])
            self.slot_shard[slot] = req.shard
            t0 = time.perf_counter()
            tokens = torch.tensor(req.prompt[None, :], device=self.device)
            logits, cache1 = MODEL.prefill(self.params, self.cfg,
                                           {"tokens": tokens},
                                           cache_len=self.cache_len)
            self._write_slot(slot, cache1)
            tok = self._pick(_host(logits)[0])
            self.prefill_seconds.append(time.perf_counter() - t0)
            req.out_tokens.append(tok)
            self.active[req.req_id] = req

    def _write_slot(self, slot: int, cache1: dict):
        """Copy a batch-1 cache into slot ``slot`` of the engine cache: the
        length at ``[slot]``, each group's stacked (L, B, ...) K/V and Mamba
        states at ``[:, slot]``.  (The reference finds the batch axis by its size,
        which picks the layer axis when n_layers == n_slots, ROADMAP F9.)"""
        for key, dst in self.cache.items():
            if key == "length":
                dst[slot] = cache1[key][0]
                continue
            for name, t in dst.items():
                t[:, slot] = cache1[key][name][:, 0]

    def _pick(self, logits: np.ndarray) -> int:
        logits = logits[: self.cfg.vocab_size]  # drop padded-vocab tail
        if self.greedy:
            return int(logits.argmax())
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # ------------------------------------------------------------------
    def step(self):
        """One engine iteration: admit + one decode step for all slots."""
        self._admit()
        if not self.active:
            return
        tokens = np.zeros((self.n_slots,), np.int32)
        for req in self.active.values():
            tokens[req.slot] = req.out_tokens[-1]
        on_card = self.device.type == "cuda"
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        logits, self.cache = MODEL.decode_step(
            self.params, self.cfg, torch.tensor(tokens, device=self.device),
            self.cache)
        if on_card:
            ev[1].record()
            self.decode_events.append(ev)
        logits = _host(logits)
        for rid in list(self.active):
            req = self.active[rid]
            tok = self._pick(logits[req.slot])
            req.out_tokens.append(tok)
            if len(req.out_tokens) >= req.max_new_tokens or tok == self.eos:
                req.done = True
                self.free.append(req.slot)
                self.slot_shard[req.slot] = -1
                self.finished[rid] = req
                del self.active[rid]

    def run(self, max_steps: int = 256):
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def decode_ms(self) -> list[float]:
        """Device milliseconds of each decode step so far (card only)."""
        torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in self.decode_events]

    # ------------------------------------------------------------------
    def shard_load(self) -> np.ndarray:
        """Active slots per shard (controller input)."""
        n = self.router.directory.num_nodes
        load = np.zeros((n,), np.int64)
        for req in self.active.values():
            load[req.shard] += 1
        return load

    def rebalance(self):
        """Paper §5.1: migrate active sequences off overloaded shards
        (reassigning a slot's shard; on a real cluster, copying its cache
        rows).  Returns ``(moved, ops)``."""
        ops, _report = self.router.rebalance()
        moved = 0
        for op in ops:
            for req in self.active.values():
                h = int(hash_key(torch.tensor(req.req_id)))
                if req.shard == op.src and op.lo <= h <= op.hi:
                    req.shard = op.dst
                    self.slot_shard[req.slot] = op.dst
                    moved += 1
        return moved, ops

    def fail_shard(self, shard: int):
        """Paper §5.2: shard failure — active sequences on it fail over to
        their chain replica.  Returns the moved request ids."""
        self.router.fail_shard(shard)
        moved = []
        for req in self.active.values():
            if req.shard == shard:
                new_shard, _ = self.router.route(np.array([req.req_id]))
                req.shard = int(new_shard[0])
                self.slot_shard[req.slot] = req.shard
                moved.append(req.req_id)
        return moved


def _host(logits: torch.Tensor) -> np.ndarray:
    """Logits as the host picks them: float32 numpy."""
    return logits.float().cpu().numpy()

"""The port's serving engine and router: the six cases of
``tests/test_serving.py`` on the port (its own seeded weights, CPU), and
the engine against the reference's ``ServingEngine`` on the same requests
and weights — token streams, logits, slot shards, rebalance ops and
failovers — for reduced qwen2 (dense), mamba2 (ssm), hymba (hybrid),
deepseek-moe (dense + moe groups), llama4 (pair), minicpm3 (mla) and
internvl2 (vlm, text only, as the reference's engine feeds it)."""

import sys

import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    # forget the half-imported `repro` modules that earlier test modules'
    # failed imports left behind
    for _m in sorted(m for m in sys.modules if m.startswith("repro.")):
        if _m.rpartition(".")[0] not in sys.modules:
            del sys.modules[_m]

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.configs import get_config as j_get_config
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_loop
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import SequenceRouter


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("qwen2-1.5b").reduced()
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def ref_model():
    """The reference's reduced qwen2 and its weights, carried across."""
    jcfg = j_get_config("qwen2-1.5b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("qwen2-1.5b").reduced()
    params = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def ssm_models():
    """The reference's reduced mamba2 and hymba and their weights."""
    out = {}
    for arch in ("mamba2-370m", "hymba-1.5b"):
        jcfg = j_get_config(arch).reduced()
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced()
        out[arch] = (jcfg, jparams, cfg, convert.params_from_numpy(
            cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    return out


# ---------------------------------------------------------------------------
# the cases of tests/test_serving.py
# ---------------------------------------------------------------------------


def test_engine_finishes_requests(small_model):
    cfg, params = small_model
    eng = ServingEngine(cfg, params, n_slots=4, cache_len=64, n_shards=4,
                        device="cpu")
    rids = [eng.submit(np.arange(4) + i, max_new_tokens=5) for i in range(7)]
    done = eng.run()
    assert len(done) == 7
    for rid in rids:
        assert len(done[rid].out_tokens) == 5


def test_engine_greedy_deterministic(small_model):
    cfg, params = small_model
    outs = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, n_slots=2, cache_len=64, n_shards=2,
                            device="cpu")
        rid = eng.submit(np.arange(6), max_new_tokens=6)
        outs.append(eng.run()[rid].out_tokens)
    assert outs[0] == outs[1]


def _manual_decode(prefill, decode_step, params, cfg, prompt, n, to_dev):
    logits, cache = prefill(params, cfg, {"tokens": to_dev(prompt[None])},
                            cache_len=64)
    toks = [int(np.asarray(logits, np.float32)[0][: cfg.vocab_size].argmax())]
    for _ in range(n - 1):
        logits, cache = decode_step(params, cfg, to_dev(np.array([toks[-1]])),
                                    cache)
        toks.append(int(np.asarray(logits, np.float32)[0][: cfg.vocab_size]
                        .argmax()))
    return toks


def test_engine_matches_manual_decode(small_model):
    """Engine tokens == a manual prefill + decode loop (routing is
    transparent)."""
    cfg, params = small_model
    prompt = np.arange(5, dtype=np.int32)
    eng = ServingEngine(cfg, params, n_slots=3, cache_len=64, n_shards=2,
                        device="cpu")
    rid = eng.submit(prompt, max_new_tokens=4)
    done = eng.run()
    toks = _manual_decode(M.prefill, M.decode_step, params, cfg, prompt, 4,
                          torch.tensor)
    assert done[rid].out_tokens == toks


def test_router_read_goes_to_tail_write_to_head():
    r = SequenceRouter.create(4, replication=3, device="cpu")
    ids = np.arange(32)
    shard_r, chain_r = r.route(ids)
    shard_w, chain_w = r.route(ids, writes=True)
    np.testing.assert_array_equal(shard_w, chain_w[:, 0])
    np.testing.assert_array_equal(shard_r, chain_r[:, -1])


def test_router_rebalance_reduces_hot_load():
    r = SequenceRouter.create(4, replication=2, device="cpu")
    r.route(np.full((512,), 12345))     # hammer a single key range
    ops, report = r.rebalance()
    assert report.total_ops == 512


def test_shard_failover(small_model):
    cfg, params = small_model
    eng = ServingEngine(cfg, params, n_slots=4, cache_len=64, n_shards=4,
                        device="cpu")
    for i in range(4):
        eng.submit(np.arange(4) + i, max_new_tokens=32)
    eng.step()  # admit all
    victim = next(iter({r.shard for r in eng.active.values()}))
    eng.fail_shard(victim)
    for r in eng.active.values():
        assert r.shard != victim
    assert len(eng.run()) == 4


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------


def _drive(eng, prompts, max_new, **loop):
    """Serve ``prompts`` through the port's ``serve_loop`` (either engine)
    with the controller settings ``loop``.  Returns the per-step trace
    (migration ops as tuples), the finished requests and every logits row
    picked."""
    picked = []
    pick = eng._pick

    def record(logits):
        picked.append(np.array(logits[: eng.cfg.vocab_size], np.float32))
        return pick(logits)

    eng._pick = record
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    trace = serve_loop(eng, **loop)
    for rec in trace:
        if "rebalance" in rec:
            moved, ops = rec["rebalance"]
            rec["rebalance"] = (moved, [(o.lo, o.hi, o.src, o.dst, o.kind)
                                        for o in ops])
    return trace, eng.finished, picked


def _both(ref_model, n_slots, seed, **loop):
    jcfg, jparams, cfg, params = ref_model
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.choice([4, 6], 16)]
    ref = _drive(JEngine(jcfg, jparams, n_slots=n_slots, cache_len=64,
                         n_shards=4), prompts, 4, **loop)
    port = _drive(ServingEngine(cfg, params, n_slots=n_slots, cache_len=64,
                                n_shards=4, device="cpu"), prompts, 4, **loop)
    return ref, port


def _tokens(finished):
    return {rid: r.out_tokens for rid, r in finished.items()}


@pytest.mark.parametrize("loop", [dict(rebalance_every=2),
                                  dict(rebalance_every=0, fail_shard_at=2)],
                         ids=["rebalance", "failover"])
@pytest.mark.parametrize("n_slots", [3, 5])
def test_engine_matches_reference_engine(ref_model, n_slots, loop):
    """16 requests of mixed prompt lengths, 64-position cache, 4 shards,
    under a rebalance every 2 steps or a failure of the most-loaded shard
    at step 2: equal token streams, slot shards, rebalance ops and moved
    counts, and failed-over ids, and every picked logits row within 1e-4.
    (A rebalance after a failure differs by design, F10, and
    ``n_slots == n_layers`` trips the reference's slot write, F9: see the
    tests below.)"""
    _check_engines(ref_model, n_slots, loop)


@pytest.mark.parametrize("loop", [dict(rebalance_every=2),
                                  dict(rebalance_every=0, fail_shard_at=2)],
                         ids=["rebalance", "failover"])
@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_engine_matches_reference_engine(ssm_models, arch, n_slots, loop):
    """The same for the ssm family (the slots' conv and SSM states written
    at ``[:, slot]`` and stepped by the decode recurrence, prefill through
    the chunked scan) and the hybrid one (K/V and states; 8 meta tokens
    before each prompt in the 64-position cache)."""
    _check_engines(ssm_models[arch], n_slots, loop)


def _check_engines(model, n_slots, loop):
    (jtrace, jdone, jpicked), (ttrace, tdone, tpicked) = _both(
        model, n_slots, n_slots, **loop)
    assert _tokens(tdone) == _tokens(jdone) and len(tdone) == 16
    assert ttrace == jtrace
    if "fail_shard_at" in loop:
        assert any(r.get("failed", (0, []))[1] for r in ttrace)
    else:
        assert any(r.get("rebalance", (0,))[0] for r in ttrace)
    assert len(tpicked) == len(jpicked)
    for i, (a, b) in enumerate(zip(tpicked, jpicked)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"pick {i}")


@pytest.fixture(scope="module")
def family_models():
    """The reference's reduced configs of the families served since the
    MoE / MLA / vlm port, and their weights, built on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = j_get_config(arch).reduced()
            jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
            cfg = get_config(arch).reduced()
            built[arch] = (jcfg, jparams, cfg, convert.params_from_numpy(
                cfg, jax.tree.map(np.asarray, jparams), "cpu"))
        return built[arch]

    return get


@pytest.mark.parametrize("arch,n_slots", [
    ("deepseek-moe-16b", 4), ("deepseek-moe-16b", 5),
    ("llama4-maverick-400b-a17b", 3), ("llama4-maverick-400b-a17b", 5),
    ("minicpm3-4b", 3), ("minicpm3-4b", 5),
    ("internvl2-26b", 3), ("internvl2-26b", 5)])
def test_family_engine_matches_reference_engine(family_models, arch, n_slots):
    """The same, under the failure of the most-loaded shard at step 2, for
    the MoE families (the whole decode batch, idle slots too, dispatched
    under capacity: deepseek's dense layer then MoE layers, llama4's
    dense + MoE pairs), MLA (the slots' latent rows ``ckv`` / ``krope``)
    and the vlm's text backbone.  deepseek runs 4 slots, not 3: its MoE
    group stacks 3 layers, and at 3 slots the reference's slot write takes
    that layer axis for the batch axis (F9)."""
    _check_engines(family_models(arch), n_slots,
                   dict(rebalance_every=0, fail_shard_at=2))


def test_engine_refuses_an_encoder_decoder():
    """The engine feeds tokens only; whisper needs its frames and is
    served through the model facade, as in the reference."""
    cfg = get_config("whisper-small").reduced()
    with pytest.raises(ValueError, match="facade"):
        ServingEngine(cfg, M.init_params(cfg, 0, device="cpu"), n_slots=2,
                      cache_len=16, n_shards=2, device="cpu")


def test_submit_refuses_a_prompt_past_the_cache(ssm_models):
    """hymba's meta tokens take cache rows: a prompt whose meta tokens and
    tokens exceed ``cache_len`` is refused at ``submit``.  The reference
    has the same limit and fails at admission, on the slot's shape; a
    prompt that just fits is served by both alike."""
    jcfg, jparams, cfg, params = ssm_models["hymba-1.5b"]
    n_meta = cfg.n_meta_tokens
    eng = ServingEngine(cfg, params, n_slots=3, cache_len=n_meta + 6,
                        n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(np.arange(7), max_new_tokens=2)
    assert not eng.waiting
    jeng = JEngine(jcfg, jparams, n_slots=3, cache_len=n_meta + 6, n_shards=2)
    jeng.submit(np.arange(7), max_new_tokens=2)
    with pytest.raises((TypeError, ValueError)):
        jeng.run()
    fits = np.arange(6, dtype=np.int32) + 3
    rid = eng.submit(fits, max_new_tokens=3)
    jeng = JEngine(jcfg, jparams, n_slots=3, cache_len=n_meta + 6, n_shards=2)
    jrid = jeng.submit(fits, max_new_tokens=3)
    assert eng.run()[rid].out_tokens == jeng.run()[jrid].out_tokens


def test_ssm_engine_serves_prompts_past_the_cache(ssm_models):
    """mamba2 keeps no K/V: its state does not grow with the prompt, so a
    prompt longer than ``cache_len`` is served, as by a manual prefill and
    decode."""
    _, _, cfg, params = ssm_models["mamba2-370m"]
    prompt = (np.arange(20, dtype=np.int32) * 7) % cfg.vocab_size
    eng = ServingEngine(cfg, params, n_slots=3, cache_len=8, n_shards=2,
                        device="cpu")
    rid = eng.submit(prompt, max_new_tokens=4)
    toks = _manual_decode(M.prefill, M.decode_step, params, cfg, prompt, 4,
                          torch.tensor)
    assert eng.run()[rid].out_tokens == toks


def test_rebalance_after_failure_keeps_off_the_dead_shard_f10(ref_model):
    """F10: the reference's router builds a fresh ``Controller`` for each
    rebalance, so the shard it failed is no longer failed there and, idle,
    becomes the balancer's coolest destination: ranges, with any sequence
    they hold, migrate onto the dead shard.  The port's router remembers its failed shards.  With
    ``launch/serve.py``'s loop (here a rebalance every 2 steps, the failure
    at step 2) the token streams stay equal; only the shards differ."""
    loop = dict(rebalance_every=2, fail_shard_at=2)
    (jtrace, jdone, _), (ttrace, tdone, _) = _both(ref_model, 5, 5, **loop)
    assert _tokens(tdone) == _tokens(jdone)
    (victim, moved), = [r["failed"] for r in jtrace if "failed" in r]
    assert moved and [r["failed"] for r in ttrace if "failed" in r] == [
        (victim, moved)]

    def on_victim(trace):
        """Migrations onto the dead shard, and sequences seated on it at
        the end of a step, after the failure."""
        after = [r for r in trace if r["step"] > 2]
        moves = [op for r in after for op in r.get("rebalance", (0, []))[1]
                 if op[3] == victim]
        return len(moves), sum(s == victim for r in after
                               for s in r["slot_shard"])

    assert on_victim(jtrace)[0] >= 1
    assert on_victim(ttrace) == (0, 0)


def test_reference_slot_write_picks_layer_axis_f9(ref_model):
    """F9: the reference's ``_write_slot`` finds the batch axis as the one
    of size ``n_slots``, which is the layer axis of the stacked (L, B, ...)
    cache when n_layers == n_slots (4 here, tests/test_serving.py's own
    setting): some request then decodes from a wrong cache and its tokens
    leave the reference's own manual decode.  The port writes the batch
    axis by structure and equals the manual decode."""
    jcfg, jparams, cfg, params = ref_model
    n_slots = cfg.n_layers
    prompts = [(np.arange(4) + i).astype(np.int32) for i in range(7)]
    jeng = JEngine(jcfg, jparams, n_slots=n_slots, cache_len=64, n_shards=4)
    teng = ServingEngine(cfg, params, n_slots=n_slots, cache_len=64,
                         n_shards=4, device="cpu")
    jr = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    tr = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    manual = [_manual_decode(JM.prefill, JM.decode_step, jparams, jcfg, p, 5,
                             jnp.asarray) for p in prompts]
    assert [tdone[r].out_tokens for r in tr] == manual
    assert [jdone[r].out_tokens for r in jr] != manual

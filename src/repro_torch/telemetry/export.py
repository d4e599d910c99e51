"""Span export: Chrome-trace JSON and JSONL span trees (counterpart of
``repro.telemetry.export``).

Consumes the per-epoch span records accumulated by
:class:`repro_torch.telemetry.recorder.TelemetryRecorder` (host-side dicts of
numpy arrays) and renders them two ways:

* :func:`chrome_trace` — a ``chrome://tracing`` / Perfetto-loadable
  event list.  Each sampled query is a complete ("X") event on its
  closed-loop client lane, with child slices for the storage service at
  the target node and (when bounced) the CRAQ version check at the
  picked replica.  Epochs are laid end to end on one timeline by
  offsetting each epoch's DES clock with the cumulative makespan of the
  epochs before it.
* :func:`span_tree` / :func:`write_jsonl` — one nested dict per sampled
  query (query -> hop children), the machine-readable form the tests
  consume.

Interior hop placement: when the epoch record carries the DES engine's
per-hop completion times (``rec["hops"]`` — the driver requests
``return_hops`` whenever telemetry is on), child slices are **measured**:
the bounce/redirect version check ends at its hop's exact completion,
the service slice ends at the final hop's exact completion.  Records
without hop times (older artifacts, direct ``collect_spans`` use) fall
back to the anchored reconstruction — the service slice ends one link
before the reply lands, the bounce check starts one link after issue.
Root span boundaries and every duration are exact either way.

:func:`link_retries` stitches cross-epoch retry orbits: spans whose
``first_epoch`` column is live (the overload plane's orbit-identity
register, ``repro_torch.overload.link_orbit``) group by ``(key, first_epoch)``
into one orbit tree — re-injection attempts as children, true
time-to-success measured on the run's cumulative DES clock when the
orbit completes inside the sampled window.
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.core import keys as K
from repro_torch.core.coordination import LatencyModel
from repro_torch.core.routing import unpack_chain
from repro_torch.telemetry.attribution import BUCKETS
from repro_torch.telemetry.trace import SF, SI

OUTCOME_NAMES = {-1: "n/a", 0: "admitted", 1: "deferred", 2: "shed"}


def _op_name(op: int) -> str:
    return K.OP_NAMES.get(int(op), f"op{int(op)}")


def span_tree(rec: dict, j: int, model: LatencyModel) -> dict:
    """One sampled query's span tree (epoch record ``rec``, row ``j``)."""
    si = rec["span_i"][j]
    sf = rec["span_f"][j]
    lat = float(rec["lat"][j])
    comps = rec["comps"][j]
    issue = rec["issue"]
    t0 = float(rec.get("t0", 0.0))
    start = t0 + (float(issue[j]) if issue is not None else 0.0)
    link = float(np.float32(model.link))
    outcome = int(si[SI["outcome"]])
    bounced = int(si[SI["bounced"]]) == 1
    chain = [int(n) for n in unpack_chain(si[SI["chain"]][None])[0] if n >= 0]
    hops_t = rec.get("hops")
    # measured per-hop completion times (DES exact; 0 marks a dead slot)
    hop_done = ([t0 + float(t) for t in hops_t[j] if t > 0.0]
                if hops_t is not None else None)

    children = []
    if outcome in (1, 2):
        children.append({
            "name": "nack", "node": "switch", "start": start,
            "dur": lat, "kind": "retry_backoff",
        })
    else:
        svc_store = float(sf[SF["svc_store"]])
        if bounced:
            lookup = float(np.float32(model.lookup))
            # measured: hop_done is end-of-service at that hop, so the
            # first live hop's timestamp IS the end of the version
            # check; anchored fallback: one link after issue
            c_end = (hop_done[0] if hop_done
                     else start + link + lookup)
            children.append({
                "name": f"dirty-check@node{int(si[SI['picked']])}",
                "node": int(si[SI["picked"]]),
                "start": c_end - lookup,
                "dur": lookup,
                "kind": "bounce",
            })
        # measured: the service slice ends at the last hop's exact
        # completion; anchored fallback: one link before the reply
        s_end = hop_done[-1] if hop_done else start + lat - link
        children.append({
            "name": f"service@node{int(si[SI['target']])}",
            "node": int(si[SI["target"]]),
            "start": s_end - svc_store,
            "dur": svc_store,
            "kind": "service",
        })
    return {
        "epoch": int(si[SI["epoch"]]),
        "qid": int(si[SI["qid"]]),
        "key": int(np.int64(si[SI["key"]]) & 0xFFFFFFFF),
        "op": _op_name(si[SI["opcode"]]),
        "ridx": int(si[SI["ridx"]]),
        "target": int(si[SI["target"]]),
        "picked": int(si[SI["picked"]]),
        "chain": chain,
        "outcome": OUTCOME_NAMES.get(outcome, str(outcome)),
        "bounced": bounced,
        "queue_depth": int(si[SI["queue_depth"]]),
        "orbit_level": int(si[SI["orbit_level"]]),
        "first_epoch": int(si[SI["first_epoch"]]),
        "start": start,
        "latency": lat,
        "components": {b: float(comps[i]) for i, b in enumerate(BUCKETS)},
        "hops": children,
        "hop_done": hop_done,
    }


def link_retries(epochs: list[dict], model: LatencyModel) -> list[dict]:
    """Stitch cross-epoch retry orbits into one tree per orbit.

    Spans whose ``first_epoch`` column is live (>= 0) belong to a retry
    orbit — the overload plane's hashed identity register stamped their
    key's birth epoch (``repro_torch.overload.link_orbit``).  Attempts group by
    ``(key, first_epoch)`` and sort by absolute start on the run's
    cumulative DES clock; the orbit tree is the first attempt with the
    re-injections as children:

    * ``attempts``        — sampled attempt count (span sampling is
      per-(key, epoch), so under ``sample_rate < 1`` an orbit's middle
      attempts may be unsampled — stitching is over the sampled subset);
    * ``time_to_success`` — last admitted attempt's absolute finish minus
      first attempt's absolute start (the *true* client-visible storm
      cost), ``None`` while the orbit never completed in-window;
    * ``retries``         — the attempt trees after the first.

    Hash collisions in the register merge two keys' orbits under one
    birth epoch; grouping by the (key, first_epoch) *pair* keeps distinct
    keys apart regardless.
    """
    orbits: dict[tuple[int, int], list[dict]] = {}
    for rec in epochs:
        for j in range(rec["span_i"].shape[0]):
            tree = span_tree(rec, j, model)
            if tree["first_epoch"] >= 0:
                kid = (tree["key"], tree["first_epoch"])
                orbits.setdefault(kid, []).append(tree)
    out = []
    for (key, fe), attempts in sorted(orbits.items()):
        attempts.sort(key=lambda t: (t["epoch"], t["start"]))
        done = [t for t in attempts if t["outcome"] == "admitted"]
        tts = (done[-1]["start"] + done[-1]["latency"] - attempts[0]["start"]
               if done else None)
        root = dict(attempts[0])
        root["orbit"] = {"key": key, "first_epoch": fe}
        root["attempts"] = len(attempts)
        root["time_to_success"] = tts
        root["retries"] = attempts[1:]
        out.append(root)
    return out


def chrome_trace(epochs: list[dict], model: LatencyModel, *,
                 n_clients: int | None = None,
                 scenario: str = "", policy: str = "") -> dict:
    """Render epoch span records as a Chrome-trace object."""
    events: list[dict] = []
    for rec in epochs:
        n = rec["span_i"].shape[0]
        for j in range(n):
            tree = span_tree(rec, j, model)
            lane = (tree["qid"] % n_clients) if n_clients else tree["qid"]
            name = f"{tree['op']} key=0x{tree['key']:08x}"
            events.append({
                "name": name, "ph": "X", "cat": "query",
                "ts": tree["start"], "dur": tree["latency"],
                "pid": 0, "tid": f"client{lane}",
                "args": {
                    "epoch": tree["epoch"], "qid": tree["qid"],
                    "target": tree["target"], "chain": tree["chain"],
                    "outcome": tree["outcome"], "bounced": tree["bounced"],
                    "queue_depth": tree["queue_depth"],
                    "orbit_level": tree["orbit_level"],
                    "components": tree["components"],
                },
            })
            for hop in tree["hops"]:
                events.append({
                    "name": hop["name"], "ph": "X", "cat": hop["kind"],
                    "ts": hop["start"], "dur": hop["dur"],
                    "pid": 0, "tid": f"node{hop['node']}",
                    "args": {"epoch": tree["epoch"], "qid": tree["qid"]},
                })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "scenario": scenario, "policy": policy,
            "unit": "DES ticks", "epochs_traced": len(epochs),
        },
    }


def write_chrome_trace(path: str, epochs: list[dict], model: LatencyModel,
                       **kw) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(epochs, model, **kw), f, indent=1)
    return path


def write_jsonl(path: str, epochs: list[dict], model: LatencyModel) -> str:
    """One span tree per line — the machine-readable export."""
    with open(path, "w") as f:
        for rec in epochs:
            for j in range(rec["span_i"].shape[0]):
                f.write(json.dumps(span_tree(rec, j, model)) + "\n")
    return path

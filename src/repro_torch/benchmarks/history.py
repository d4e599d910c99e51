"""Benchmark history ledger: headline metrics per gated run, append-only
(counterpart of ``benchmarks/history.py``).

Every gated bench run of the port that writes its JSON appends one JSONL
record to ``BENCH_torch_HISTORY.jsonl`` beside that JSON (the reference
keeps its own ``BENCH_HISTORY.jsonl``, which the port never writes): git
SHA, a short hash of the run configuration, and the headline numbers
tracked across runs (mean throughput, worst p99 / p999, loss,
coordination redirect share; the metrics bench's gates).

  PYTHONPATH=src python -m repro_torch.benchmarks.history --append BENCH_torch_dist.json
  PYTHONPATH=src python -m repro_torch.benchmarks.history --seed   # one entry per BENCH_torch_*.json
  PYTHONPATH=src python -m repro_torch.benchmarks.history --show

Append never raises into the caller: a missing git binary or a malformed
doc degrades to ``sha="unknown"`` / skipped fields, because losing a
history line must not fail a benchmark gate.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import hashlib
import json
import os
import subprocess

HISTORY = "BENCH_torch_HISTORY.jsonl"


def beside(json_path: str) -> str:
    """The ledger in the directory of a bench's JSON (where its CLI
    appends unless told otherwise)."""
    return os.path.join(os.path.dirname(json_path), HISTORY)


def git_sha(cwd: str = ".") -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def config_hash(doc: dict) -> str:
    """Short stable hash of the run configuration (the non-row keys)."""
    cfg = {k: v for k, v in doc.items() if k != "rows"}
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _agg(rows: list[dict], key: str, fn=max):
    vals = [r[key] for r in rows if isinstance(r.get(key), (int, float))]
    return fn(vals) if vals else None


def headline(bench: str, doc: dict) -> dict:
    """A bench JSON distilled into the fixed headline record."""
    rows = doc.get("rows", [])
    rec = {
        "bench": bench,
        "n_rows": len(rows),
        "steady_eps": _agg(rows, "mean_throughput"),
        "p99": _agg(rows, "max_p99"),
        "p999": _agg(rows, "max_p999"),
        "loss": _agg(rows, "lost", fn=sum),
        "redirect_share": _agg(rows, "redirect_share"),
    }
    # the metrics bench's docs carry their gates at the top level
    for k in ("parity_ok", "alert_epoch_ok", "incident_complete"):
        if k in doc:
            rec[k] = doc[k]
    return rec


def append(bench: str, doc: dict, *, history_path: str = HISTORY,
           cwd: str = ".") -> dict | None:
    """Append one headline record; returns it (None on failure)."""
    try:
        rec = headline(bench, doc)
        rec["sha"] = git_sha(cwd)
        rec["config_hash"] = config_hash(doc)
        rec["ts"] = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
        with open(history_path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
        return rec
    except Exception:
        return None


def bench_name(path: str) -> str:
    """``BENCH_torch_dist.json`` -> ``dist`` (and ``BENCH_x.json`` -> ``x``)."""
    name = os.path.basename(path)
    for prefix in ("BENCH_torch_", "BENCH_"):
        if name.startswith(prefix):
            name = name[len(prefix):]
            break
    return name.rsplit(".", 1)[0]


def append_file(path: str, *, bench: str | None = None,
                history_path: str = HISTORY) -> dict | None:
    with open(path) as f:
        doc = json.load(f)
    return append(bench or bench_name(path), doc, history_path=history_path,
                  cwd=os.path.dirname(os.path.abspath(path)))


def load(history_path: str = HISTORY) -> list[dict]:
    if not os.path.exists(history_path):
        return []
    out = []
    with open(history_path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def fmt(records: list[dict]) -> str:
    hdr = ("| ts | sha | bench | cfg | steady eps | p99 | p999 | loss "
           "| redirect |\n|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in records:
        def g(k, spec="{:.3g}"):
            v = r.get(k)
            return spec.format(v) if isinstance(v, (int, float)) else "-"
        lines.append(
            f"| {r.get('ts', '-')} | {r.get('sha', '-')} "
            f"| {r.get('bench', '-')} | {r.get('config_hash', '-')} "
            f"| {g('steady_eps')} | {g('p99')} | {g('p999')} "
            f"| {g('loss')} | {g('redirect_share')} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--append", metavar="BENCH_JSON", default=None,
                    help="append one headline record from this bench JSON")
    ap.add_argument("--bench", default=None,
                    help="bench name override for --append")
    ap.add_argument("--seed", action="store_true",
                    help="append one record per BENCH_torch_*.json here")
    ap.add_argument("--show", action="store_true",
                    help="print the ledger as a markdown table")
    ap.add_argument("--history", default=HISTORY)
    args = ap.parse_args(argv)
    if args.append:
        rec = append_file(args.append, bench=args.bench,
                          history_path=args.history)
        print(json.dumps(rec) if rec else "append failed")
    if args.seed:
        for path in sorted(glob.glob("BENCH_torch_*.json")):
            if "roofline" in path or "HISTORY" in path:
                continue
            rec = append_file(path, history_path=args.history)
            print(f"{path}: {'ok' if rec else 'skipped'}")
    if args.show or not (args.append or args.seed):
        print(fmt(load(args.history)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Terminal dashboard over a persisted metrics view (counterpart of
``repro.telemetry.dashboard``).

``python -m repro_torch.telemetry.dashboard --view METRICS_view.json`` renders
the fleet metrics ring (written by ``metrics.write_view``) as unicode
sparklines — one line per series family, latest value and min/max beside
it — plus the SLO alert timeline when the view carries one.  Pure
stdlib + numpy, so it runs anywhere the artifact lands.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 48) -> str:
    """Unicode block sparkline, downsampled to ``width`` points."""
    v = np.asarray(vals, np.float64)
    if v.size == 0:
        return ""
    if v.size > width:
        # bucket means keep spikes visible enough while bounding width
        edges = np.linspace(0, v.size, width + 1).astype(int)
        v = np.array([v[a:b].max() if b > a else v[min(a, v.size - 1)]
                      for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = float(v.min()), float(v.max())
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * v.size
    idx = np.minimum(
        ((v - lo) / span * (len(_BLOCKS) - 1)).astype(int),
        len(_BLOCKS) - 1,
    )
    return "".join(_BLOCKS[i] for i in idx)


def _families(names: list[str]) -> dict:
    """Group indexed series (``fam/idx``) under one family row."""
    fams: dict[str, list[int]] = {}
    for i, n in enumerate(names):
        fam = n.rsplit("/", 1)[0] if "/" in n else n
        fams.setdefault(fam, []).append(i)
    return fams


def render(view: dict, *, width: int = 48, series: list[str] | None = None
           ) -> str:
    """Render a metrics view (and its optional alert timeline) as text.

    Indexed families are collapsed to their per-epoch max across the
    index (the fleet-worst trace — what an operator pages on); pass
    ``series`` to select specific families."""
    names = view["names"]
    vals = np.asarray(view["values"], np.float64)
    epochs = view.get("epochs", [])
    lines = [
        f"fleet metrics — epochs "
        f"{epochs[0] if epochs else '-'}..{epochs[-1] if epochs else '-'} "
        f"(window {view.get('window', '?')})",
        "",
    ]
    if vals.size == 0:
        lines.append("(empty ring)")
        return "\n".join(lines) + "\n"
    fams = _families(names)
    pick = series if series is not None else list(fams)
    namew = max((len(f) for f in pick), default=8)
    for fam in pick:
        cols = fams.get(fam)
        if not cols:
            continue
        trace = vals[:, cols].max(axis=1)
        lines.append(
            f"{fam:<{namew}} {sparkline(trace, width):<{width}} "
            f"last={trace[-1]:g} min={trace.min():g} max={trace.max():g}"
        )
    alerts = view.get("alerts") or []
    lines += ["", f"alerts ({len(alerts)}):"]
    if alerts:
        for ev in alerts:
            lines.append(
                f"  [{ev['state']:>7}] epoch {ev['epoch']:>4} "
                f"{ev['slo']} value={ev['value']:.2f} "
                f"fast={ev['fast_burn']:.2f} slow={ev['slow_burn']:.2f}"
            )
    else:
        lines.append("  (none)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--view", required=True,
                    help="metrics view JSON (metrics.write_view output)")
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--series", default=None,
                    help="comma-separated family filter")
    ap.add_argument("--out", default=None,
                    help="write the rendering here instead of stdout")
    args = ap.parse_args(argv)
    with open(args.view) as f:
        view = json.load(f)
    text = render(
        view, width=args.width,
        series=args.series.split(",") if args.series else None,
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

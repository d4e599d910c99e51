"""What the demos share: the ``--device`` flag, a printer that keeps the
lines it prints, and those lines without what the clock decides."""

from __future__ import annotations

import argparse


class Lines(list):
    """Prints each line and keeps it."""

    def __init__(self, echo: bool = True):
        super().__init__()
        self.echo = echo

    def __call__(self, *parts, sep: str = " ") -> None:
        line = sep.join(str(p) for p in parts)
        for piece in line.split("\n"):
            self.append(piece)
        if self.echo:
            print(line, flush=True)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="where the demo runs (default: the CUDA card)")
    return ap


# the trace demo's wall-clock block opens with this line
TIMER_HEADER = "pipeline stage share (wall clock):"


def timer_free(lines: list[str]) -> list[str]:
    """A demo's lines without what the clock decides: the trace demo's
    stage-share block, and the serving demo's seconds and tokens/s."""
    out, skip = [], False
    for line in lines:
        if skip and line.startswith("  "):
            continue
        skip = line == TIMER_HEADER
        if line.startswith("finished ") and " engine steps (" in line:
            line = line.split(" (", 1)[0]
        out.append(line)
    return out

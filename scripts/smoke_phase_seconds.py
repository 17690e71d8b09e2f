#!/usr/bin/env python3
"""Seconds of each phase of a ``chip_smoke.py`` log, from its timestamps.

Every log line starts with ``[   t.s]``, seconds since the smoke began;
a phase starts at its ``== phase <label>:`` line and ends where the next
one starts (the last at the ``every phase passed`` line). A label seen
twice (phase 24's ``small`` and ``llama3-8b`` halves, phase 28's and
31's) sums its spans. ``--group`` sums the listed labels; ``--from``
sums every span from the first one of a label to the end of the run
(``--from 9``: the ``llama3-8b`` engines' phases, the last block of the
smoke).

    python3 scripts/smoke_phase_seconds.py LOG [--group 9,10,11] [--from 9]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Tuple

LINE = re.compile(r"^\[\s*([0-9.]+)s\] (.*)$")
PHASE = re.compile(r"^== phase ([0-9]+[a-z]?)")


def phase_spans(lines: List[str]) -> Tuple[List[Tuple[str, float, float]],
                                           float]:
    """[(label, start, seconds)] in log order, and the log's last time."""
    marks: List[Tuple[str, float]] = []
    last = 0.0
    for raw in lines:
        match = LINE.match(raw.rstrip("\n"))
        if match is None:
            continue
        t, text = float(match.group(1)), match.group(2)
        last = t
        phase = PHASE.match(text)
        if phase is not None:
            marks.append((phase.group(1), t))
        elif text.startswith("chip_smoke: every phase passed"):
            marks.append(("end", t))
    spans = [(label, start, nxt - start)
             for (label, start), (_, nxt) in zip(marks, marks[1:])]
    return spans, last


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("log")
    parser.add_argument("--group", action="append", default=[],
                        help="comma-separated labels to sum")
    parser.add_argument("--from", dest="start", default=None,
                        help="sum the spans from this label's first on")
    args = parser.parse_args()
    with open(args.log, encoding="utf-8", errors="replace") as fh:
        spans, last = phase_spans(fh.readlines())
    by_label: Dict[str, float] = {}
    for label, start, seconds in spans:
        by_label[label] = by_label.get(label, 0.0) + seconds
        print(f"phase {label:>4}: start {start:7.1f}s, {seconds:7.1f}s")
    print(f"log ends at {last:.1f}s")
    for group in args.group:
        labels = [g.strip() for g in group.split(",") if g.strip()]
        total = sum(by_label.get(label, 0.0) for label in labels)
        print(f"group {','.join(labels)}: {total:.1f}s")
    if args.start is not None:
        first = next(i for i, span in enumerate(spans)
                     if span[0] == args.start)
        tail = spans[first:]
        print(f"from phase {args.start} at {tail[0][1]:.1f}s: "
              f"{sum(span[2] for span in tail):.1f}s over {len(tail)} spans")
    return 0


if __name__ == "__main__":
    sys.exit(main())

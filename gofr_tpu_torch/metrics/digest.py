"""Bounded streaming quantile sketch with sliding time windows.

The SLO layer needs "p99 TTFT over the last minute" answerable at any
moment without retaining per-request samples. A plain histogram with
fixed buckets (metrics/manager.py) gives coarse quantiles over the whole
process lifetime; what operators act on is a *windowed* quantile with a
known error bound.

Design (DDSketch-style, arxiv 1908.10693 idiom):

- Values are mapped to logarithmic bins: ``bin = ceil(log(v) / log(gamma))``
  with ``gamma = (1 + alpha) / (1 - alpha)``. Any quantile reconstructed
  from bin midpoints is within relative error ``alpha`` of the true value.
- Memory is bounded two ways: bins below ``min_value`` collapse into a
  single underflow bin, and time is quantised into fixed slices (default
  5s) kept in a ring covering ``max_window_s`` (default 300s). A windowed
  query merges the slices younger than the window — merging log-binned
  sketches is exact (bin-wise addition), so the 1m and 5m views come from
  the same ring.
- Each slice also tracks count and sum, so the same structure answers
  rate questions (tokens/s over a window) via :class:`WindowedCounter`.

Everything takes an optional explicit ``now`` (monotonic seconds) so
tests can drive the clock deterministically; production callers omit it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple


class _Slice:
    __slots__ = ("start", "bins", "underflow", "count", "sum", "min", "max")

    def __init__(self, start: float):
        self.start = start
        self.bins: Dict[int, int] = {}
        self.underflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class WindowedDigest:
    """Sliding-window quantile sketch (relative error ``alpha``).

    ``record(value)`` is O(1); ``quantile(q, window_s)`` merges at most
    ``max_window_s / slice_s`` slices. Thread-safe.
    """

    def __init__(self, alpha: float = 0.01, slice_s: float = 5.0,
                 max_window_s: float = 300.0, min_value: float = 1e-6,
                 max_bins: int = 2048):
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.slice_s = float(slice_s)
        self.max_window_s = float(max_window_s)
        self.min_value = float(min_value)
        self._min_bin = int(math.ceil(math.log(self.min_value)
                                      / self._log_gamma))
        self.max_bins = int(max_bins)
        self._slices: List[_Slice] = []
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------
    def record(self, value: float, now: Optional[float] = None) -> None:
        if value is None or math.isnan(value):
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            slc = self._current_slice(now)
            slc.count += 1
            slc.sum += value
            if value < slc.min:
                slc.min = value
            if value > slc.max:
                slc.max = value
            if value < self.min_value:
                slc.underflow += 1
                return
            idx = self._bin_index(value)
            slc.bins[idx] = slc.bins.get(idx, 0) + 1
            # hard cap per slice: collapse the lowest bins together rather
            # than growing without bound under adversarial value spreads
            if len(slc.bins) > self.max_bins:
                lowest = sorted(slc.bins)[: len(slc.bins) - self.max_bins + 1]
                keep = lowest[-1]
                merged = sum(slc.bins.pop(b) for b in lowest[:-1])
                slc.bins[keep] = slc.bins.get(keep, 0) + merged

    # -- queries ------------------------------------------------------------
    def quantile(self, q: float, window_s: float = 60.0,
                 now: Optional[float] = None) -> Optional[float]:
        """q in [0, 1]; returns None when the window holds no samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        now = time.monotonic() if now is None else now
        with self._lock:
            merged, underflow, count, _, vmin, vmax = self._merged(window_s, now)
        total = count
        if total == 0:
            return None
        rank = q * (total - 1)
        # underflow bin sits below every log bin
        seen = underflow
        if rank < seen:
            return self.min_value
        for idx in sorted(merged):
            seen += merged[idx]
            if rank < seen:
                # bin midpoint: 2*gamma^idx / (gamma+1), clamped to the
                # observed extremes so q=0/q=1 answer min/max-ish values
                mid = 2.0 * math.pow(self.gamma, idx) / (self.gamma + 1.0)
                return min(max(mid, vmin), vmax)
        return vmax if vmax > -math.inf else None

    def count(self, window_s: float = 60.0, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._merged(window_s, now)[2]

    def sum(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._merged(window_s, now)[3]

    def rate(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        """Sum per second over the window (e.g. tokens/s)."""
        return self.sum(window_s, now) / max(window_s, 1e-9)

    def snapshot(self, windows: Tuple[float, ...] = (60.0, 300.0),
                 quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99),
                 now: Optional[float] = None) -> Dict[str, Dict[str, Optional[float]]]:
        """JSON-ready view: ``{"60s": {"count":…, "p50":…, …}, "300s": …}``."""
        now = time.monotonic() if now is None else now
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for window in windows:
            entry: Dict[str, Optional[float]] = {
                "count": float(self.count(window, now)),
                "sum": self.sum(window, now),
            }
            for q in quantiles:
                entry[f"p{int(q * 100)}"] = self.quantile(q, window, now)
            out[f"{int(window)}s"] = entry
        return out

    # -- internals ----------------------------------------------------------
    def _bin_index(self, value: float) -> int:
        return max(int(math.ceil(math.log(value) / self._log_gamma)),
                   self._min_bin)

    def _current_slice(self, now: float) -> _Slice:
        start = math.floor(now / self.slice_s) * self.slice_s
        if self._slices and self._slices[-1].start == start:
            return self._slices[-1]
        slc = _Slice(start)
        self._slices.append(slc)
        self._expire(now)
        return slc

    def _expire(self, now: float) -> None:
        horizon = now - self.max_window_s - self.slice_s
        while self._slices and self._slices[0].start < horizon:
            self._slices.pop(0)

    def _merged(self, window_s: float, now: float):
        self._expire(now)
        horizon = now - min(window_s, self.max_window_s)
        merged: Dict[int, int] = {}
        underflow = 0
        count = 0
        total = 0.0
        vmin = math.inf
        vmax = -math.inf
        for slc in self._slices:
            # a slice belongs to the window if any part of it is younger
            # than the horizon (conservative: includes the boundary slice)
            if slc.start + self.slice_s <= horizon:
                continue
            underflow += slc.underflow
            count += slc.count
            total += slc.sum
            vmin = min(vmin, slc.min)
            vmax = max(vmax, slc.max)
            for idx, n in slc.bins.items():
                merged[idx] = merged.get(idx, 0) + n
        return merged, underflow, count, total, vmin, vmax


class WindowedCounter:
    """Sliding-window sum — the rate half of the SLO story (tokens/s,
    goodput tokens/s, device-busy seconds per wall second). Same slice
    ring as :class:`WindowedDigest`, without the quantile bins."""

    __slots__ = ("slice_s", "max_window_s", "_slices", "_total", "_lock")

    def __init__(self, slice_s: float = 5.0, max_window_s: float = 300.0):
        self.slice_s = float(slice_s)
        self.max_window_s = float(max_window_s)
        self._slices: List[Tuple[float, float]] = []  # (start, sum) pairs
        self._total = 0.0
        self._lock = threading.Lock()

    def add(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        start = math.floor(now / self.slice_s) * self.slice_s
        with self._lock:
            self._total += value
            if self._slices and self._slices[-1][0] == start:
                prev_start, prev_sum = self._slices[-1]
                self._slices[-1] = (prev_start, prev_sum + value)
            else:
                self._slices.append((start, value))
                horizon = now - self.max_window_s - self.slice_s
                while self._slices and self._slices[0][0] < horizon:
                    self._slices.pop(0)

    def sum(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        horizon = now - min(window_s, self.max_window_s)
        with self._lock:
            return sum(s for start, s in self._slices
                       if start + self.slice_s > horizon)

    def rate(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        return self.sum(window_s, now) / max(window_s, 1e-9)

    def total(self) -> float:
        """Lifetime sum (monotonic, unlike the windowed views)."""
        with self._lock:
            return self._total

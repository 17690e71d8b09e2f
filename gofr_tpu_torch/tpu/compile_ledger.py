"""Compile-plane and shape-plane bookkeeping (a copy of
``gofr_tpu/tpu/compile_ledger.py``): every graph capture the executor
ran, device-seconds per executable family, the one charge helper that
splits a step's dispatch-to-publish window over SLO classes and
families, the bucket-fit accounting and the padding-optimal ladder
suggestion.

- :class:`CompileLedger`: a bounded ring of compile events plus a
  windowed serve-time-compile counter (the recompile-storm signal the
  watchdog reads through ``serving_compiles(window_s)``). In the port a
  compile is a CUDA-graph capture of one (model, bucket); its
  fingerprint (:func:`fingerprint_capture`) hashes what fixes the graph,
  as JAX's hashes the lowered StableHLO text.
- :class:`ExecutableLedger` + :func:`charge_device_time`: one measured
  elapsed charges both the ``{model, cls}`` aggregate
  (``app_tpu_device_seconds_total``) and the ``{model, family}`` row
  (``app_tpu_executable_device_seconds_total``), so the two totals agree
  by construction. In the port a family is a tick's CUDA graph rung, a
  prefill's shape or an executor bucket, named as the JAX package names
  its executables.
- :class:`ShapeStats`: observed sizes against the bucket ladder, real
  rows against padded rows over sliding windows.
- :func:`suggest_ladder`: the padding-optimal ladder of a given rung
  count for an observed distribution.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from gofr_tpu_torch.metrics.digest import WindowedCounter

CAUSE_WARMUP = "warmup"
CAUSE_SERVING = "serving"


def fingerprint_capture(fn: Any, bucket: int, inputs: Sequence[Tuple],
                        params: Sequence[Tuple],
                        launches: Optional[Dict[str, int]] = None) -> str:
    """Stable 16-hex-digit fingerprint of one captured (model, bucket)
    graph, the port's counterpart of JAX's ``fingerprint_lowered``: there
    is no HLO text, so it hashes what fixes the graph: ``fn``'s code
    (bytecode, constants and qualified name), the bucket, the inputs' and
    the params' (shape, dtype) specs in order, and the kernel launches
    the capture counted. Two captures with the same fingerprint built
    the same graph."""
    code = getattr(fn, "__code__", None)
    parts = [getattr(fn, "__qualname__", repr(type(fn))), str(bucket),
             repr(list(inputs)), repr(list(params)),
             repr(sorted((launches or {}).items()))]
    digest = hashlib.sha256("|".join(parts).encode())
    if code is not None:
        digest.update(code.co_code)
        digest.update(repr(code.co_consts).encode())
    return digest.hexdigest()[:16]


class CompileEvent:
    __slots__ = ("ordinal", "model", "bucket", "cause", "duration_s",
                 "fingerprint", "wall_at")

    def __init__(self, ordinal: int, model: str, bucket: int, cause: str,
                 duration_s: float, fingerprint: Optional[str]):
        self.ordinal = ordinal
        self.model = model
        self.bucket = bucket
        self.cause = cause
        self.duration_s = duration_s
        self.fingerprint = fingerprint
        self.wall_at = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ordinal": self.ordinal,
            "model": self.model,
            "bucket": self.bucket,
            "cause": self.cause,
            "duration_s": round(self.duration_s, 4),
            "fingerprint": self.fingerprint,
            "at": self.wall_at,
        }


class CompileLedger:
    """Bounded record of every (model, bucket) graph capture plus
    windowed serve-time-compile counts (JAX ``CompileLedger``).
    Thread-safe: captures happen under model locks on worker threads,
    snapshots come from admin endpoints."""

    def __init__(self, metrics: Any = None, capacity: int = 256):
        self.metrics = metrics
        self._events: "deque[CompileEvent]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0
        self._totals_by_cause: Dict[str, int] = {}
        self._serving = WindowedCounter()
        self._seconds_total = 0.0

    def record(self, model: str, bucket: int, cause: str,
               duration_s: float, fingerprint: Optional[str] = None,
               now: Optional[float] = None) -> CompileEvent:
        with self._lock:
            self._total += 1
            event = CompileEvent(self._total, model, bucket, cause,
                                 duration_s, fingerprint)
            self._events.append(event)
            self._totals_by_cause[cause] = \
                self._totals_by_cause.get(cause, 0) + 1
            self._seconds_total += duration_s
        if cause == CAUSE_SERVING:
            self._serving.add(1.0, now=now)
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_compile_total",
                                           cause=cause, model=model)
            self.metrics.record_histogram("app_tpu_compile_seconds",
                                          duration_s, model=model,
                                          cause=cause)
        return event

    def serving_compiles(self, window_s: float = 60.0,
                         now: Optional[float] = None) -> float:
        """Serve-time compiles inside the window: the recompile-storm
        input the watchdog compares against its threshold."""
        return self._serving.sum(window_s, now)

    def total(self, cause: Optional[str] = None) -> int:
        with self._lock:
            if cause is None:
                return self._total
            return self._totals_by_cause.get(cause, 0)

    def snapshot(self, limit: int = 64,
                 now: Optional[float] = None) -> Dict[str, Any]:
        with self._lock:
            events = [e.to_dict() for e in self._events]
            totals = dict(self._totals_by_cause)
            seconds = self._seconds_total
        events = events[-limit:]
        events.reverse()   # newest first, the ops-facing order
        return {
            "total": sum(totals.values()),
            "by_cause": totals,
            "compile_seconds_total": round(seconds, 4),
            "serving_compiles_60s": self.serving_compiles(60.0, now),
            "recent": events,
        }


class ExecutableLedger:
    """Device-seconds per compiled executable *family* — the answer to
    "which executable is burning the device time, and how far from
    roofline is it?". A family is the stable human-readable key of one
    compiled program shape (``decode_paged[k=8,pw=16]``,
    ``prefill[nb=4,b=64]``, executor ``b32`` buckets); rows accumulate
    device-seconds, dispatch counts, and (when the caller knows them)
    executed FLOPs, from which the snapshot derives achieved FLOP/s and
    the achieved-vs-roofline ratio against ``peak_flops``.

    Bounded: the family set is closed by the compile ladders, but a
    misbehaving caller cannot grow it past ``max_families`` — excess
    charges are counted in ``dropped_families`` rather than stored.
    Thread-safe (executor fetches run on worker threads)."""

    def __init__(self, metrics: Any = None, peak_flops: float = 0.0,
                 max_families: int = 256):
        self.metrics = metrics
        self.peak_flops = float(peak_flops)
        self._max_families = int(max_families)
        self._lock = threading.Lock()
        # (model, family) -> [device_seconds, dispatches, flops]
        self._rows: Dict[Tuple[str, str], List[float]] = {}
        self._dropped = 0

    def charge(self, model: str, family: str, seconds: float,
               flops: Optional[float] = None) -> None:
        """One dispatch→publish measurement for ``family``. ``flops`` is
        the executed FLOPs of that dispatch when the caller has a cached
        ``cost_analysis`` (executor buckets); the engine passes None and
        its rows report a null roofline ratio rather than a guessed
        one."""
        if seconds <= 0:
            return
        key = (model, family)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                if len(self._rows) >= self._max_families:
                    self._dropped += 1
                    return
                row = self._rows[key] = [0.0, 0, 0.0]
            row[0] += seconds
            row[1] += 1
            if flops:
                row[2] += flops
        if self.metrics is not None:
            self.metrics.delta_updown_counter(
                "app_tpu_executable_device_seconds_total", seconds,
                model=model, family=family)

    def total_seconds(self, model: Optional[str] = None) -> float:
        with self._lock:
            return sum(row[0] for (m, _), row in self._rows.items()
                       if model is None or m == model)

    def snapshot(self, limit: int = 12) -> Dict[str, Any]:
        """Ranked top-offenders table (xlaz/statusz/workloadz): families
        by device-seconds descending, each with its share of the total,
        dispatch count, and roofline position when FLOPs are known."""
        with self._lock:
            rows = [(m, f, row[0], row[1], row[2])
                    for (m, f), row in self._rows.items()]
            dropped = self._dropped
        total = sum(seconds for _, _, seconds, _, _ in rows)
        rows.sort(key=lambda r: r[2], reverse=True)
        top = []
        for model, family, seconds, dispatches, flops in rows[:limit]:
            achieved = flops / seconds if flops and seconds > 0 else None
            top.append({
                "model": model,
                "family": family,
                "device_seconds": round(seconds, 6),
                "dispatches": int(dispatches),
                "share": round(seconds / total, 4) if total > 0 else None,
                "achieved_flops_per_s": achieved,
                "roofline_ratio": (round(achieved / self.peak_flops, 6)
                                   if achieved is not None
                                   and self.peak_flops > 0 else None),
            })
        return {
            "families": len(rows),
            "device_seconds_total": round(total, 6),
            "peak_flops": self.peak_flops or None,
            "dropped_families": dropped,
            "top": top,
        }


def charge_device_time(elapsed_s: float, model: str,
                       classes: Optional[Sequence[str]] = None,
                       family: Optional[str] = None,
                       device_seconds: Optional[Dict[Tuple[str, str],
                                                     float]] = None,
                       metrics: Any = None,
                       ledger: Optional[ExecutableLedger] = None,
                       flops: Optional[float] = None) -> None:
    """The shared dispatch-site timing helper: ONE
    measured elapsed charges every attribution plane that wants it, so
    the per-class aggregate and the per-family ledger cannot disagree.

    - ``classes`` + ``device_seconds``/``metrics``: split ``elapsed_s``
      evenly across the participating requests' SLO classes and charge
      the ``{model, cls}`` aggregate (``app_tpu_device_seconds_total``)
      — the engine path. Callers that already account the aggregate
      elsewhere (the executor, whose duty cycle rides ``_busy_s``) pass
      ``classes=None`` and the aggregate is untouched: no double count.
    - ``family`` + ``ledger``: charge the full ``elapsed_s`` once to the
      ``{model, family}`` executable row.
    """
    if elapsed_s <= 0:
        return
    if classes:
        share = elapsed_s / len(classes)
        for cls in classes:
            if device_seconds is not None:
                key = (model, cls)
                device_seconds[key] = device_seconds.get(key, 0.0) + share
            if metrics is not None:
                metrics.delta_updown_counter(
                    "app_tpu_device_seconds_total", share,
                    model=model, cls=cls)
    if ledger is not None and family is not None:
        ledger.charge(model, family, elapsed_s, flops=flops)


class ShapeStats:
    """Per-model bucket-fit accounting: which batch sizes traffic really
    arrives at, which buckets they land in, and how many device rows are
    padding. O(1) per execute, bounded by the number of distinct
    (model, size) pairs — at most ``max_batch`` per model."""

    def __init__(self, metrics: Any = None):
        self.metrics = metrics
        self._lock = threading.Lock()
        # model -> observed batch size -> count (lifetime)
        self._observed: Dict[str, Dict[int, int]] = {}
        # model -> bucket -> count (lifetime; the metric twin is labelled)
        self._hits: Dict[str, Dict[int, int]] = {}
        self._real_rows = WindowedCounter()
        self._bucket_rows = WindowedCounter()

    def record(self, model: str, n: int, bucket: int,
               now: Optional[float] = None) -> None:
        with self._lock:
            sizes = self._observed.setdefault(model, {})
            sizes[n] = sizes.get(n, 0) + 1
            hits = self._hits.setdefault(model, {})
            hits[bucket] = hits.get(bucket, 0) + 1
        self._real_rows.add(float(n), now=now)
        self._bucket_rows.add(float(bucket), now=now)
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_bucket_hits_total",
                                           model=model, bucket=str(bucket))

    def padding_ratio(self, window_s: float = 60.0,
                      now: Optional[float] = None) -> Optional[float]:
        """Fraction of executed device rows that were padding over the
        window; None when nothing executed (no data is not zero waste)."""
        bucket_rows = self._bucket_rows.sum(window_s, now)
        if bucket_rows <= 0:
            return None
        real = self._real_rows.sum(window_s, now)
        return max(0.0, 1.0 - real / bucket_rows)

    def fill_fraction(self, n: float, bucket: float) -> float:
        return n / bucket if bucket > 0 else 0.0

    def distribution(self, model: str) -> Dict[int, int]:
        with self._lock:
            return dict(self._observed.get(model, {}))

    def bucket_hits(self, model: str) -> Dict[int, int]:
        with self._lock:
            return dict(self._hits.get(model, {}))

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for window in (60.0, 300.0):
            ratio = self.padding_ratio(window, now)
            out[f"{int(window)}s"] = {
                "real_rows": self._real_rows.sum(window, now),
                "bucket_rows": self._bucket_rows.sum(window, now),
                "padding_ratio": (round(ratio, 4)
                                  if ratio is not None else None),
            }
        out["lifetime"] = {
            "real_rows": self._real_rows.total(),
            "bucket_rows": self._bucket_rows.total(),
        }
        return out


def suggest_ladder(observed: Dict[int, int], max_rungs: int = 4,
                   round_to: int = 1) -> List[int]:
    """Padding-optimal bucket ladder for an observed batch-size
    distribution: choose at most ``max_rungs`` bucket sizes such that
    every observed size fits some bucket (size <= bucket) and the total
    padded rows ``sum(count * (bucket(size) - size))`` is minimal.

    Exact dynamic program over the distinct observed sizes (an optimal
    ladder only ever places rungs at observed sizes, rounded up to
    ``round_to`` — the dp-mesh multiple the executor enforces at
    register time). O(m^2 * max_rungs) with m = distinct sizes, which is
    bounded by max_batch. Returns [] for an empty distribution."""
    if not observed:
        return []
    round_to = max(1, int(round_to))
    sizes = sorted(s for s in observed if s > 0)
    if not sizes:
        return []
    counts = [observed[s] for s in sizes]
    m = len(sizes)
    rungs = max(1, int(max_rungs))

    def rung_value(size: int) -> int:
        return -(-size // round_to) * round_to

    # cost[j][i]: padded rows when sizes j..i all ride a rung at sizes[i]
    cost = [[0] * m for _ in range(m)]
    for j in range(m):
        for i in range(j, m):
            rung = rung_value(sizes[i])
            cost[j][i] = sum(counts[t] * (rung - sizes[t])
                             for t in range(j, i + 1))

    INF = float("inf")
    # best[k][i]: min padded rows covering sizes 0..i with k rungs, the
    # k-th rung sitting at sizes[i]
    best = [[INF] * m for _ in range(rungs + 1)]
    choice = [[-1] * m for _ in range(rungs + 1)]
    for i in range(m):
        best[1][i] = cost[0][i]
    for k in range(2, rungs + 1):
        for i in range(m):
            for j in range(i):
                candidate = best[k - 1][j] + cost[j + 1][i]
                if candidate < best[k][i]:
                    best[k][i] = candidate
                    choice[k][i] = j
    # the top rung must cover the largest observed size
    k_best = min(range(1, rungs + 1), key=lambda k: best[k][m - 1])
    ladder = []
    i, k = m - 1, k_best
    while i >= 0 and k >= 1:
        ladder.append(rung_value(sizes[i]))
        i = choice[k][i]
        k -= 1
    ladder.reverse()
    # rounding can collapse adjacent rungs onto the same value
    return sorted(set(ladder))

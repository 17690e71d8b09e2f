"""Bounded in-process time-series store, the telemetry plane's memory (a
copy of ``gofr_tpu/metrics/timeseries.py``: its tiers, capacities and
detector arithmetic, so the same readings at the same instants give the
same series and anomalies).

- A fixed-cadence sampler (``TELEMETRY_INTERVAL_S``, default 1 s) reads a
  registered set of signal callables into per-signal rings at three
  resolutions: 1 s x 600, 10 s x 360, 60 s x 240 buckets, each bucket
  one ``[start, count, total, min, max]`` aggregate, so a signal holds
  at most ``MAX_BUCKETS_PER_SIGNAL`` buckets whatever the uptime (plus
  its share of the 600-sample delta log).
- A robust z-score change-point detector per signal (median/MAD over the
  trailing 1 s tier, with hysteresis) annotates the series, counts
  ``app_tpu_anomaly_total{signal,direction}`` and, for a signal
  registered with a ``watch`` direction, feeds the watchdog's
  ``anomaly_fn`` with the signal named.
- :meth:`TimeSeriesStore.delta` exports samples after a cursor, bounded.
- :meth:`TimeSeriesStore.note_tick` keeps a ring of sampled decode-tick
  anatomies (the engine's ``attach_telemetry``).

The sampler runs on the event loop and reads host state only: the
engine's ``stats()`` and :func:`~gofr_tpu_torch.hbmz.hbm_occupancy` make
no device sync. Every entry point takes an optional ``now`` (monotonic
seconds), so tests drive the clock.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "SeriesRing",
    "RobustDetector",
    "TimeSeriesStore",
    "new_timeseries",
    "register_default_signals",
    "TIERS",
    "MAX_BUCKETS_PER_SIGNAL",
]

# (tier name, bucket seconds, ring capacity). The capacities are the
# memory contract: a signal can never hold more than
# ``MAX_BUCKETS_PER_SIGNAL`` aggregates, whatever the process uptime.
TIERS: Tuple[Tuple[str, float, int], ...] = (
    ("1s", 1.0, 600),
    ("10s", 10.0, 360),
    ("60s", 60.0, 240),
)
MAX_BUCKETS_PER_SIGNAL = sum(cap for _, _, cap in TIERS)

# raw 1s samples kept for cursor-based fleet delta pulls (10 minutes)
DELTA_LOG_CAPACITY = 600
# samples shipped per delta() answer — bounds the probe payload even
# after a long probe outage (the puller resumes with reset=True)
DELTA_MAX_SAMPLES = 120

_SPARK_BLOCKS = " ▁▂▃▄▅▆▇█"


class SeriesRing:
    """One resolution tier of one signal: a fixed-capacity ring of
    aligned bucket aggregates ``[bucket_start, count, total, min, max]``.

    Buckets align on ``int(now // bucket_s) * bucket_s`` so every signal
    sampled at the same instant lands in the same bucket — the alignment
    the timez endpoint and the fleet rollup rely on."""

    __slots__ = ("bucket_s", "capacity", "_buckets")

    def __init__(self, bucket_s: float, capacity: int):
        self.bucket_s = float(bucket_s)
        self.capacity = int(capacity)
        self._buckets: deque = deque(maxlen=self.capacity)

    def add(self, value: float, now: float) -> None:
        start = int(now // self.bucket_s) * self.bucket_s
        if self._buckets and self._buckets[-1][0] == start:
            bucket = self._buckets[-1]
            bucket[1] += 1
            bucket[2] += value
            if value < bucket[3]:
                bucket[3] = value
            if value > bucket[4]:
                bucket[4] = value
        else:
            # deque(maxlen) evicts the oldest bucket for us
            self._buckets.append([start, 1, value, value, value])

    def __len__(self) -> int:
        return len(self._buckets)

    def points(self, limit: Optional[int] = None) -> List[Dict[str, float]]:
        """Oldest-first ``{t, mean, min, max, count}`` per bucket."""
        buckets = list(self._buckets)
        if limit is not None:
            buckets = buckets[-int(limit):]
        return [{"t": b[0], "mean": b[2] / b[1], "min": b[3],
                 "max": b[4], "count": b[1]} for b in buckets]

    def means(self, limit: Optional[int] = None) -> List[Tuple[float, float]]:
        buckets = list(self._buckets)
        if limit is not None:
            buckets = buckets[-int(limit):]
        return [(b[0], b[2] / b[1]) for b in buckets]

    def window_mean(self, window_s: float, now: float) -> Optional[float]:
        """Count-weighted mean of samples in ``[now - window_s, now]``;
        None when the window holds nothing."""
        cutoff = now - window_s
        count = 0
        total = 0.0
        for b in reversed(self._buckets):
            if b[0] + self.bucket_s < cutoff:
                break
            count += b[1]
            total += b[2]
        if count == 0:
            return None
        return total / count


class RobustDetector:
    """Per-signal change-point detector: robust z-score with hysteresis.

    Each observation is scored against the median/MAD of the trailing
    baseline (the signal's recent 1s bucket means, excluding the newest
    ``guard`` buckets so the anomaly itself never poisons its own
    baseline). ``trigger_after`` consecutive outliers in the same
    direction raise the anomaly; ``clear_after`` consecutive in-band
    observations clear it — the same streak shape as the SLO watchdog,
    so one noisy sample never flips anything."""

    __slots__ = ("threshold", "min_baseline", "guard", "trigger_after",
                 "clear_after", "active", "_hot_streak", "_hot_direction",
                 "_calm_streak", "last_z")

    def __init__(self, threshold: float = 6.0, min_baseline: int = 20,
                 guard: int = 5, trigger_after: int = 3,
                 clear_after: int = 5):
        self.threshold = float(threshold)
        self.min_baseline = int(min_baseline)
        self.guard = int(guard)
        self.trigger_after = max(1, int(trigger_after))
        self.clear_after = max(1, int(clear_after))
        self.active: Optional[Dict[str, Any]] = None
        self._hot_streak = 0
        self._hot_direction: Optional[str] = None
        self._calm_streak = 0
        self.last_z = 0.0

    def observe(self, value: float, ring: SeriesRing,
                now: float) -> Optional[Dict[str, Any]]:
        """Score one sample; returns a transition event dict when the
        anomaly state changed (``state`` raised|cleared), else None."""
        means = [m for _, m in ring.means()]
        baseline = means[:-self.guard] if self.guard else means
        if len(baseline) < self.min_baseline:
            return None
        ordered = sorted(baseline)
        mid = len(ordered) // 2
        median = ordered[mid] if len(ordered) % 2 else \
            (ordered[mid - 1] + ordered[mid]) / 2.0
        deviations = sorted(abs(m - median) for m in baseline)
        mad = deviations[len(deviations) // 2]
        if mad == 0.0 and median == 0.0:
            # dead-flat zero baseline: an idle signal starting to move
            # is cold start, not a change point — with no variance and
            # no level there is nothing to score it against, and the
            # epsilon floor would turn the first request after idle
            # into a z in the hundreds of thousands
            self._hot_streak = 0
            self._hot_direction = None
            return None
        # MAD floor: a flat baseline (mad == 0) must not turn every
        # wiggle into an infinite z — 5% of the median's magnitude (or
        # an absolute epsilon for signals hovering at zero) is the
        # smallest move worth scoring
        scale = max(mad / 0.6745, abs(median) * 0.05, 1e-6)
        z = (value - median) / scale
        self.last_z = z
        direction = "up" if z > 0 else "down"
        if abs(z) >= self.threshold:
            if self._hot_direction == direction:
                self._hot_streak += 1
            else:
                self._hot_direction = direction
                self._hot_streak = 1
            self._calm_streak = 0
            if self.active is None and \
                    self._hot_streak >= self.trigger_after:
                self.active = {"direction": direction, "since": now,
                               "z": round(z, 2), "baseline": round(median, 6)}
                return {"state": "raised", "direction": direction,
                        "z": round(z, 2), "at": now}
            if self.active is not None:
                self.active["z"] = round(z, 2)
        else:
            self._hot_streak = 0
            self._hot_direction = None
            if self.active is not None:
                self._calm_streak += 1
                if self._calm_streak >= self.clear_after:
                    cleared = self.active
                    self.active = None
                    self._calm_streak = 0
                    return {"state": "cleared",
                            "direction": cleared["direction"],
                            "z": round(z, 2), "at": now}
        return None


class _Signal:
    __slots__ = ("name", "fn", "kind", "watch", "rings", "detector",
                 "_last_raw", "_last_now")

    def __init__(self, name: str, fn: Optional[Callable[[], Any]],
                 kind: str, watch: Optional[str],
                 detector: RobustDetector):
        self.name = name
        self.fn = fn
        self.kind = kind        # "gauge" | "counter" (counter -> rate)
        self.watch = watch      # None | "up" | "down" | "both"
        self.rings = tuple(SeriesRing(b, cap) for _, b, cap in TIERS)
        self.detector = detector
        self._last_raw: Optional[float] = None
        self._last_now: Optional[float] = None

    def ingest(self, raw: float, now: float) -> Optional[float]:
        """Convert one raw reading into the recorded value: gauges pass
        through, counters difference into a per-second rate (first
        sample and clock stalls are skipped, resets clamp at 0)."""
        if self.kind != "counter":
            return raw
        last_raw, last_now = self._last_raw, self._last_now
        self._last_raw, self._last_now = raw, now
        if last_raw is None or last_now is None or now <= last_now:
            return None
        return max(0.0, raw - last_raw) / (now - last_now)


class TimeSeriesStore:
    """The telemetry plane: registered signals, multi-resolution rings,
    anomaly detection, cursor deltas, and the tick-anatomy ring.

    ``sample(now)`` is the one write path; ``start()`` runs it on a
    fixed cadence from the event loop. Every read path is a plain
    snapshot over bounded structures — safe to call from any debug
    handler."""

    def __init__(self, metrics: Any = None, logger: Any = None, *,
                 interval_s: float = 1.0, tick_sample: int = 64,
                 tick_capacity: int = 256,
                 detector_threshold: float = 6.0,
                 detector_min_baseline: int = 20,
                 detector_trigger_after: int = 3,
                 detector_clear_after: int = 5):
        self.metrics = metrics
        self.logger = logger
        self.interval_s = max(0.05, float(interval_s))
        self.tick_sample = max(1, int(tick_sample))
        self._detector_opts = dict(
            threshold=detector_threshold,
            min_baseline=detector_min_baseline,
            trigger_after=detector_trigger_after,
            clear_after=detector_clear_after)
        self._signals: Dict[str, _Signal] = {}
        self._providers: List[Tuple[Tuple[str, ...],
                                    Callable[[], Dict[str, Any]]]] = []
        self._seq = 0
        self._delta_log: deque = deque(maxlen=DELTA_LOG_CAPACITY)
        self._ticks: deque = deque(maxlen=max(1, int(tick_capacity)))
        self._anomaly_events: deque = deque(maxlen=64)
        self._task: Optional[asyncio.Task] = None

    # -- registration -------------------------------------------------------
    def register(self, name: str, fn: Callable[[], Any], *,
                 kind: str = "gauge",
                 watch: Optional[str] = None) -> None:
        """Register one signal. ``fn()`` returns the current reading (a
        number, or None while the signal is unavailable). ``kind``
        "counter" differences cumulative readings into a per-second
        rate. ``watch`` opts the signal's anomalies into the watchdog
        feed, filtered by direction ("down" = only a cliff degrades,
        "up" = only a spike, "both")."""
        self._signals[name] = _Signal(
            name, fn, kind, watch, RobustDetector(**self._detector_opts))

    def register_provider(self, names: Iterable[str],
                          fn: Callable[[], Dict[str, Any]], *,
                          kinds: Optional[Dict[str, str]] = None,
                          watch: Optional[Dict[str, str]] = None) -> None:
        """Register several signals fed by ONE snapshot callable — the
        provider runs once per sample, so signals sharing an expensive
        source (``stats()``, ``saturation()``) cost one call, not N."""
        names = tuple(names)
        kinds = kinds or {}
        watch = watch or {}
        for name in names:
            self._signals[name] = _Signal(
                name, None, kinds.get(name, "gauge"), watch.get(name),
                RobustDetector(**self._detector_opts))
        self._providers.append((names, fn))

    def signals(self) -> List[str]:
        return sorted(self._signals)

    # -- the write path -----------------------------------------------------
    def sample(self, now: Optional[float] = None) -> Dict[str, float]:
        """One sampling pass: read every signal, record into all tiers,
        run the detector, append to the delta log. A broken source
        skips its signals for this pass — telemetry must never take the
        serving plane down."""
        now = time.monotonic() if now is None else now
        raw: Dict[str, float] = {}
        for signal in self._signals.values():
            if signal.fn is None:
                continue
            try:
                value = signal.fn()
            except Exception:
                continue
            if value is not None:
                raw[signal.name] = float(value)
        for names, provider in self._providers:
            try:
                out = provider()
            except Exception:
                continue
            if not isinstance(out, dict):
                continue
            for name in names:
                value = out.get(name)
                if value is not None:
                    raw[name] = float(value)
        recorded: Dict[str, float] = {}
        for name, value in raw.items():
            signal = self._signals[name]
            cooked = signal.ingest(value, now)
            if cooked is None:
                continue
            for ring in signal.rings:
                ring.add(cooked, now)
            recorded[name] = cooked
            event = signal.detector.observe(cooked, signal.rings[0], now)
            if event is not None:
                self._note_anomaly(signal, event)
        self._seq += 1
        self._delta_log.append((self._seq, now, recorded))
        return recorded

    def _note_anomaly(self, signal: _Signal,
                      event: Dict[str, Any]) -> None:
        entry = dict(event, signal=signal.name)
        self._anomaly_events.append(entry)
        if event["state"] == "raised":
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_anomaly_total", signal=signal.name,
                    direction=event["direction"])
            if self.logger is not None:
                self.logger.warn(
                    "telemetry anomaly: %s %s (z=%.1f)", signal.name,
                    event["direction"], event["z"])
        elif self.logger is not None:
            self.logger.info("telemetry anomaly cleared: %s", signal.name)

    # -- anomaly views ------------------------------------------------------
    def anomalies(self) -> Dict[str, Any]:
        active = {
            name: dict(signal.detector.active)
            for name, signal in self._signals.items()
            if signal.detector.active is not None
        }
        return {"active": active,
                "recent": list(self._anomaly_events)}

    def watchdog_reasons(self) -> List[str]:
        """Active anomalies on watch-listed signals, rendered as
        watchdog reasons — the feed ``Watchdog.anomaly_fn`` consumes.
        Direction-filtered: a goodput *spike* is not a health problem."""
        reasons = []
        for name in sorted(self._signals):
            signal = self._signals[name]
            active = signal.detector.active
            if active is None or signal.watch is None:
                continue
            if signal.watch != "both" and active["direction"] != signal.watch:
                continue
            reasons.append(
                f"telemetry anomaly: {name} {active['direction']} "
                f"(z={active['z']:.1f}, baseline={active['baseline']:.3g})")
        return reasons

    # -- read paths ---------------------------------------------------------
    def window_mean(self, name: str, window_s: float,
                    now: Optional[float] = None) -> Optional[float]:
        """Count-weighted mean of one signal over the trailing
        ``window_s``, read from the *finest* tier whose span can cover
        the window (1s up to 10 minutes, 10s up to 1 hour, 60s up to 4
        hours). Every tier ingests every sample, so the mean is
        tier-consistent: a window that hops from the 10s ring to the
        60s ring sees the same count-weighted samples, just coarser
        bucket boundaries — the property the burn-rate plane's
        tier-boundary tests pin down. None when the signal
        is unknown or the window holds nothing."""
        signal = self._signals.get(name)
        if signal is None:
            return None
        now = time.monotonic() if now is None else now
        for (_, bucket_s, capacity), ring in zip(TIERS, signal.rings):
            if bucket_s * capacity >= window_s:
                return ring.window_mean(window_s, now)
        return signal.rings[-1].window_mean(window_s, now)

    def series(self, tier: str = "10s",
               signals: Optional[Iterable[str]] = None,
               limit: Optional[int] = None) -> Dict[str, Any]:
        """Aligned view of one tier: a shared ``t`` axis (bucket starts,
        oldest first) plus one value column per signal, None where a
        signal has no bucket at that instant."""
        try:
            tier_idx = [name for name, _, _ in TIERS].index(tier)
        except ValueError:
            raise ValueError(f"unknown tier {tier!r}; "
                             f"one of {[n for n, _, _ in TIERS]}")
        bucket_s = TIERS[tier_idx][1]
        chosen = sorted(signals) if signals is not None \
            else sorted(self._signals)
        per_signal: Dict[str, Dict[float, float]] = {}
        axis: set = set()
        for name in chosen:
            signal = self._signals.get(name)
            if signal is None:
                continue
            means = dict(signal.rings[tier_idx].means(limit))
            per_signal[name] = means
            axis.update(means)
        t = sorted(axis)
        if limit is not None:
            t = t[-int(limit):]
        return {
            "tier": tier,
            "bucket_s": bucket_s,
            "t": t,
            "series": {
                name: [means.get(ts) for ts in t]
                for name, means in per_signal.items()
            },
        }

    def delta(self, cursor: Optional[int] = None) -> Dict[str, Any]:
        """Samples after ``cursor`` (a sequence number from a previous
        answer), capped at ``DELTA_MAX_SAMPLES``. ``reset=True`` tells
        the puller its cursor fell off the log (long probe outage, or a
        replica restart rewound the sequence) — the samples carried are
        a fresh start, not a contiguous continuation. Timestamps are the
        *source* process's monotonic clock; pullers must re-stamp with
        their own."""
        reset = False
        if cursor is None:
            reset = True
            entries = list(self._delta_log)
        elif cursor > self._seq:
            # the replica restarted (sequence rewound): resync
            reset = True
            entries = list(self._delta_log)
        else:
            oldest = self._delta_log[0][0] if self._delta_log else self._seq
            if cursor + 1 < oldest:
                reset = True
                entries = list(self._delta_log)
            else:
                entries = [e for e in self._delta_log if e[0] > cursor]
        if len(entries) > DELTA_MAX_SAMPLES:
            reset = reset or cursor is not None
            entries = entries[-DELTA_MAX_SAMPLES:]
        return {
            "cursor": self._seq,
            "reset": reset,
            "interval_s": self.interval_s,
            "samples": [{"seq": seq, "t": t, "values": values}
                        for seq, t, values in entries],
        }

    def sparklines(self, tier: str = "10s", width: int = 30,
                   signals: Optional[Iterable[str]] = None) -> List[str]:
        """Compact ASCII sparkline per signal — the telemetry section
        statusz embeds."""
        try:
            tier_idx = [name for name, _, _ in TIERS].index(tier)
        except ValueError:
            tier_idx = 1
        lines = []
        chosen = sorted(signals) if signals is not None \
            else sorted(self._signals)
        for name in chosen:
            signal = self._signals.get(name)
            if signal is None:
                continue
            means = [m for _, m in signal.rings[tier_idx].means(width)]
            if not means:
                continue
            low, high = min(means), max(means)
            span = high - low
            if span <= 0:
                spark = _SPARK_BLOCKS[1] * len(means)
            else:
                top = len(_SPARK_BLOCKS) - 1
                spark = "".join(
                    _SPARK_BLOCKS[1 + int((m - low) / span * (top - 1))]
                    for m in means)
            flag = ""
            if signal.detector.active is not None:
                flag = f"  !! {signal.detector.active['direction']}"
            lines.append(f"{name:<22} {spark:<{width}} "
                         f"last={means[-1]:.3g} min={low:.3g} "
                         f"max={high:.3g}{flag}")
        return lines

    # -- tick anatomy -------------------------------------------------------
    def note_tick(self, entry: Dict[str, Any]) -> None:
        """Record one sampled decode-tick anatomy (the engine calls this
        for every ``tick_sample``-th tick)."""
        self._ticks.append(entry)

    def tick_anatomy(self, limit: int = 32) -> Dict[str, Any]:
        """The sampled-tick ring: recent entries plus per-phase
        aggregates (mean/max seconds over the whole ring)."""
        entries = list(self._ticks)
        phases: Dict[str, List[float]] = {}
        for entry in entries:
            for key, value in entry.items():
                if key.endswith("_s") and isinstance(value, (int, float)):
                    phases.setdefault(key, []).append(float(value))
        return {
            "sample_every": self.tick_sample,
            "recorded": len(entries),
            "capacity": self._ticks.maxlen,
            "phases": {
                key: {"mean_s": sum(vals) / len(vals),
                      "max_s": max(vals)}
                for key, vals in sorted(phases.items())
            },
            "recent": entries[-int(limit):],
        }

    # -- bookkeeping --------------------------------------------------------
    def memory_info(self) -> Dict[str, Any]:
        """The memory contract, live: per-signal bucket ceiling and the
        actual bucket counts (always <= the ceiling)."""
        return {
            "signals": len(self._signals),
            "max_buckets_per_signal": MAX_BUCKETS_PER_SIGNAL,
            "tiers": [{"tier": name, "bucket_s": b, "capacity": cap}
                      for name, b, cap in TIERS],
            "buckets_held": sum(
                len(ring) for signal in self._signals.values()
                for ring in signal.rings),
            "delta_log_capacity": DELTA_LOG_CAPACITY,
            "delta_log_held": len(self._delta_log),
            "tick_ring_capacity": self._ticks.maxlen,
            "tick_ring_held": len(self._ticks),
        }

    def statusz(self) -> Dict[str, Any]:
        """Compact rollup for embedding in /debug/statusz."""
        anomalies = self.anomalies()
        return {
            "signals": len(self._signals),
            "samples": self._seq,
            "interval_s": self.interval_s,
            "active_anomalies": anomalies["active"],
            "sparklines": self.sparklines(),
        }

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._task is None or self._task.done():
            from gofr_tpu_torch.aio import spawn_logged
            self._task = spawn_logged(self._run(), self.logger,
                                      "telemetry.sampler",
                                      metrics=self.metrics)

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.sample()
            except Exception as exc:  # a telemetry bug must not kill the app
                if self.logger is not None:
                    self.logger.error("telemetry sample failed: %r", exc)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None


# -- default signal wiring ---------------------------------------------------

def register_default_signals(store: TimeSeriesStore, *, slo: Any = None,
                             tpu: Any = None,
                             container: Any = None) -> None:
    """Register the standard serving-signal set, duck-typed from
    whatever the deployment actually has: an SLOTracker, an executor
    (``saturation()``), a generation engine (``stats()``), the chaos
    plane, and the hbmz occupancy helper. Watch directions encode which
    way each signal fails: a goodput *cliff* and a padding *spike*
    degrade; the reverse moves are good news."""
    from gofr_tpu_torch.tpu import faults

    if slo is not None:
        store.register("raw_tok_s",
                       lambda: slo.tokens.rate(30.0))
        store.register("goodput_tok_s",
                       lambda: slo.goodput_tokens.rate(30.0),
                       watch="down")

    store.register("fault_injected_total",
                   lambda: float(sum(faults.active().fired().values())),
                   kind="counter")

    if tpu is not None and hasattr(tpu, "saturation"):
        def _saturation() -> Dict[str, Any]:
            return tpu.saturation(60.0)
        store.register_provider(
            ("padding_ratio", "effective_mfu", "duty_cycle"), _saturation,
            watch={"padding_ratio": "up", "effective_mfu": "down"})

    engine = tpu if tpu is not None and hasattr(tpu, "stats") else None
    if engine is not None:
        max_slots = float(getattr(engine, "max_slots", 0) or 0)

        def _engine_stats() -> Dict[str, Any]:
            stats = engine.stats()
            out: Dict[str, Any] = {
                "queue_depth": stats.get("queue_depth", 0),
            }
            active = stats.get("active_slots")
            if active is not None and max_slots > 0:
                out["batch_fill"] = float(active) / max_slots
            pool = stats.get("kv_pool") or {}
            if "free_pages" in pool:
                out["kv_free_pages"] = pool["free_pages"]
            if "occupancy" in pool:
                out["kv_occupancy"] = pool["occupancy"]
            classes = (stats.get("classes") or {}).get("depths") or {}
            for cls, depth in classes.items():
                out[f"queue_{cls}"] = depth
            resilience = stats.get("resilience") or {}
            out["brownout_level"] = resilience.get("brownout_level", 0)
            out["quarantine_total"] = float(
                sum((resilience.get("quarantined") or {}).values()))
            return out

        names = ["queue_depth", "batch_fill", "kv_free_pages",
                 "kv_occupancy", "brownout_level", "quarantine_total"]
        try:
            weights = engine.stats().get("classes", {}).get("weights", {})
        except Exception:
            weights = {}
        names.extend(f"queue_{cls}" for cls in sorted(weights))
        store.register_provider(
            names, _engine_stats,
            kinds={"quarantine_total": "counter"},
            watch={"queue_depth": "up", "kv_occupancy": "up"})

    ledger = getattr(tpu, "ledger", None)
    if ledger is not None and hasattr(ledger, "serving_compiles"):
        store.register("serving_compiles",
                       lambda: float(ledger.serving_compiles(60.0)),
                       watch="up")

    if container is not None:
        from gofr_tpu_torch.hbmz import hbm_occupancy
        store.register("hbm_occupancy",
                       lambda: hbm_occupancy(container), watch="up")


def new_timeseries(config: Any, *, slo: Any = None, tpu: Any = None,
                   container: Any = None, metrics: Any = None,
                   logger: Any = None) -> Optional[TimeSeriesStore]:
    """Config-driven factory (``TELEMETRY_ENABLED``, default on).
    Builds the store, registers the default signal set, and leaves
    ``start()`` to the app lifecycle."""
    if not config.get_bool("TELEMETRY_ENABLED", True):
        return None
    store = TimeSeriesStore(
        metrics=metrics, logger=logger,
        interval_s=config.get_float("TELEMETRY_INTERVAL_S", 1.0),
        tick_sample=int(config.get_float("TELEMETRY_TICK_SAMPLE", 64)))
    register_default_signals(store, slo=slo, tpu=tpu, container=container)
    return store

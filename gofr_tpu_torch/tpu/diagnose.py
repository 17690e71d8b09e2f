"""Slow-request root-cause diagnosis (a copy of
``gofr_tpu/tpu/diagnose.py``): join one flight record with its
time-window context and emit ranked verdicts.

:func:`diagnose` is a deterministic, ordered rule table: one record dict
and one context dict in, a ranked verdict list out; the same inputs give
byte-identical JSON, with no clock and no I/O. :func:`build_window_context`
snapshots the window a request ran in (the port's fault plane, the
telemetry store's anomalies, serving compiles, the engine's ``stats()``).
A :class:`WorstOffenders` ring, attached to the flight recorder, keeps the
top-K slowest requests of each window with their diagnosis computed at
finish time.

Verdict schema (one entry a fired rule, ranked by confidence)::

    {"rank": 1, "rule": "admission_backlog",
     "cause": "admission backlog: ...",
     "dominant_phase": "queue.wait",
     "phase_s": {"queue.wait": ..., "prefill": ..., "decode": ...,
                 "kv_transfer": ...},
     "e2e_s": ...,
     "confidence": 0.85,
     "evidence": [{"signal": "queue_depth", ...}, {"field": ...}]}

``signal`` evidence names a telemetry signal or metric, ``field`` a
flight-record field. Memory is bounded: the offender ring is a deque of
per-window top-K lists, trimmed on insert.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["diagnose", "build_window_context", "WorstOffenders",
           "new_offenders"]

PHASES = ("queue.wait", "prefill", "decode", "kv_transfer")


def _phases_of(record: Dict[str, Any]) -> Dict[str, float]:
    """Phase seconds from one flight-record dict (``to_dict`` plus the
    ``timing`` block). Missing phases count 0 — a shed request has no
    decode, not an unknown decode."""
    timing = record.get("timing") or {}
    queue_wait = record.get("queue_wait_s") or 0.0
    ttft = record.get("ttft_s")
    prefill = max(0.0, ttft - queue_wait) if ttft is not None else 0.0
    first = timing.get("first_token_at")
    finished = timing.get("finished_at")
    decode = max(0.0, finished - first) \
        if first is not None and finished is not None else 0.0
    kv_transfer = record.get("kv_transfer_s") or 0.0
    return {
        "queue.wait": round(float(queue_wait), 6),
        "prefill": round(float(prefill), 6),
        "decode": round(float(decode), 6),
        "kv_transfer": round(float(kv_transfer), 6),
    }


def _dominant(phases: Dict[str, float]) -> str:
    """Largest phase; ties break alphabetically — determinism over
    flattery."""
    return max(sorted(phases.items()), key=lambda item: item[1])[0]


def _e2e(record: Dict[str, Any], phases: Dict[str, float]) -> float:
    timing = record.get("timing") or {}
    duration = timing.get("duration_s")
    if duration is not None:
        return float(duration)
    return sum(phases.values())


# -- the ordered rule table ---------------------------------------------------
# Each rule: (record, phases, dominant, e2e, ctx) -> Optional[verdict
# fragment]. Order is the documented evaluation order; ranking then
# sorts by confidence (stable, so table order breaks ties).

def _rule_fault_injection(record, phases, dominant, e2e, ctx):
    fired = ctx.get("faults") or {}
    if not fired:
        return None
    confidence = 0.9 if record.get("status") in ("error", "cancelled") \
        else 0.5
    sites = ", ".join(sorted(fired))
    return {
        "rule": "fault_injection",
        "cause": f"fault injection active: site(s) {sites} fired in this "
                 f"window (chaos plane)",
        "confidence": confidence,
        "evidence": [{"signal": "fault_injected_total",
                      "fired": {site: fired[site]
                                for site in sorted(fired)}}],
    }


def _rule_quarantine(record, phases, dominant, e2e, ctx):
    quarantined = ctx.get("quarantined") or {}
    total = sum(quarantined.values())
    if record.get("status") != "error" or total <= 0:
        return None
    return {
        "rule": "quarantine",
        "cause": "request finished in error while the engine was "
                 "quarantining poison output (non-finite logits or "
                 "out-of-range tokens)",
        "confidence": 0.85,
        "evidence": [{"signal": "quarantine_total", "total": total,
                      "by_reason": {k: quarantined[k]
                                    for k in sorted(quarantined)}}],
    }


def _rule_compile_stall(record, phases, dominant, e2e, ctx):
    compiles = ctx.get("serving_compiles_60s") or 0.0
    if compiles <= 0:
        return None
    confidence = 0.8 if dominant in ("prefill", "queue.wait") else 0.4
    evidence: List[Dict[str, Any]] = [
        {"signal": "serving_compiles", "count_60s": compiles}]
    recent = ctx.get("recent_compiles") or []
    if recent:
        evidence.append({"field": "recent_compiles", "events": recent})
    return {
        "rule": "compile_stall",
        "cause": f"serve-time compile stall: {compiles:.0f} compile(s) in "
                 f"the last 60s held the model lock while this request "
                 f"waited",
        "confidence": confidence,
        "evidence": evidence,
    }


def _rule_admission_backlog(record, phases, dominant, e2e, ctx):
    if dominant != "queue.wait":
        return None
    depth = ctx.get("queue_depth")
    if depth is None:
        return None
    confidence = 0.85 if depth > 0 else 0.45
    evidence: List[Dict[str, Any]] = [
        {"signal": "queue_depth", "depth": depth},
        {"field": "queue_wait_s", "seconds": phases["queue.wait"]}]
    per_class = ctx.get("admission_depths") or {}
    if per_class:
        evidence.append({"field": "admission_depths",
                         "depths": {k: per_class[k]
                                    for k in sorted(per_class)}})
    return {
        "rule": "admission_backlog",
        "cause": f"admission backlog: queue.wait "
                 f"{phases['queue.wait']:.3f}s dominates e2e with "
                 f"admission depth {depth} — the request sat behind "
                 f"other admissions, not behind the device",
        "confidence": confidence,
        "evidence": evidence,
    }


def _rule_brownout(record, phases, dominant, e2e, ctx):
    level = ctx.get("brownout_level") or 0
    if level <= 0:
        return None
    return {
        "rule": "brownout",
        "cause": f"brownout level {level} in force: the replica is "
                 f"shedding batch-class load and capping speculation "
                 f"under sustained pressure",
        "confidence": 0.6,
        "evidence": [{"signal": "brownout_level", "level": level}],
    }


def _rule_kv_transfer(record, phases, dominant, e2e, ctx):
    kv = phases["kv_transfer"]
    if kv <= 0 or e2e <= 0 or kv < 0.2 * e2e:
        return None
    return {
        "rule": "kv_transfer",
        "cause": f"disaggregated KV handoff cost: {kv:.3f}s of wire "
                 f"transfer ({record.get('kv_transfer_bytes') or 0} "
                 f"bytes) is a large share of e2e",
        "confidence": 0.7 if dominant == "kv_transfer" else 0.5,
        "evidence": [{"field": "kv_transfer_s", "seconds": kv,
                      "bytes": record.get("kv_transfer_bytes") or 0}],
    }


def _rule_cold_prefill(record, phases, dominant, e2e, ctx):
    if dominant != "prefill":
        return None
    prompt_len = record.get("prompt_len") or 0
    if record.get("cached_prefix_len") or prompt_len <= 0:
        return None
    return {
        "rule": "cold_prefill",
        "cause": f"cold prefill: no prefix-cache hit for the "
                 f"{prompt_len}-token prompt, full prefill on the "
                 f"critical path",
        "confidence": 0.5,
        "evidence": [{"field": "cached_prefix_len", "cached": 0,
                      "prompt_len": prompt_len}],
    }


def _rule_anomalies(record, phases, dominant, e2e, ctx):
    active = ctx.get("anomalies") or {}
    if not active:
        return None
    names = sorted(active)
    return {
        "rule": "telemetry_anomaly",
        "cause": f"telemetry anomalies active in the window: "
                 f"{', '.join(names)}",
        "confidence": 0.45,
        "evidence": [dict(active[name], signal=name) for name in names],
    }


def _rule_long_decode(record, phases, dominant, e2e, ctx):
    if dominant != "decode":
        return None
    tokens = record.get("tokens") or 0
    rate = record.get("tokens_per_s")
    rate_text = f" at {rate:.1f} tok/s" if rate else ""
    return {
        "rule": "long_decode",
        "cause": f"long decode: {tokens} generated tokens{rate_text} — "
                 f"latency is proportional to requested output, not to "
                 f"a serving-stack stall",
        "confidence": 0.4,
        "evidence": [{"field": "tokens", "tokens": tokens,
                      "tokens_per_s": rate}],
    }


def _rule_within_profile(record, phases, dominant, e2e, ctx):
    return {
        "rule": "within_profile",
        "cause": "within profile: no window context implicates an "
                 "external cause beyond the phase split itself",
        "confidence": 0.1,
        "evidence": [{"field": "phase_s", "phases": dict(phases)}],
    }


RULES = (
    _rule_fault_injection,
    _rule_quarantine,
    _rule_compile_stall,
    _rule_admission_backlog,
    _rule_brownout,
    _rule_kv_transfer,
    _rule_cold_prefill,
    _rule_anomalies,
    _rule_long_decode,
    _rule_within_profile,
)


def diagnose(record: Dict[str, Any],
             ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Run the rule table over one flight-record dict and one window
    context; returns the ranked verdict list. Pure and deterministic:
    same record + same context ⇒ byte-identical output (the property
    the determinism tests serialize and compare)."""
    phases = _phases_of(record)
    dominant = _dominant(phases)
    e2e = _e2e(record, phases)
    verdicts: List[Dict[str, Any]] = []
    for rule in RULES:
        fragment = rule(record, phases, dominant, e2e, ctx)
        if fragment is None:
            continue
        fragment["dominant_phase"] = dominant
        fragment["phase_s"] = dict(phases)
        fragment["e2e_s"] = round(e2e, 6)
        verdicts.append(fragment)
    verdicts.sort(key=lambda v: -v["confidence"])   # stable: table order
    for rank, verdict in enumerate(verdicts, start=1):
        verdict["rank"] = rank
    return verdicts


def build_window_context(*, engine: Any = None, store: Any = None,
                         ledger: Any = None, xledger: Any = None,
                         now: Optional[float] = None) -> Dict[str, Any]:
    """Snapshot everything stamped in the current time window that the
    rule table joins against: timeseries anomalies, serve-time compiles
    and executable-family charges, fault injections, brownout level,
    quarantines, admission depth. Every source is optional and failure
    -isolated — a broken provider drops its keys, never the diagnosis."""
    from gofr_tpu_torch.tpu import faults

    ctx: Dict[str, Any] = {}
    try:
        fired = faults.active().fired()
        if fired:
            ctx["faults"] = dict(fired)
    except Exception:
        pass
    if store is not None:
        try:
            active = store.anomalies().get("active") or {}
            if active:
                ctx["anomalies"] = {name: dict(entry)
                                    for name, entry in active.items()}
        except Exception:
            pass
    if ledger is not None:
        try:
            ctx["serving_compiles_60s"] = float(
                ledger.serving_compiles(60.0, now))
            recent = (ledger.snapshot(limit=8, now=now) or {}).get("recent")
            if recent:
                ctx["recent_compiles"] = [
                    {"model": e.get("model"), "bucket": e.get("bucket"),
                     "cause": e.get("cause"),
                     "duration_s": e.get("duration_s")}
                    for e in recent]
        except Exception:
            pass
    if xledger is not None:
        try:
            top = (xledger.snapshot(limit=3) or {}).get("top") or []
            if top:
                ctx["executable_top"] = [
                    {"family": row.get("family"), "model": row.get("model"),
                     "share": row.get("share")} for row in top]
        except Exception:
            pass
    if engine is not None:
        try:
            stats = engine.stats()
            ctx["queue_depth"] = stats.get("queue_depth", 0)
            depths = (stats.get("classes") or {}).get("depths") or {}
            if depths:
                ctx["admission_depths"] = dict(depths)
            resilience = stats.get("resilience") or {}
            ctx["brownout_level"] = resilience.get("brownout_level", 0)
            quarantined = resilience.get("quarantined") or {}
            if quarantined:
                ctx["quarantined"] = dict(quarantined)
        except Exception:
            pass
    return ctx


class WorstOffenders:
    """Bounded worst-offender ring: top-K requests by e2e latency per
    rotating window, with the diagnosis attached at finish time (the
    window context a slow request ran under is gone minutes later — a
    verdict computed on demand next week would join against the wrong
    world).

    Bounded by construction: a ``deque(maxlen=keep_windows)`` of
    windows, each window's entry list trimmed to ``k`` on insert —
    memory ceiling is ``keep_windows * k`` entries regardless of
    traffic."""

    def __init__(self, k: int = 8, window_s: float = 300.0,
                 keep_windows: int = 3,
                 context_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 logger: Any = None):
        self.k = max(1, int(k))
        self.window_s = max(1.0, float(window_s))
        self.context_fn = context_fn
        self.logger = logger
        self._windows: deque = deque(maxlen=max(1, int(keep_windows)))
        self._offered = 0
        self._diagnosed = 0

    def _record_dict(self, record: Any) -> Dict[str, Any]:
        d = record.to_dict()
        end = record.finished_at if record.finished_at is not None \
            else time.monotonic()
        d["timing"] = {
            "enqueued_at": record.enqueued_at,
            "admitted_at": record.admitted_at,
            "first_token_at": record.first_token_at,
            "finished_at": record.finished_at,
            "duration_s": round(end - record.enqueued_at, 6),
        }
        return d

    def offer(self, record: Any, now: Optional[float] = None) -> None:
        """Consider one finished :class:`RequestRecord`. Called from
        ``FlightRecorder.finish`` — must stay cheap for the common case
        (request not in the top-K: one comparison) and must never raise
        into the serving path."""
        if record.finished_at is None:
            return
        self._offered += 1
        e2e = record.finished_at - record.enqueued_at
        now = record.finished_at if now is None else now
        start = int(now // self.window_s) * self.window_s
        window = self._windows[-1] if self._windows else None
        if window is None or window["start"] != start:
            window = {"start": start, "entries": []}
            self._windows.append(window)
        entries = window["entries"]
        if len(entries) >= self.k and e2e <= entries[-1]["e2e_s"]:
            return
        try:
            ctx = self.context_fn() if self.context_fn is not None else {}
            record_dict = self._record_dict(record)
            verdicts = diagnose(record_dict, ctx)
        except Exception as exc:
            if self.logger is not None:
                self.logger.error("whyz: diagnosis failed: %r", exc)
            return
        self._diagnosed += 1
        entries.append({
            "trace_id": record.trace_id,
            "model": record.model,
            "status": record.status,
            "e2e_s": round(e2e, 6),
            "record": record_dict,
            "verdicts": verdicts,
        })
        entries.sort(key=lambda e: -e["e2e_s"])
        del entries[self.k:]

    def worst(self) -> Optional[Dict[str, Any]]:
        """The single worst entry across the kept windows (newest
        window wins ties)."""
        best: Optional[Dict[str, Any]] = None
        for window in self._windows:
            for entry in window["entries"]:
                if best is None or entry["e2e_s"] > best["e2e_s"]:
                    best = entry
        return best

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        windows = []
        for window in reversed(self._windows):   # newest first
            entries = window["entries"]
            if limit is not None:
                entries = entries[:int(limit)]
            windows.append({
                "start": window["start"],
                "entries": [
                    {"trace_id": e["trace_id"], "model": e["model"],
                     "status": e["status"], "e2e_s": e["e2e_s"],
                     "top_verdict": (e["verdicts"][0]["cause"]
                                     if e["verdicts"] else None),
                     "dominant_phase": (e["verdicts"][0]["dominant_phase"]
                                        if e["verdicts"] else None)}
                    for e in entries],
            })
        return {
            "k": self.k,
            "window_s": self.window_s,
            "keep_windows": self._windows.maxlen,
            "offered": self._offered,
            "diagnosed": self._diagnosed,
            "windows": windows,
        }

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full ring entry (record + verdicts) for one trace id, newest
        window first."""
        for window in reversed(self._windows):
            for entry in window["entries"]:
                if entry["trace_id"] == trace_id:
                    return entry
        return None


def new_offenders(config: Any,
                  context_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                  logger: Any = None) -> Optional[WorstOffenders]:
    """Config-driven factory (``WHYZ_ENABLED``, default on).
    ``WHYZ_TOPK`` (default 8) and ``WHYZ_WINDOW_S`` (default 300) size
    the ring; ``WHYZ_KEEP_WINDOWS`` (default 3) how many rotated
    windows stay inspectable."""
    if not config.get_bool("WHYZ_ENABLED", True):
        return None
    return WorstOffenders(
        k=int(config.get_float("WHYZ_TOPK", 8)),
        window_s=config.get_float("WHYZ_WINDOW_S", 300.0),
        keep_windows=int(config.get_float("WHYZ_KEEP_WINDOWS", 3)),
        context_fn=context_fn, logger=logger)

"""SLO accounting (a copy of ``gofr_tpu/slo.py`` with a contextvar of the
port's own): request deadlines, goodput against raw throughput, and the
controllers that act on them.

- A request may carry an ``X-Request-Deadline-Ms`` header (milliseconds
  of budget from ingress). The handler converts it to an absolute
  monotonic instant with :func:`set_request_deadline`, which stashes it
  in a contextvar; the contextvar survives into async handlers and
  ``asyncio.to_thread``, so the generation engine reads it at submit time
  (:func:`current_deadline`) without a parameter in user code. The engine
  derives the request's admission class from it
  (``tpu/sched.deadline_class``) and sheds a request whose deadline
  passed while it waited in the queue, before its prefill, with
  :class:`DeadlineExceeded`. The JAX package's app sets *its* contextvar
  (``gofr_tpu.slo``); the port reads only this one, so an app that
  serves the torch engine sets this one too.
- Each completion is classified ``ok | violated | expired | error``.
  :class:`SLOTracker` keeps windowed views (1m/5m) of TTFT quantiles,
  outcome counts, raw and goodput tokens/s, and mirrors each event into
  the metrics it is given (``app_tpu_slo_total{outcome}`` ...).
- :class:`Watchdog` evaluates the rolling windows and flips replica
  health READY -> DEGRADED with hysteresis; :class:`BrownoutLadder`,
  fed by every evaluation, climbs and descends the engine's brownout
  levels (``GenerationEngine.set_brownout``).

One rule differs from the JAX package's controllers: a seam that fails
(``hbm_fn``, ``anomaly_fn``, ``budget_fn``, the escalation gate,
``apply_fn``) raises out of the evaluation instead of being logged and
skipped, and a timer evaluation that raises ends the timer, which
``Watchdog.stop`` re-raises. What they decide when nothing fails is the
JAX package's.
"""

from __future__ import annotations

import asyncio
import contextvars
import time
from typing import Any, Dict, Optional

from gofr_tpu_torch.metrics.digest import WindowedCounter, WindowedDigest
from gofr_tpu_torch.trace.tracer import current_span

__all__ = ["DeadlineExceeded", "set_request_deadline", "current_deadline",
           "parse_deadline_header", "SLOTracker", "Watchdog",
           "BrownoutLadder", "new_brownout", "new_watchdog",
           "TERMINAL_OUTCOMES", "STATE_READY", "STATE_DEGRADED"]

OUTCOME_OK = "ok"
OUTCOME_VIOLATED = "violated"
OUTCOME_EXPIRED = "expired"
# the request failed outright (device step raised) — it never produced a
# deadline-classifiable completion, but dropping it from the accounting
# would overstate attainment exactly when the replica is sickest
OUTCOME_ERROR = "error"

TERMINAL_OUTCOMES = (OUTCOME_OK, OUTCOME_VIOLATED, OUTCOME_EXPIRED,
                     OUTCOME_ERROR)


class DeadlineExceeded(Exception):
    """Raised to the caller when a request is shed because its deadline
    had already passed before any device work started. The HTTP
    responder duck-types ``status_code``, mapping this to 503 without the
    engine importing HTTP code."""

    status_code = 503

    def __init__(self,
                 message: str = "request deadline exceeded before execution"):
        super().__init__(message)


_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "gofr_tpu_torch_deadline", default=None)


def set_request_deadline(budget_ms: Optional[float],
                         now: Optional[float] = None) -> Optional[float]:
    """Convert a relative millisecond budget into an absolute monotonic
    deadline and make it current. Returns the absolute deadline (or None
    for no/invalid budget)."""
    if budget_ms is None or budget_ms <= 0:
        _deadline.set(None)
        return None
    now = time.monotonic() if now is None else now
    deadline = now + budget_ms / 1000.0
    _deadline.set(deadline)
    return deadline


def current_deadline() -> Optional[float]:
    """Absolute monotonic deadline of the current request, or None."""
    return _deadline.get()


def parse_deadline_header(raw: str) -> Optional[float]:
    """``X-Request-Deadline-Ms`` value -> float ms, None when absent or
    malformed (a bad header must never fail the request)."""
    if not raw:
        return None
    try:
        budget = float(raw)
    except (TypeError, ValueError):
        return None
    return budget if budget > 0 else None


class SLOTracker:
    """Windowed goodput/latency accounting shared by the batcher, the
    generation engine, and the admin surfaces (/debug/varz, statusz)."""

    def __init__(self, metrics: Any = None, slice_s: float = 5.0,
                 max_window_s: float = 300.0):
        self.metrics = metrics
        self._slice_s = slice_s
        self._max_window_s = max_window_s
        self.ttft = WindowedDigest(alpha=0.01, slice_s=slice_s,
                                   max_window_s=max_window_s)
        self.tokens = WindowedCounter(slice_s, max_window_s)
        self.goodput_tokens = WindowedCounter(slice_s, max_window_s)
        self.outcomes: Dict[str, WindowedCounter] = {
            name: WindowedCounter(slice_s, max_window_s)
            for name in TERMINAL_OUTCOMES
        }
        # per-SLO-class views, built lazily on first labelled event so a
        # single-tenant deployment pays nothing for the multi-class path
        self.class_outcomes: Dict[tuple, WindowedCounter] = {}
        self.class_goodput: Dict[str, WindowedCounter] = {}

    # -- event feeds --------------------------------------------------------
    def record_ttft(self, seconds: float, now: Optional[float] = None) -> None:
        self.ttft.record(seconds, now=now)

    def record_tokens(self, n: float, now: Optional[float] = None) -> None:
        """Raw generated tokens, counted as they are produced."""
        if n > 0:
            self.tokens.add(n, now=now)

    def classify(self, deadline: Optional[float], finished_at: Optional[float] = None) -> str:
        finished_at = time.monotonic() if finished_at is None else finished_at
        if deadline is None:
            return OUTCOME_OK
        return OUTCOME_OK if finished_at <= deadline else OUTCOME_VIOLATED

    def record_outcome(self, outcome: str, tokens: float = 0.0,
                       now: Optional[float] = None,
                       cls: Optional[str] = None,
                       model: Optional[str] = None,
                       trace_id: Optional[str] = None,
                       late_by_s: Optional[float] = None) -> None:
        """One request reached a terminal state. ``tokens`` is the
        request's total generated tokens; only ``ok`` completions count
        toward goodput. ``cls`` (SLO class from ``tpu.sched``) adds the
        event to the per-class views used by weighted-fair scheduling
        dashboards — omitted, the event stays aggregate-only. ``model``
        plus ``cls`` additionally mirror the event into the labelled
        ``app_tpu_slo_total{model,cls,outcome}`` series the error-budget
        burn-rate plane differences; the bare ``{outcome}``
        series stays the all-up aggregate including unlabelled callers.
        For ``violated`` outcomes ``late_by_s`` (seconds past deadline)
        lands in ``app_tpu_deadline_violation_seconds`` with ``trace_id``
        as its OpenMetrics exemplar, so a burn-rate alert links straight
        to one concrete slow request in /debug/whyz."""
        counter = self.outcomes.get(outcome)
        if counter is None:
            return
        counter.add(1.0, now=now)
        if outcome == OUTCOME_OK and tokens > 0:
            self.goodput_tokens.add(tokens, now=now)
        if cls is not None:
            key = (cls, outcome)
            per_class = self.class_outcomes.get(key)
            if per_class is None:
                per_class = self.class_outcomes[key] = WindowedCounter(
                    self._slice_s, self._max_window_s)
            per_class.add(1.0, now=now)
            if outcome == OUTCOME_OK and tokens > 0:
                goodput = self.class_goodput.get(cls)
                if goodput is None:
                    goodput = self.class_goodput[cls] = WindowedCounter(
                        self._slice_s, self._max_window_s)
                goodput.add(tokens, now=now)
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_slo_total", outcome=outcome)
            if model is not None or cls is not None:
                self.metrics.increment_counter(
                    "app_tpu_slo_total", outcome=outcome,
                    model=model or "", cls=cls or "")
            if outcome == OUTCOME_VIOLATED and late_by_s is not None:
                self.metrics.record_histogram(
                    "app_tpu_deadline_violation_seconds", max(0.0, late_by_s),
                    exemplar=({"trace_id": trace_id} if trace_id else None),
                    model=model or "", cls=cls or "")

    # -- derived views ------------------------------------------------------
    def attainment(self, window_s: float = 60.0,
                   now: Optional[float] = None) -> Optional[float]:
        """Fraction of terminal requests in the window that were ``ok``;
        None when the window is empty (no data is not bad data)."""
        now = time.monotonic() if now is None else now
        ok = self.outcomes[OUTCOME_OK].sum(window_s, now)
        bad = sum(self.outcomes[name].sum(window_s, now)
                  for name in TERMINAL_OUTCOMES if name != OUTCOME_OK)
        total = ok + bad
        if total <= 0:
            return None
        return ok / total

    def export_gauges(self, window_s: float = 60.0,
                      now: Optional[float] = None) -> None:
        """Refresh the windowed-rate gauges in the Prometheus catalog;
        called on each /metrics scrape (system_metrics_refresh idiom) so
        the exposed rates always describe the last window, not process
        lifetime averages."""
        if self.metrics is None:
            return
        now = time.monotonic() if now is None else now
        self.metrics.set_gauge("app_tpu_tokens_per_s",
                               self.tokens.rate(window_s, now))
        self.metrics.set_gauge("app_tpu_goodput_tokens_per_s",
                               self.goodput_tokens.rate(window_s, now))
        attainment = self.attainment(window_s, now)
        if attainment is not None:
            self.metrics.set_gauge("app_tpu_slo_attainment", attainment)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        out: Dict[str, Any] = {"ttft_s": self.ttft.snapshot(now=now)}
        for window in (60.0, 300.0):
            key = f"{int(window)}s"
            attainment = self.attainment(window, now)
            out[key] = {
                "tokens_per_s": round(self.tokens.rate(window, now), 3),
                "goodput_tokens_per_s": round(
                    self.goodput_tokens.rate(window, now), 3),
                "slo_attainment": (round(attainment, 4)
                                   if attainment is not None else None),
                "outcomes": {
                    name: self.outcomes[name].sum(window, now)
                    for name in TERMINAL_OUTCOMES
                },
            }
        out["lifetime"] = {
            "tokens_total": self.tokens.total(),
            "goodput_tokens_total": self.goodput_tokens.total(),
        }
        if self.class_outcomes or self.class_goodput:
            classes: Dict[str, Any] = {}
            for (cls, outcome), counter in sorted(self.class_outcomes.items()):
                entry = classes.setdefault(cls, {"outcomes_60s": {}})
                entry["outcomes_60s"][outcome] = counter.sum(60.0, now)
            for cls, counter in self.class_goodput.items():
                entry = classes.setdefault(cls, {"outcomes_60s": {}})
                entry["goodput_tokens_per_s_60s"] = round(
                    counter.rate(60.0, now), 3)
            out["classes"] = classes
        return out


STATE_READY = "READY"
STATE_DEGRADED = "DEGRADED"


class Watchdog:
    """Background evaluator that drains a sick replica.

    Every ``interval_s`` it inspects the rolling window; after
    ``hysteresis`` *consecutive* bad evaluations it flips DEGRADED (and
    back after the same number of good ones), so a single slow scrape or
    one recovered window never flaps the load balancer. Windows with
    fewer than ``min_requests`` terminal requests are treated as healthy
    — an idle replica is not a sick replica."""

    def __init__(self, slo: SLOTracker, metrics: Any = None,
                 logger: Any = None, *, min_attainment: float = 0.9,
                 max_p99_ttft_s: Optional[float] = None,
                 window_s: float = 60.0, interval_s: float = 5.0,
                 hysteresis: int = 3, min_requests: int = 1,
                 ledger: Any = None,
                 max_serving_compiles: Optional[int] = None,
                 role: str = "both",
                 hbm_fn: Any = None,
                 max_hbm_occupancy: Optional[float] = None,
                 brownout: Any = None,
                 anomaly_fn: Any = None,
                 budget_fn: Any = None):
        self.slo = slo
        self.metrics = metrics
        self.logger = logger
        # disaggregated serving: the replica role this watchdog
        # guards. Labels the health-transition counter and statusz so a
        # fleet dashboard can tell a sick prefill tier from a sick decode
        # tier — their remedies differ (add compute vs add HBM).
        self.role = role
        self.min_attainment = min_attainment
        self.max_p99_ttft_s = max_p99_ttft_s
        # recompile-storm signal: a CompileLedger (or anything
        # duck-typing serving_compiles(window_s, now)) plus a per-window
        # ceiling on serve-time compiles. Each one stalls every request
        # for its model behind the compile lock, so a burst degrades the
        # replica as surely as an attainment collapse — and shows up here
        # minutes before the latency windows catch up.
        self.ledger = ledger
        self.max_serving_compiles = max_serving_compiles
        # HBM-pressure signal: ``hbm_fn`` returns the current
        # occupancy fraction (or None while the signal is unavailable —
        # NOT pressure). /debug/hbmz wires it; a replica pinned above
        # ``max_hbm_occupancy`` degrades before the allocator OOMs.
        self.hbm_fn = hbm_fn
        self.max_hbm_occupancy = max_hbm_occupancy
        # brownout ladder (BrownoutLadder): graduated load-shedding fed
        # by every evaluation, so the replica degrades in steps (shed
        # batch → cap spec γ → spec off) BEFORE the hysteresis-gated
        # DEGRADED flip pulls it from the load balancer entirely
        self.brownout = brownout
        # telemetry anomaly signal: ``anomaly_fn`` returns a
        # list of reason strings for active change-point anomalies on
        # watch-listed signals (TimeSeriesStore.watchdog_reasons). Like
        # the recompile/HBM signals it is independent of min_requests —
        # a goodput cliff detected against the replica's own baseline
        # names the offending signal right here in statusz.
        self.anomaly_fn = anomaly_fn
        # error-budget burn signal: ``budget_fn`` returns a
        # list of reason strings for (model, cls) error budgets whose
        # multi-window burn rates are simultaneously above threshold
        # (ErrorBudgetPlane.watchdog_reasons). The reason names the
        # burning class and window pair, so DEGRADED in statusz reads as
        # a budget verdict, not a bare threshold crossing.
        self.budget_fn = budget_fn
        self.window_s = window_s
        self.interval_s = interval_s
        self.hysteresis = max(1, int(hysteresis))
        self.min_requests = max(0, int(min_requests))
        self.state = STATE_READY
        self.transitions = 0
        self._bad_streak = 0
        self._good_streak = 0
        self._last_reasons: list = []
        self._task: Optional[asyncio.Task] = None

    # -- one evaluation (synchronous: unit-testable without a loop) ---------
    def evaluate(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        reasons = []
        terminal = sum(self.slo.outcomes[name].sum(self.window_s, now)
                       for name in TERMINAL_OUTCOMES)
        if terminal >= max(self.min_requests, 1):
            attainment = self.slo.attainment(self.window_s, now)
            if attainment is not None and attainment < self.min_attainment:
                reasons.append(
                    f"slo_attainment {attainment:.3f} < {self.min_attainment}")
        if self.max_p99_ttft_s is not None:
            p99 = self.slo.ttft.quantile(0.99, self.window_s, now)
            if p99 is not None and p99 > self.max_p99_ttft_s:
                reasons.append(f"p99_ttft {p99:.3f}s > {self.max_p99_ttft_s}s")
        # recompile storm: independent of min_requests — the compiles
        # themselves prove the replica is doing (the wrong kind of) work
        if self.ledger is not None and self.max_serving_compiles is not None:
            compiles = self.ledger.serving_compiles(self.window_s, now)
            if compiles > self.max_serving_compiles:
                reasons.append(
                    f"recompile storm: {compiles:.0f} serve-time compiles "
                    f"in {self.window_s:.0f}s > {self.max_serving_compiles}")
        # HBM pressure: like the recompile storm, independent of
        # min_requests — a pool pinned full by abandoned or migrated
        # pages is sick even when no requests terminate in the window
        if self.hbm_fn is not None and self.max_hbm_occupancy is not None:
            occupancy = self.hbm_fn()
            if occupancy is not None and occupancy > self.max_hbm_occupancy:
                reasons.append(
                    f"hbm occupancy {occupancy:.3f} > "
                    f"{self.max_hbm_occupancy}")
        # telemetry anomalies: the change-point detector already applied
        # its own hysteresis, so every active watch-listed anomaly is a
        # sustained regime change, not a noisy sample
        if self.anomaly_fn is not None:
            reasons.extend(self.anomaly_fn())
        # error-budget burn: like the anomaly feed, the plane applied
        # its own multi-window gating (short AND long window burning),
        # so every reason here is a sustained budget drain
        if self.budget_fn is not None:
            reasons.extend(self.budget_fn())
        self._last_reasons = reasons
        if self.brownout is not None:
            self.brownout.observe(bool(reasons))
        if reasons:
            self._bad_streak += 1
            self._good_streak = 0
        else:
            self._good_streak += 1
            self._bad_streak = 0
        if (self.state == STATE_READY
                and self._bad_streak >= self.hysteresis):
            self._transition(STATE_DEGRADED, reasons)
        elif (self.state == STATE_DEGRADED
                and self._good_streak >= self.hysteresis):
            self._transition(STATE_READY, reasons)
        return self.state

    def _transition(self, state: str, reasons: list) -> None:
        previous, self.state = self.state, state
        self.transitions += 1
        self._bad_streak = 0
        self._good_streak = 0
        if self.metrics is not None:
            self.metrics.increment_counter("app_health_transitions_total",
                                           to=state, role=self.role)
        if self.logger is not None:
            if state == STATE_DEGRADED:
                self.logger.warn("watchdog: %s -> %s (%s)", previous, state,
                                 "; ".join(reasons) or "thresholds crossed")
            else:
                self.logger.info("watchdog: %s -> %s (recovered)",
                                 previous, state)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Evaluate every ``interval_s`` on the running loop. An
        evaluation that raises ends the timer; :meth:`stop` raises it."""
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.evaluate()

    async def stop(self) -> None:
        if self._task is not None:
            task, self._task = self._task, None
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    def statusz(self) -> Dict[str, Any]:
        out = {
            "state": self.state,
            "role": self.role,
            "transitions": self.transitions,
            "bad_streak": self._bad_streak,
            "good_streak": self._good_streak,
            "last_reasons": list(self._last_reasons),
            "thresholds": {
                "min_attainment": self.min_attainment,
                "max_p99_ttft_s": self.max_p99_ttft_s,
                "max_serving_compiles": self.max_serving_compiles,
                "max_hbm_occupancy": self.max_hbm_occupancy,
                "window_s": self.window_s,
                "hysteresis": self.hysteresis,
                "min_requests": self.min_requests,
            },
        }
        if self.brownout is not None:
            out["brownout"] = self.brownout.statusz()
        return out


class BrownoutLadder:
    """Graduated degradation between "healthy" and the watchdog's full
    DEGRADED shed.

    The watchdog feeds every evaluation in (``observe(pressure)``).
    Sustained pressure climbs one rung per ``escalate_after``
    consecutive bad evaluations; sustained calm descends one rung per
    ``recover_after`` consecutive good ones — recovery is deliberately
    slower than escalation so a marginal replica does not oscillate.
    Rungs (enforced by the engine via ``apply_fn`` = ``set_brownout``;
    admission classes from :func:`gofr_tpu_torch.tpu.sched.brownout_shed_classes`):

    - level 1 — shed ``batch``-class admissions.
    - level 2 — also cap speculative-decode γ at 1.
    - level 3 — also disable speculative decode outright.

    All of it happens while the watchdog is still READY — the ladder
    exists so the replica gives up throughput before it gives up its
    place in the load balancer."""

    MAX_LEVEL = 3

    def __init__(self, apply_fn: Any = None, metrics: Any = None,
                 logger: Any = None, *, escalate_after: int = 2,
                 recover_after: int = 4, role: str = "both"):
        self.apply_fn = apply_fn
        self.metrics = metrics
        self.logger = logger
        self.role = role
        self.escalate_after = max(1, int(escalate_after))
        self.recover_after = max(1, int(recover_after))
        # error-budget escalation gate: when set, climbing a
        # rung additionally requires the gate to answer True — the app
        # wires ErrorBudgetPlane.fast_burning here, so shedding only
        # tightens while a fast burn window is actually draining budget
        # (pressure without burn holds the current rung instead of
        # ratcheting). Descent is never gated: recovery must not depend
        # on the budget plane being healthy.
        self.escalation_gate: Any = None
        self.level = 0
        self.transitions = 0
        self._pressed = 0
        self._calm = 0
        self._gate_held = 0

    def _escalation_allowed(self) -> bool:
        if self.escalation_gate is None:
            return True
        return bool(self.escalation_gate())

    def observe(self, pressure: bool) -> int:
        """Feed one watchdog evaluation; returns the (possibly new)
        brownout level."""
        if pressure:
            self._pressed += 1
            self._calm = 0
            if (self._pressed >= self.escalate_after
                    and self.level < self.MAX_LEVEL):
                if self._escalation_allowed():
                    self._pressed = 0
                    self._set(self.level + 1)
                else:
                    # hold the rung; keep _pressed so the next clear
                    # gate answer escalates without re-accumulating
                    self._gate_held += 1
        else:
            self._calm += 1
            self._pressed = 0
            if self._calm >= self.recover_after and self.level > 0:
                self._calm = 0
                self._set(self.level - 1)
        return self.level

    def _set(self, level: int) -> None:
        previous, self.level = self.level, level
        self.transitions += 1
        # chaos-plane trace visibility: when a transition
        # happens under an active span (e.g. a watchdog evaluation
        # traced by a test, or a request that tripped the ladder), the
        # level change is stamped on it
        span = current_span()
        if span is not None:
            span.add_event("brownout.level", previous=previous,
                           level=level, role=self.role)
        if self.apply_fn is not None:
            self.apply_fn(level)
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_brownout_level", float(level),
                                   role=self.role)
        if self.logger is not None:
            log = self.logger.warn if level > previous else self.logger.info
            log("brownout: level %d -> %d", previous, level)

    def statusz(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "transitions": self.transitions,
            "pressed": self._pressed,
            "calm": self._calm,
            "escalate_after": self.escalate_after,
            "recover_after": self.recover_after,
            "gated": self.escalation_gate is not None,
            "gate_held": self._gate_held,
        }


def new_brownout(config: Any, engine: Any, metrics: Any = None,
                 logger: Any = None) -> Optional[BrownoutLadder]:
    """Config-driven factory (``BROWNOUT_ENABLED``, default on when the
    engine can enforce levels). Returns None when disabled or when
    ``engine`` lacks ``set_brownout`` — a ladder nobody enforces is
    noise."""
    apply_fn = getattr(engine, "set_brownout", None)
    if apply_fn is None:
        return None
    if not config.get_bool("BROWNOUT_ENABLED", True):
        return None
    return BrownoutLadder(
        apply_fn, metrics=metrics, logger=logger,
        role=config.get_or_default("CLUSTER_ROLE", "both"),
        escalate_after=int(config.get_float("BROWNOUT_ESCALATE_AFTER", 2)),
        recover_after=int(config.get_float("BROWNOUT_RECOVER_AFTER", 4)))


def new_watchdog(config: Any, slo: SLOTracker, metrics: Any = None,
                 logger: Any = None, ledger: Any = None) -> Optional[Watchdog]:
    """Config-driven factory. Returns None when disabled
    (``SLO_WATCHDOG_ENABLED=false``). ``SLO_MAX_P99_TTFT_MS`` unset means
    the TTFT ceiling check is off; attainment defaults to 0.9. With a
    compile ledger wired, ``SLO_MAX_SERVING_COMPILES`` (default 3, 0
    disables) bounds serve-time compiles per window before the replica
    reports a recompile storm. ``CLUSTER_ROLE`` labels the watchdog with
    the replica's serving role (disaggregated topologies)."""
    if not config.get_bool("SLO_WATCHDOG_ENABLED", True):
        return None
    max_ttft_ms = config.get_float("SLO_MAX_P99_TTFT_MS", 0.0)
    max_compiles = int(config.get_float("SLO_MAX_SERVING_COMPILES", 3))
    # SLO_MAX_HBM_OCCUPANCY (0 disables): the fraction of device memory
    # (or KV-pool occupancy, whichever hbm_fn reports) the replica may
    # sustain before degrading. The signal source is wired later by
    # enable_hbmz — the threshold alone does nothing without it.
    max_hbm = config.get_float("SLO_MAX_HBM_OCCUPANCY", 0.0)
    return Watchdog(
        slo, metrics=metrics, logger=logger,
        role=config.get_or_default("CLUSTER_ROLE", "both"),
        min_attainment=config.get_float("SLO_MIN_ATTAINMENT", 0.9),
        max_p99_ttft_s=(max_ttft_ms / 1000.0) if max_ttft_ms > 0 else None,
        window_s=config.get_float("SLO_WINDOW_S", 60.0),
        interval_s=config.get_float("SLO_WATCHDOG_INTERVAL_S", 5.0),
        hysteresis=int(config.get_float("SLO_WATCHDOG_HYSTERESIS", 3)),
        min_requests=int(config.get_float("SLO_WATCHDOG_MIN_REQUESTS", 1)),
        ledger=ledger,
        max_serving_compiles=max_compiles if max_compiles > 0 else None,
        max_hbm_occupancy=max_hbm if max_hbm > 0 else None,
    )

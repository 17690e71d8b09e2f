"""Error-budget burn-rate plane: multi-window SLO budget accounting (a
copy of ``gofr_tpu/slo_budget.py``: its windows, pairs, thresholds,
objective overrides and verdicts).

- Per-(model, SLO class) objectives come from ``SLO_OBJECTIVE_PCT``
  (99.0: a 1% error budget), with per-class overrides
  (``SLO_OBJECTIVE_PCT_<CLASS>``). A (model, cls) pair enters the plane
  the first time its labelled ``app_tpu_slo_total{model,cls,outcome}``
  series appears in the metrics (the port's ``SLOTracker`` emits it).
- Budgets come only from differencing that series through the
  :class:`~gofr_tpu_torch.metrics.timeseries.TimeSeriesStore`: one
  provider a pair reads the cumulative counts, and the store's counter
  kind turns them into rates (first sample skipped, resets clamped).
- ``burn(W) = bad_fraction(W) / budget_fraction`` over a fast pair (5m /
  1h, threshold 14.4x) and a slow pair (1h / 4h, 6x); a pair burns only
  when both its windows burn above its threshold.
- Outputs: ``app_tpu_slo_budget_remaining{model,cls}`` and
  ``app_tpu_slo_burn_rate{model,cls,window}``, :meth:`ErrorBudgetPlane.
  watchdog_reasons` (a ``Watchdog``'s ``budget_fn``) and
  :meth:`ErrorBudgetPlane.fast_burning` (a ``BrownoutLadder``'s
  ``escalation_gate``).

Entry points take an optional ``now`` so tests drive the clock.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from gofr_tpu_torch.slo import OUTCOME_OK

__all__ = ["ErrorBudgetPlane", "new_error_budget"]

# the one counter the plane is allowed to read — budgets difference the
# labelled (model, cls, outcome) series of this metric, nothing else
SOURCE_METRIC = "app_tpu_slo_total"

# elementary windows (label, seconds), each sized to fit a store tier:
# 5m inside the 1s x 600 tier, 1h exactly the 10s x 360 tier, 4h exactly
# the 60s x 240 tier
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("5m", 300.0),
    ("1h", 3600.0),
    ("4h", 14400.0),
)
# (pair name, short window, long window): both windows must burn above
# the pair's threshold before the pair counts as burning
PAIRS: Tuple[Tuple[str, str, str], ...] = (
    ("fast", "5m", "1h"),
    ("slow", "1h", "4h"),
)
# the 4h window doubles as the budget accounting period for
# app_tpu_slo_budget_remaining
ACCOUNTING_WINDOW = "4h"


def _slug(value: str) -> str:
    out = re.sub(r"[^A-Za-z0-9_]", "_", value or "")
    return out or "default"


class ErrorBudgetPlane:
    """Multi-window burn-rate evaluation over the labelled SLO counter.

    ``evaluate(now)`` is the one computation path: discover new
    (model, cls) series, read window means from the store, refresh the
    gauges, and cache the verdicts that ``watchdog_reasons`` /
    ``fast_burning`` / ``statusz`` serve. The watchdog calls it every
    ``interval_s`` via ``budget_fn``; /debug/sloz calls it on demand.
    All of it runs on the event loop — no locks needed."""

    # cardinality gate: (model, cls) pairs admitted to the plane; each
    # costs two store signals (<= 2 * MAX_BUCKETS_PER_SIGNAL buckets)
    MAX_PAIRS = 32

    def __init__(self, store: Any, metrics: Any, logger: Any = None, *,
                 objective_pct: float = 99.0,
                 objective_override: Optional[
                     Callable[[str], Optional[float]]] = None,
                 fast_threshold: float = 14.4,
                 slow_threshold: float = 6.0):
        self.store = store
        self.metrics = metrics
        self.logger = logger
        self.objective_pct = float(objective_pct)
        self.objective_override = objective_override
        self.fast_threshold = float(fast_threshold)
        self.slow_threshold = float(slow_threshold)
        # (model, cls) -> {"bad": signal, "total": signal, "objective_pct"}
        self._pairs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._overflowed = False
        self._last: Dict[str, Any] = {"at": None, "budgets": [],
                                      "reasons": []}

    # -- pair discovery ------------------------------------------------------
    def _objective(self, cls: str) -> float:
        if self.objective_override is not None and cls:
            try:
                override = self.objective_override(cls)
            except Exception:
                override = None
            if override is not None and 0.0 < override < 100.0:
                return float(override)
        return self.objective_pct

    def _cumulative(self, model: str, cls: str) -> Dict[str, float]:
        """Cumulative per-outcome counts of one labelled series right
        now — the raw reading the store differences into a rate."""
        metric = self.metrics.snapshot().get(SOURCE_METRIC)
        out: Dict[str, float] = {}
        if metric is None:
            return out
        for key, value in list(metric.series.items()):
            labels = dict(key)
            if "model" not in labels and "cls" not in labels:
                continue   # the unlabelled all-up aggregate series
            if labels.get("model", "") != model or \
                    labels.get("cls", "") != cls:
                continue
            outcome = labels.get("outcome")
            if outcome:
                out[outcome] = out.get(outcome, 0.0) + float(value)
        return out

    def _discover(self) -> None:
        metric = self.metrics.snapshot().get(SOURCE_METRIC)
        if metric is None:
            return
        for key in list(metric.series.keys()):
            labels = dict(key)
            if "model" not in labels and "cls" not in labels:
                continue
            pair = (labels.get("model", ""), labels.get("cls", ""))
            if pair in self._pairs:
                continue
            if len(self._pairs) >= self.MAX_PAIRS:
                if not self._overflowed:
                    self._overflowed = True
                    if self.logger is not None:
                        self.logger.error(
                            "slo_budget: more than %d (model, cls) pairs; "
                            "extra pairs are not budget-tracked",
                            self.MAX_PAIRS)
                return
            self._register_pair(pair)

    def _register_pair(self, pair: Tuple[str, str]) -> None:
        model, cls = pair
        bad_name = f"slo_bad_{_slug(model)}_{_slug(cls)}"
        total_name = f"slo_total_{_slug(model)}_{_slug(cls)}"

        def provider(model: str = model, cls: str = cls,
                     bad_name: str = bad_name,
                     total_name: str = total_name) -> Dict[str, Any]:
            counts = self._cumulative(model, cls)
            if not counts:
                return {}
            total = sum(counts.values())
            bad = total - counts.get(OUTCOME_OK, 0.0)
            return {bad_name: bad, total_name: total}

        self.store.register_provider(
            (bad_name, total_name), provider,
            kinds={bad_name: "counter", total_name: "counter"})
        self._pairs[pair] = {
            "bad": bad_name,
            "total": total_name,
            "objective_pct": self._objective(cls),
        }
        if self.logger is not None:
            self.logger.info(
                "slo_budget: tracking model=%r cls=%r (objective %.3f%%)",
                model or "default", cls or "default",
                self._pairs[pair]["objective_pct"])

    # -- the one computation path -------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        self._discover()
        budgets: List[Dict[str, Any]] = []
        reasons: List[str] = []
        for (model, cls), entry in sorted(self._pairs.items()):
            pct = entry["objective_pct"]
            budget_frac = max(1e-9, 1.0 - pct / 100.0)
            burns: Dict[str, Optional[float]] = {}
            fracs: Dict[str, Optional[float]] = {}
            for wname, wsec in WINDOWS:
                bad = self.store.window_mean(entry["bad"], wsec, now)
                total = self.store.window_mean(entry["total"], wsec, now)
                frac: Optional[float] = None
                if bad is not None and total is not None and total > 0:
                    frac = min(1.0, max(0.0, bad / total))
                fracs[wname] = frac
                burn = None if frac is None else frac / budget_frac
                burns[wname] = burn
                if self.metrics is not None:
                    self.metrics.set_gauge(
                        "app_tpu_slo_burn_rate",
                        burn if burn is not None else 0.0,
                        model=model, cls=cls, window=wname)
            acct = fracs[ACCOUNTING_WINDOW]
            remaining = 1.0 if acct is None else \
                max(0.0, 1.0 - acct / budget_frac)
            if self.metrics is not None:
                self.metrics.set_gauge("app_tpu_slo_budget_remaining",
                                       remaining, model=model, cls=cls)
            burning: List[Dict[str, Any]] = []
            for pair_name, short_w, long_w in PAIRS:
                threshold = self.fast_threshold if pair_name == "fast" \
                    else self.slow_threshold
                burn_short, burn_long = burns[short_w], burns[long_w]
                if burn_short is None or burn_long is None:
                    continue
                if burn_short > threshold and burn_long > threshold:
                    burning.append({
                        "signal": "app_tpu_slo_burn_rate",
                        "window": pair_name,
                        "short": short_w,
                        "long": long_w,
                        "burn_short": round(burn_short, 2),
                        "burn_long": round(burn_long, 2),
                        "threshold": threshold,
                    })
                    reasons.append(
                        f"error budget burn: cls={cls or 'default'} "
                        f"model={model or 'default'} window={pair_name} "
                        f"({short_w} {burn_short:.1f}x / {long_w} "
                        f"{burn_long:.1f}x > {threshold:g}x "
                        f"app_tpu_slo_burn_rate; budget "
                        f"{remaining * 100.0:.1f}% left)")
            budgets.append({
                "model": model,
                "cls": cls,
                "objective_pct": pct,
                "budget_fraction": round(budget_frac, 6),
                "bad_fraction": {
                    w: (round(f, 6) if f is not None else None)
                    for w, f in fracs.items()},
                "burn": {
                    w: (round(b, 3) if b is not None else None)
                    for w, b in burns.items()},
                "budget_remaining": round(remaining, 4),
                "burning": burning,
            })
        self._last = {"at": now, "budgets": budgets, "reasons": reasons}
        return self._last

    # -- feeds ---------------------------------------------------------------
    def watchdog_reasons(self) -> List[str]:
        """The ``Watchdog.budget_fn`` feed: one reason string per
        burning (model, cls, window pair), freshly evaluated."""
        return list(self.evaluate()["reasons"])

    def fast_burning(self) -> bool:
        """The BrownoutLadder escalation gate: True while any pair's
        *fast* window pair is burning, per the cached evaluation (the
        watchdog evaluates ``budget_fn`` immediately before feeding the
        ladder, so the cache is at most one evaluation old)."""
        return any(b["window"] == "fast"
                   for entry in self._last["budgets"]
                   for b in entry["burning"])

    # -- views ---------------------------------------------------------------
    def statusz(self, now: Optional[float] = None) -> Dict[str, Any]:
        state = self.evaluate(now)
        return {
            "objective_pct_default": self.objective_pct,
            "thresholds": {"fast": self.fast_threshold,
                           "slow": self.slow_threshold},
            "windows": [{"name": n, "seconds": s} for n, s in WINDOWS],
            "pairs": [{"name": n, "short": s, "long": l}
                      for n, s, l in PAIRS],
            "accounting_window": ACCOUNTING_WINDOW,
            "source_metric": SOURCE_METRIC,
            "budgets": state["budgets"],
            "burning": list(state["reasons"]),
        }


def new_error_budget(config: Any, store: Any, metrics: Any,
                     logger: Any = None) -> Optional[ErrorBudgetPlane]:
    """Config-driven factory (``SLO_BUDGET_ENABLED``, default on).
    Returns None without a TimeSeriesStore — the plane *is* a view over
    the store's rings, there is nothing to compute without them.
    ``SLO_OBJECTIVE_PCT`` (default 99.0) sets the default objective;
    ``SLO_OBJECTIVE_PCT_<CLASS>`` (class name upper-cased, non-alnum →
    ``_``) overrides per SLO class; ``SLO_BURN_FAST_THRESHOLD`` /
    ``SLO_BURN_SLOW_THRESHOLD`` tune the pair thresholds."""
    if store is None or metrics is None:
        return None
    if not config.get_bool("SLO_BUDGET_ENABLED", True):
        return None

    def override(cls: str) -> Optional[float]:
        key = "SLO_OBJECTIVE_PCT_" + _slug(cls).upper()
        pct = config.get_float(key, 0.0)
        return pct if pct > 0 else None

    return ErrorBudgetPlane(
        store, metrics, logger=logger,
        objective_pct=config.get_float("SLO_OBJECTIVE_PCT", 99.0),
        objective_override=override,
        fast_threshold=config.get_float("SLO_BURN_FAST_THRESHOLD", 14.4),
        slow_threshold=config.get_float("SLO_BURN_SLOW_THRESHOLD", 6.0))

"""SLO-driven online operating-point auto-tuning (a copy of
``gofr_tpu/tpu/autotune.py`` over the port's engine).

Hand-swept knobs — prompt-bucket ladders, steps_per_tick, spec-γ,
watermarks, WFQ weights — fit the traffic they were swept on; live
traffic that drifts from that shape leaves goodput on the table. This
module closes the loop:

- :class:`OperatingPoint` — the value object for one knob assignment,
  duck-typed against :meth:`GenerationEngine.apply_operating_point`.
- :class:`AutoTuner` — a cron handler (the fleet Autoscaler's
  single-flight shape) that each firing (1) reads live windowed signals
  from the attached TimeSeriesStore, (2) generates bounded candidate
  points from the xlaz exact-DP suggested ladder (workload-reweighted
  when the TrafficRecorder is attached) plus step moves on
  steps_per_tick / spec-γ cap / page-reserve watermark / staging ring
  depth / WFQ class weights, (3) scores candidates by **shadow replay**
  — the recorder's recent trace replayed against a throwaway clone of
  the engine on a virtual clock, so no live traffic is gambled — and
  (4) applies the winner atomically through the engine's guarded apply
  path, with ladder changes pre-warmed off the hot path (on the card,
  the move's CUDA graphs captured while the engine serves).

The actuation discipline is the shared
:class:`~gofr_tpu_torch.tpu.fleet.GuardedActuator` stack plus two
standing-down gates of its own:

- hysteresis: ``improve_after`` consecutive firings must see a
  candidate before scoring even starts;
- cooldown + compile guard: at least ``cooldown_s`` between applies,
  and never while a serve-time compile (a graph capture) landed inside
  ``compile_window_s`` (the recompile-storm signal — arxiv 2309.08918's
  lesson that shape churn during compilation makes everything worse);
- brownout / fast-burn standoff: while the brownout ladder is shedding
  or an error-budget fast window is burning, the tuner holds — retuning
  a degraded replica fights the incident response;
- probation + automatic rollback: after an apply, the next
  ``probation_ticks`` firings only watch live goodput; a drop past
  ``regress_pct`` vs the pre-apply baseline re-applies the previous
  point (``source="rollback"``) immediately, bypassing its own
  cooldown — undoing a bad move must never wait.

Scoring is split so it is *deterministic*: the shadow replay supplies
the behavioral facts (admitted tokens, errors — did this point actually
serve the traffic?) via the trace-pinned replay harness
(``tpu/workload.replay_trace``), while the cost denominator is computed
host-side from the trace and the candidate's ladder (padded prompt
tokens + a per-tick overhead proxy), not from timing-dependent engine
counters. Two scoring passes over the same trace and candidate return
the identical score.

One rule reads differently on the port: the staging-depth candidate
toggles ``1 ↔ 2`` as JAX's does, but the port's live depth is its
pipelined rings' ``max_inflight_ticks + 1`` (3 by default), so from the
seed point it proposes 1. And a firing is rejected only for a refusal:
``prewarm_operating_point``'s ``ValueError``, or ``apply_operating_point``'s
``RuntimeError`` / ``ValueError``. A ``RuntimeError`` out of the prewarm
is a failed graph capture or a device fault, and raises, where JAX's
tuner notes it as ``rejected`` (a compile failure there).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from gofr_tpu_torch.tpu import faults
from gofr_tpu_torch.tpu.fleet import GuardedActuator
from gofr_tpu_torch.tpu.workload import load_trace, replay_trace

__all__ = ["OperatingPoint", "AutoTuner", "new_autotuner",
           "FAULT_SITE_SELECT"]

# Chaos-plane site (faults.py): when armed, candidate selection is
# inverted — the WORST-scoring candidate is applied and the min-gain
# gate is skipped, forcing the probation window to catch a real
# regression and roll it back. The rollback drill for smoke and bench.
FAULT_SITE_SELECT = "autotune.select"

# Per-tick host overhead, in token-equivalents, charged per fused decode
# tick in the replay cost model. Calibrated proxy, not a measurement:
# one tick costs roughly the dispatch + bookkeeping of ~8 decoded
# tokens on the CPU path, which is what makes larger steps_per_tick win
# exactly until its padded-overshoot cost catches up (the batch-size /
# latency tradeoff curve of arxiv 1812.11731, walked online).
TICK_COST_TOKENS = 8.0

# Replay errors are charged this many admitted tokens each: a candidate
# that fails requests the current point serves must lose decisively, not
# by a rounding margin.
ERROR_COST_TOKENS = 256.0


class OperatingPoint:
    """One assignment of the engine's tunable serving knobs.

    Plain value object — no engine reference — so candidates can be
    generated, scored, ledgered, and compared across firings. ``None``
    for any field means "keep whatever the engine has" (the
    ``apply_operating_point`` contract)."""

    __slots__ = ("prompt_buckets", "steps_per_tick", "gamma_cap",
                 "kv_reserve", "class_weights", "slots_cap",
                 "staging_depth", "source", "note")

    def __init__(self, prompt_buckets=None, steps_per_tick=None,
                 gamma_cap=None, kv_reserve=None, class_weights=None,
                 slots_cap=None, staging_depth=None,
                 source: str = "candidate", note: str = ""):
        self.prompt_buckets = (tuple(int(b) for b in prompt_buckets)
                               if prompt_buckets is not None else None)
        self.steps_per_tick = (int(steps_per_tick)
                               if steps_per_tick is not None else None)
        self.gamma_cap = int(gamma_cap) if gamma_cap is not None else None
        self.kv_reserve = (int(kv_reserve)
                           if kv_reserve is not None else None)
        self.class_weights = (dict(class_weights)
                              if class_weights is not None else None)
        self.slots_cap = int(slots_cap) if slots_cap is not None else None
        self.staging_depth = (int(staging_depth)
                              if staging_depth is not None else None)
        self.source = str(source)
        # one-line provenance for the candidate ledger ("suggested
        # ladder", "k x2", ...), never consumed programmatically
        self.note = str(note)

    @classmethod
    def from_engine(cls, engine) -> "OperatingPoint":
        """Snapshot the engine's LIVE point (``engine.operating_point``)
        — the baseline every candidate is scored against and the point a
        rollback restores."""
        live = engine.operating_point()
        return cls(prompt_buckets=live["prompt_buckets"],
                   steps_per_tick=live["steps_per_tick"],
                   gamma_cap=live["gamma_cap"] or None,
                   kv_reserve=live["kv_reserve"],
                   class_weights=live["class_weights"],
                   slots_cap=live["slots_cap"],
                   staging_depth=live["staging_depth"],
                   source=live["source"])

    def replace(self, note: str = "", **changes) -> "OperatingPoint":
        """A copy with ``changes`` applied — the candidate constructor."""
        fields = {name: getattr(self, name) for name in self.__slots__
                  if name not in ("source", "note")}
        fields.update(changes)
        return OperatingPoint(source="candidate",
                              note=note or self.note, **fields)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "prompt_buckets": (list(self.prompt_buckets)
                               if self.prompt_buckets is not None
                               else None),
            "steps_per_tick": self.steps_per_tick,
            "gamma_cap": self.gamma_cap,
            "kv_reserve": self.kv_reserve,
            "class_weights": self.class_weights,
            "slots_cap": self.slots_cap,
            "staging_depth": self.staging_depth,
            "source": self.source,
            "note": self.note,
        }

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, OperatingPoint):
            return NotImplemented
        return all(getattr(self, name) == getattr(other, name)
                   for name in self.__slots__
                   if name not in ("source", "note"))

    def __repr__(self) -> str:
        knobs = ", ".join(
            f"{name}={getattr(self, name)!r}" for name in self.__slots__
            if name not in ("source", "note")
            and getattr(self, name) is not None)
        return f"OperatingPoint({knobs})"


class AutoTuner:
    """Online operating-point controller, shipped as a cron handler.

    Wire it with ``app.add_cron_job(AUTOTUNE_CRON, "autotune", tuner)``
    (``new_autotuner`` + ``App.start`` do this when
    ``AUTOTUNE_ENABLED=true``). Each firing walks the decision loop
    documented in the module docstring; every decision — hold, refusal,
    proposal, apply, rollback — lands in a bounded candidate ledger that
    ``/debug/tunez`` renders and ``app_tpu_autotune_total{result}``
    counts.

    Injectable seams (tests, bench): ``score_fn(point, trace)`` replaces
    shadow replay entirely; ``goodput_fn()`` replaces the telemetry
    read; ``now_fn`` replaces the clock; ``trace_fn`` replaces the
    recorder export. All default to the real thing."""

    def __init__(self, engine,
                 workload=None, telemetry=None,
                 metrics=None, logger=None,
                 compile_source=None,
                 brownout_fn: Optional[Callable[[], int]] = None,
                 fast_burn_fn: Optional[Callable[[], bool]] = None,
                 improve_after: int = 2,
                 cooldown_s: float = 300.0,
                 compile_window_s: float = 120.0,
                 min_gain_pct: float = 5.0,
                 probation_ticks: int = 3,
                 regress_pct: float = 10.0,
                 max_candidates: int = 4,
                 min_trace_events: int = 16,
                 max_steps_per_tick: int = 8,
                 signal_window_s: float = 60.0,
                 replay_seed: int = 0x5EED,
                 score_fn: Optional[Callable[..., Any]] = None,
                 goodput_fn: Optional[Callable[[], Any]] = None,
                 trace_fn: Optional[Callable[[], Any]] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.workload = workload
        self.telemetry = telemetry
        self.metrics = metrics
        self.logger = logger
        # the recompile-storm source: anything with
        # serving_compiles(window_s) — the executor's CompileLedger when
        # one exists, else the engine's own compile accounting
        if compile_source is None and \
                hasattr(engine, "serving_compiles"):
            compile_source = engine
        self.brownout_fn = brownout_fn or (
            lambda: getattr(engine, "_brownout", 0))
        self.fast_burn_fn = fast_burn_fn
        self.min_gain_pct = float(min_gain_pct)
        self.probation_ticks = int(probation_ticks)
        self.regress_pct = float(regress_pct)
        self.max_candidates = int(max_candidates)
        self.min_trace_events = int(min_trace_events)
        self.max_steps_per_tick = max(1, int(max_steps_per_tick))
        self.signal_window_s = float(signal_window_s)
        self.replay_seed = int(replay_seed)
        self.score_fn = score_fn
        self.goodput_fn = goodput_fn
        self.trace_fn = trace_fn
        self.now_fn = now_fn
        # the shared guard stack (fleet.GuardedActuator): single-flight,
        # hysteresis, cooldown, compile guard — identical discipline to
        # a scale event, because both mutate serving state
        self.guard = GuardedActuator(
            up_after=improve_after, down_after=improve_after,
            cooldown_s=cooldown_s, compile_ledger=compile_source,
            compile_window_s=compile_window_s)
        self._events: List[Dict[str, Any]] = []
        self._probation: Optional[Dict[str, Any]] = None
        self._applies = 0
        self._rollbacks = 0

    # -- cron entry ----------------------------------------------------------
    async def __call__(self, ctx=None) -> Dict[str, Any]:
        if self.guard.busy:
            # single-flight: a firing that finds shadow replay from the
            # previous firing still running drops itself
            return self._note("overlap", {})
        self.guard.busy = True
        try:
            return await self._step()
        finally:
            self.guard.busy = False

    async def _step(self) -> Dict[str, Any]:
        now = self.now_fn()
        signals = self._signals(now)
        # 1. probation first, BYPASSING cooldown: the only thing a
        # just-applied point has earned is scrutiny, and undoing a bad
        # move must never wait out the cooldown that move started
        if self._probation is not None:
            verdict = await self._check_probation(now, signals)
            if verdict is not None:
                return verdict
        # 2. standing-down gates: never retune a replica that is
        # actively degraded — the tuner would fight the incident
        if self.brownout_fn is not None and self.brownout_fn() > 0:
            self.guard.observe(False, False)
            return self._note("refused_brownout", signals)
        if self.fast_burn_fn is not None and self.fast_burn_fn():
            self.guard.observe(False, False)
            return self._note("refused_fast_burn", signals)
        # 3. cheap candidate generation (host arithmetic only); the
        # hysteresis streak counts firings that SAW a candidate, so one
        # noisy xlaz suggestion never triggers a scoring pass
        candidates = self._candidates()
        self.guard.observe(bool(candidates), not candidates)
        if not candidates:
            return self._note("hold", signals)
        if not self.guard.want_up():
            return self._note("hold", signals, reason="hysteresis")
        refusal = self.guard.refusal(now)
        if refusal is not None:
            return self._note(refusal, signals)
        # 4. the evaluation trace: the recorder's recent window. No
        # trace, no evidence — a tuner must not move on a hunch.
        trace = self._load_trace()
        if trace is None:
            return self._note("no_trace", signals)
        # 5. score the live point and every candidate by shadow replay
        current = OperatingPoint.from_engine(self.engine)
        baseline = await self._score_point(current, trace)
        scored: List[Tuple[float, OperatingPoint]] = []
        for candidate in candidates[: self.max_candidates]:
            score = await self._score_point(candidate, trace)
            scored.append((score, candidate))
            self._note("proposed", {}, point=candidate.to_dict(),
                       score=score, baseline=baseline, quiet=True)
        forced = faults.active().should(FAULT_SITE_SELECT)
        if forced:
            # chaos drill: apply the WORST candidate and skip the gain
            # gate — probation must catch it and roll back
            score, winner = min(scored, key=lambda pair: pair[0])
        else:
            score, winner = max(scored, key=lambda pair: pair[0])
            floor = baseline * (1.0 + self.min_gain_pct / 100.0)
            if score < floor:
                return self._note(
                    "rejected", signals, point=winner.to_dict(),
                    score=score, baseline=baseline,
                    reason=f"best score {score:.4f} below min-gain "
                           f"floor {floor:.4f}")
        # 6. pre-warm off the hot path, then the guarded atomic apply.
        # Only a refusal rejects: prewarm refuses a point with a
        # ValueError; its RuntimeError is a failed capture or a device
        # fault, and raises
        try:
            warm = await self.engine.prewarm_operating_point(winner)
        except ValueError as exc:
            return self._note("rejected", signals,
                              point=winner.to_dict(), score=score,
                              baseline=baseline, reason=str(exc))
        try:
            applied = self.engine.apply_operating_point(
                winner, source="autotune")
        except (RuntimeError, ValueError) as exc:
            return self._note("rejected", signals,
                              point=winner.to_dict(), score=score,
                              baseline=baseline, reason=str(exc))
        self.guard.fired(now, "up")
        self._applies += 1
        self._probation = {
            "prev": current,
            "baseline_goodput": signals.get("goodput_tok_s"),
            "ticks_left": self.probation_ticks,
            "applied": applied,
        }
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_autotune_score", float(score))
            self.metrics.set_gauge("app_tpu_autotune_generation",
                                   float(applied["generation"]))
        return self._note(
            "applied", signals, point=winner.to_dict(), score=score,
            baseline=baseline, forced=bool(forced),
            prewarmed=warm.get("compiled", 0),
            generation=applied["generation"])

    # -- probation / rollback ------------------------------------------------
    async def _check_probation(self, now: float,
                               signals: Dict[str, Any]
                               ) -> Optional[Dict[str, Any]]:
        """One probation reading. Returns the firing's result (hold or
        rollback) while probation is open, or None once it closes clean
        — the firing then proceeds as normal."""
        probation = self._probation
        assert probation is not None
        goodput = signals.get("goodput_tok_s")
        baseline = probation.get("baseline_goodput")
        if goodput is not None and baseline:
            floor = baseline * (1.0 - self.regress_pct / 100.0)
            if goodput < floor:
                # the previous point's graphs are still captured (apply
                # keeps the outgoing shape registered), so this prewarm
                # is a no-op pass and the re-apply is compile-free; as in
                # _step, prewarm's RuntimeError (a failed capture) raises
                try:
                    await self.engine.prewarm_operating_point(
                        probation["prev"])
                except ValueError as exc:
                    return self._note("rollback_blocked", signals,
                                      reason=str(exc))
                try:
                    self.engine.apply_operating_point(
                        probation["prev"], source="rollback")
                except (RuntimeError, ValueError) as exc:
                    # e.g. a brownout raced in: keep probation open and
                    # retry the rollback next firing
                    return self._note("rollback_blocked", signals,
                                      reason=str(exc))
                self._probation = None
                self._rollbacks += 1
                self.guard.fired(now, "up")
                return self._note(
                    "rolled_back", signals,
                    point=probation["prev"].to_dict(),
                    reason=f"goodput {goodput:.1f} tok/s fell below "
                           f"{floor:.1f} (baseline {baseline:.1f} "
                           f"- {self.regress_pct:.0f}%)")
        probation["ticks_left"] -= 1
        if probation["ticks_left"] <= 0:
            self._probation = None
            self._note("probation_ok", signals, quiet=True)
            return None
        return self._note("probation", signals,
                          ticks_left=probation["ticks_left"])

    # -- signals -------------------------------------------------------------
    def _signals(self, now: float) -> Dict[str, Any]:
        """Windowed live signals from the TimeSeriesStore.
        Sparse: a signal the store doesn't carry is simply absent, and
        the decision loop treats absence as "no evidence" (e.g. no
        goodput reading → probation cannot judge, so it just counts
        down)."""
        out: Dict[str, Any] = {}
        store = self.telemetry
        if store is not None:
            for name in ("goodput_tok_s", "padding_ratio", "mfu",
                         "queue_depth", "kv_occupancy"):
                try:
                    value = store.window_mean(name, self.signal_window_s)
                except Exception:
                    continue
                if value is not None:
                    out[name] = value
        if self.goodput_fn is not None:
            value = self.goodput_fn()
            if value is not None:
                out["goodput_tok_s"] = float(value)
        return out

    # -- candidate generation ------------------------------------------------
    def _candidates(self) -> List[OperatingPoint]:
        """Bounded candidate set, cheapest signals first. Pure host
        arithmetic — no device work, no replay — so it is safe to run
        on every firing just to feed the hysteresis streak."""
        engine = self.engine
        current = OperatingPoint.from_engine(engine)
        out: List[OperatingPoint] = []
        # 1. the xlaz exact-DP suggested ladder — workload-reweighted
        # when the TrafficRecorder is attached (ladder_source
        # "workload_trace"), lifetime observed lengths otherwise
        suggested = None
        try:
            suggested = engine.xlaz()["models"]["prompt"][
                "suggested_ladder"]
        except Exception:
            suggested = None
        ladder = self._normalize_ladder(suggested)
        if ladder and ladder != current.prompt_buckets:
            out.append(current.replace(prompt_buckets=ladder,
                                       note="xlaz suggested ladder"))
        # 2. fused-steps ladder: one doubling / halving per firing
        k = current.steps_per_tick or 1
        if k * 2 <= self.max_steps_per_tick:
            out.append(current.replace(steps_per_tick=k * 2,
                                       note="steps_per_tick x2"))
        if k > 1:
            out.append(current.replace(steps_per_tick=k // 2,
                                       note="steps_per_tick /2"))
        # 3. speculative-γ cap, one rung at a time
        if getattr(engine, "spec", False):
            cap = current.gamma_cap or engine.spec_gamma
            if cap > 1:
                out.append(current.replace(gamma_cap=cap - 1,
                                           note="gamma cap -1"))
            if cap < engine.spec_gamma:
                out.append(current.replace(gamma_cap=cap + 1,
                                           note="gamma cap +1"))
        # 4. page-pool reserve watermark (paged only), ±1/16 of the pool
        if getattr(engine, "paged", False):
            pages = engine._pool.num_pages
            step = max(1, pages // 16)
            reserve = current.kv_reserve or 0
            if reserve + step <= pages // 4:
                out.append(current.replace(kv_reserve=reserve + step,
                                           note="kv reserve +"))
            if reserve - step >= 0:
                out.append(current.replace(kv_reserve=reserve - step,
                                           note="kv reserve -"))
        # 5. staging ring depth toggle (1 ↔ 2): double-buffered H2D
        # uploads vs a smaller pinned footprint. JAX's rule, kept as is:
        # the port's rings start at max_inflight_ticks + 1 (3), so from
        # the seed point it proposes 1
        depth = current.staging_depth or 1
        out.append(current.replace(staging_depth=2 if depth == 1 else 1,
                                   note="staging depth toggle"))
        # 6. admission slots cap, one slot at a time (None = uncapped)
        cap = current.slots_cap or engine.max_slots
        if cap > 1:
            out.append(current.replace(slots_cap=cap - 1,
                                       note="slots cap -1"))
        if cap < engine.max_slots:
            out.append(current.replace(slots_cap=cap + 1,
                                       note="slots cap +1"))
        # 7. WFQ class weights: double / halve the interactive boost
        # (bounded [1, 16] — the batch class anchors at its own weight)
        weights = dict(current.class_weights or {})
        boost = weights.get("interactive")
        if boost:
            if boost * 2 <= 16:
                out.append(current.replace(
                    class_weights=dict(weights, interactive=boost * 2),
                    note="interactive weight x2"))
            if boost / 2 >= 1:
                out.append(current.replace(
                    class_weights=dict(weights, interactive=boost / 2),
                    note="interactive weight /2"))
        return out

    def _normalize_ladder(self, suggested) -> Optional[Tuple[int, ...]]:
        """Suggested ladder → an applyable bucket tuple: ints, deduped,
        sorted, clamped to max_len, rounded up to kv_page multiples on
        the paged path. None when nothing survives."""
        if not suggested:
            return None
        engine = self.engine
        page = engine.kv_page if getattr(engine, "paged", False) else 1
        buckets = set()
        for raw in suggested:
            bucket = -(-int(raw) // page) * page
            if 1 <= bucket <= engine.max_len:
                buckets.add(bucket)
        return tuple(sorted(buckets)) or None

    # -- trace + scoring -----------------------------------------------------
    def _load_trace(self):
        """The recorder's recent window as a replayable trace, or None
        below the evidence floor (``min_trace_events``)."""
        if self.trace_fn is not None:
            data = self.trace_fn()
        elif self.workload is not None:
            data = self.workload.export_trace()
        else:
            return None
        trace = data if hasattr(data, "events") else load_trace(data)
        if len(trace.events) < self.min_trace_events:
            return None
        return trace

    async def _score_point(self, point: OperatingPoint, trace) -> float:
        """Score one candidate. ``score_fn`` (tests/bench) wins;
        otherwise shadow replay against a throwaway engine clone plus
        the deterministic host-side cost model."""
        if self.score_fn is not None:
            result = self.score_fn(point, trace)
            if asyncio.iscoroutine(result):
                result = await result
            return float(result)
        shadow = self.engine.shadow_clone(point)
        try:
            await shadow.start()
            result = await replay_trace(shadow, trace, time_scale=0.0,
                                        seed=self.replay_seed)
        finally:
            await shadow.stop()
        return self.score_replay(point, trace, result)

    def score_replay(self, point: OperatingPoint, trace,
                     result: Dict[str, Any]) -> float:
        """Deterministic goodput-per-cost proxy.

        Numerator: the replay's admitted tokens (behavioral fact — did
        the candidate actually serve this traffic?), with each replay
        error charged ``ERROR_COST_TOKENS``. Denominator: padded prompt
        tokens under the candidate's ladder plus ``TICK_COST_TOKENS``
        per fused decode tick — both computed host-side from the trace,
        so two scorings of the same (point, trace, replay tally) are
        bit-identical regardless of engine timing."""
        buckets = tuple(sorted(
            point.prompt_buckets or self.engine.prompt_buckets))
        k = point.steps_per_tick or self.engine.steps_per_tick or 1
        top = max(buckets)
        padded = 0
        ticks = 0
        for event in trace.events:
            length = min(event.prompt_len, top)
            padded += next(b for b in buckets if b >= length)
            decoded = event.output_len or event.budget or 1
            ticks += -(-decoded // k)
        tokens = float(result.get("admitted_tokens", 0))
        errors = float(result.get("errors", 0))
        gain = max(0.0, tokens - ERROR_COST_TOKENS * errors)
        cost = float(padded) + TICK_COST_TOKENS * float(ticks)
        return gain / max(cost, 1.0)

    # -- ledger / views ------------------------------------------------------
    def _note(self, result: str, signals: Dict[str, Any],
              quiet: bool = False, **extra) -> Dict[str, Any]:
        event: Dict[str, Any] = {"result": result, "at": self.now_fn(),
                                 **extra}
        if signals:
            event["signals"] = dict(signals)
        self._events.append(event)
        del self._events[:-64]
        if self.metrics is not None and not quiet:
            self.metrics.increment_counter("app_tpu_autotune_total",
                                           result=result)
        if self.logger is not None and \
                result in ("applied", "rolled_back"):
            self.logger.info("autotune: %s %s", result,
                             extra.get("point") or "")
        return event

    def ledger(self) -> List[Dict[str, Any]]:
        """The bounded candidate ledger, oldest first: proposed →
        scored → applied / rejected / rolled-back, with reasons."""
        return list(self._events)

    def status(self) -> Dict[str, Any]:
        """Rollup for ``/debug/tunez`` and statusz."""
        probation = None
        if self._probation is not None:
            probation = {
                "ticks_left": self._probation["ticks_left"],
                "baseline_goodput": self._probation["baseline_goodput"],
                "prev": self._probation["prev"].to_dict(),
            }
        return {
            "operating_point": self.engine.operating_point(),
            "guard": self.guard.status(),
            "probation": probation,
            "applies": self._applies,
            "rollbacks": self._rollbacks,
            "min_gain_pct": self.min_gain_pct,
            "regress_pct": self.regress_pct,
            "recent": self._events[-8:],
        }


def new_autotuner(config, tpu, workload=None, telemetry=None,
                  metrics=None, logger=None,
                  fast_burn_fn=None) -> Optional[AutoTuner]:
    """Composition-root factory (``App.start``). Opt-in like the fleet
    autoscaler: ``AUTOTUNE_ENABLED`` defaults OFF — a controller that
    moves serving knobs must be asked for. Returns None when disabled
    or when ``tpu`` does not expose the guarded apply path."""
    if config is None or tpu is None:
        return None
    if not config.get_bool("AUTOTUNE_ENABLED", False):
        return None
    if not hasattr(tpu, "apply_operating_point"):
        return None
    # prefer the executor's CompileLedger when one is wired; fall back
    # to the engine's own serving-compile accounting
    compile_source = getattr(tpu, "ledger", None)
    if compile_source is None and hasattr(tpu, "serving_compiles"):
        compile_source = tpu
    return AutoTuner(
        tpu, workload=workload, telemetry=telemetry,
        metrics=metrics, logger=logger,
        compile_source=compile_source,
        fast_burn_fn=fast_burn_fn,
        improve_after=config.get_int("AUTOTUNE_IMPROVE_AFTER", 2),
        cooldown_s=config.get_float("AUTOTUNE_COOLDOWN_S", 300.0),
        compile_window_s=config.get_float(
            "AUTOTUNE_COMPILE_WINDOW_S", 120.0),
        min_gain_pct=config.get_float("AUTOTUNE_MIN_GAIN_PCT", 5.0),
        probation_ticks=config.get_int("AUTOTUNE_PROBATION_TICKS", 3),
        regress_pct=config.get_float("AUTOTUNE_REGRESS_PCT", 10.0),
        max_candidates=config.get_int("AUTOTUNE_MAX_CANDIDATES", 4),
        min_trace_events=config.get_int("AUTOTUNE_MIN_TRACE_EVENTS", 16),
        max_steps_per_tick=config.get_int("AUTOTUNE_MAX_STEPS", 8))

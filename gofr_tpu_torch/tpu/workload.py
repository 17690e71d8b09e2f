"""Workload capture and replay (a copy of ``gofr_tpu/tpu/workload.py``).

- :class:`TrafficRecorder`: a bounded, shape-only ring of admitted
  requests. Per request it keeps the inter-arrival delta, the SLO class,
  the model name, the prompt and output token lengths, the relative
  deadline budget, the cached-prefix length and the finish reason; never
  token ids, prompt text or request bodies.
- A versioned compact JSON trace (:meth:`TrafficRecorder.export_trace`,
  :func:`load_trace`): a header with legends and one fixed-width numeric
  row an event.
- :func:`replay_trace`: the trace through a live engine on a virtual
  clock, admissions in recorded order, each request a deterministic seed
  and a synthesized prompt of the recorded length, ``eos_id=None`` so its
  output length is the recorded one. Two replays of one trace give the
  same ``digest``.

Hook points: the engine's ``generate`` / ``generate_stream`` admission
(:meth:`TrafficRecorder.admit`, which parks the event on the flight
record) and ``FlightRecorder.finish``, the one funnel every terminal
status passes through (:meth:`TrafficRecorder.finish`).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

TRACE_VERSION = 1
TRACE_KIND = "gofr-workload-trace"

# snapshot histogram edges: inter-arrival (seconds) and token lengths
_DT_EDGES_S = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)
_LEN_EDGES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# label-cardinality bounds for the open-keyed mixes (models arrive from
# config, classes/finishes are closed sets — the gates make the bound
# structural rather than assumed)
_MAX_KEYS = 64


class TraceVersionError(ValueError):
    """Raised by :func:`load_trace` on schema skew: a trace produced by
    a different recorder version must be rejected loudly, not replayed
    into silently-wrong tallies."""


class TrafficEvent:
    """One admitted request, shape only. ``dt_s`` is the inter-arrival
    delta against the previous admission (0 for the first). Numbers and
    short enum labels exclusively — never token content."""

    __slots__ = ("dt_s", "cls", "model", "prompt_len", "budget",
                 "output_len", "deadline_ms", "cached_prefix_len",
                 "finish")

    def __init__(self, dt_s: float = 0.0, cls: str = "standard",
                 model: str = "generate", prompt_len: int = 0,
                 budget: int = 0, output_len: int = 0,
                 deadline_ms: Optional[float] = None,
                 cached_prefix_len: int = 0,
                 finish: Optional[str] = None):
        self.dt_s = dt_s
        self.cls = cls
        self.model = model
        self.prompt_len = prompt_len
        self.budget = budget
        self.output_len = output_len
        self.deadline_ms = deadline_ms
        self.cached_prefix_len = cached_prefix_len
        self.finish = finish


def _bump(mix: Dict[str, int], key: str) -> None:
    """Cardinality-gated counter bump: an unbounded label space (a bug
    upstream) saturates into ``"_other"`` instead of growing the dict."""
    if key not in mix and len(mix) >= _MAX_KEYS:
        key = "_other"
    mix[key] = mix.get(key, 0) + 1


def _histogram(values: List[float], edges) -> Dict[str, int]:
    counts = [0] * (len(edges) + 1)
    for value in values:
        for i, edge in enumerate(edges):
            if value <= edge:
                counts[i] += 1
                break
        else:
            counts[len(edges)] += 1
    out = {f"le_{edge}": counts[i] for i, edge in enumerate(edges)}
    out["inf"] = counts[len(edges)]
    return out


class TrafficRecorder:
    """Bounded shape-only ring of admitted requests plus the batcher's
    enqueue pulse. All host bookkeeping: O(1) per admission, snapshot
    work bounded by the ring capacity. Thread-safe — admissions come
    from the serving loop, ``note_enqueue`` from the batcher, snapshots
    and exports from admin endpoints."""

    def __init__(self, capacity: int = 2048, metrics: Any = None):
        self.capacity = max(1, int(capacity))
        self.metrics = metrics
        self._lock = threading.Lock()
        self._ring: "deque[TrafficEvent]" = deque(maxlen=self.capacity)
        self._last_arrival: Optional[float] = None
        self._admitted_total = 0
        self._finished_total = 0
        self._class_mix: Dict[str, int] = {}
        self._finish_mix: Dict[str, int] = {}
        # batcher plane: per-model enqueue counts + inter-arrival digest
        self._enqueues_total = 0
        self._enqueue_models: Dict[str, int] = {}
        self._enqueue_last: Optional[float] = None
        self._enqueue_dt: "deque[float]" = deque(maxlen=self.capacity)

    # -- engine admission hook ----------------------------------------------
    def admit(self, record: Any, cls: str,
              deadline: Optional[float] = None,
              now: Optional[float] = None) -> TrafficEvent:
        """One admitted request. ``record`` is the flight-recorder
        ``RequestRecord`` (the shape fields — model, prompt_len, budget —
        are read from it, never the content); the event is parked on
        ``record.wevent`` so ``FlightRecorder.finish`` can close it with
        the output length and terminal status."""
        now = time.monotonic() if now is None else now
        deadline_ms = None
        if deadline is not None:
            deadline_ms = max(0.0, (deadline - now) * 1000.0)
        with self._lock:
            dt = (0.0 if self._last_arrival is None
                  else max(0.0, now - self._last_arrival))
            self._last_arrival = now
            event = TrafficEvent(
                dt_s=dt, cls=cls, model=record.model,
                prompt_len=int(record.prompt_len),
                budget=int(record.budget), deadline_ms=deadline_ms)
            self._ring.append(event)
            self._admitted_total += 1
            _bump(self._class_mix, cls)
        record.wevent = event
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_workload_events_total",
                model=record.model, cls=cls)
        return event

    def finish(self, record: Any) -> None:
        """Close the admission event with the record's terminal shape:
        output length, realized cached-prefix length, finish reason.
        Called by ``FlightRecorder.finish`` — every terminal path
        (done/cancelled/error/expired) already funnels through it."""
        event = getattr(record, "wevent", None)
        if event is None:
            return
        record.wevent = None   # one-shot: replays of finish are no-ops
        with self._lock:
            event.output_len = int(record.tokens)
            event.cached_prefix_len = int(record.cached_prefix_len)
            event.finish = record.status
            self._finished_total += 1
            _bump(self._finish_mix, record.status)

    # -- batcher enqueue hook -----------------------------------------------
    def note_enqueue(self, model: str, now: Optional[float] = None) -> None:
        """One example entering the dynamic batcher — the classify-plane
        arrival pulse (model mix + inter-arrival), no per-example shape
        beyond the model name."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._enqueues_total += 1
            _bump(self._enqueue_models, model)
            if self._enqueue_last is not None:
                self._enqueue_dt.append(max(0.0, now - self._enqueue_last))
            self._enqueue_last = now

    # -- derived views -------------------------------------------------------
    def prompt_length_distribution(
            self, model: Optional[str] = None) -> Dict[int, int]:
        """Observed prompt-length counts over the ring window — the
        workload-aware weighting the xlaz suggested-ladder DP consumes
        (recent traffic shape, not lifetime bucket hits)."""
        with self._lock:
            events = list(self._ring)
        out: Dict[int, int] = {}
        for event in events:
            if model is not None and event.model != model:
                continue
            out[event.prompt_len] = out.get(event.prompt_len, 0) + 1
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/workloadz`` payload: inter-arrival and length
        histograms over the ring window, class/finish mixes, and the
        prefix-reuse rate. Work bounded by the ring capacity."""
        with self._lock:
            events = list(self._ring)
            class_mix = dict(self._class_mix)
            finish_mix = dict(self._finish_mix)
            admitted = self._admitted_total
            finished = self._finished_total
            enq_total = self._enqueues_total
            enq_models = dict(self._enqueue_models)
            enq_dt = list(self._enqueue_dt)
        prompt_lens = [e.prompt_len for e in events]
        finished_events = [e for e in events if e.finish is not None]
        output_lens = [e.output_len for e in finished_events]
        dts = [e.dt_s for e in events[1:]]
        reused = [e for e in finished_events if e.cached_prefix_len > 0]
        prompt_len_sum = sum(e.prompt_len for e in finished_events)
        cached_len_sum = sum(e.cached_prefix_len for e in finished_events)
        return {
            "capacity": self.capacity,
            "window_events": len(events),
            "admitted_total": admitted,
            "finished_total": finished,
            "class_mix": class_mix,
            "finish_mix": finish_mix,
            "interarrival_s": {
                "histogram": _histogram(dts, _DT_EDGES_S),
                "mean": (round(sum(dts) / len(dts), 6) if dts else None),
            },
            "prompt_len": {
                "histogram": _histogram(prompt_lens, _LEN_EDGES),
                "mean": (round(sum(prompt_lens) / len(prompt_lens), 2)
                         if prompt_lens else None),
            },
            "output_len": {
                "histogram": _histogram(output_lens, _LEN_EDGES),
                "mean": (round(sum(output_lens) / len(output_lens), 2)
                         if output_lens else None),
            },
            "prefix_reuse": {
                "requests_with_reuse": len(reused),
                "request_rate": (round(len(reused) / len(finished_events), 4)
                                 if finished_events else None),
                "token_rate": (round(cached_len_sum / prompt_len_sum, 4)
                               if prompt_len_sum else None),
            },
            "batcher": {
                "enqueues_total": enq_total,
                "models": enq_models,
                "interarrival_s": {
                    "histogram": _histogram(enq_dt, _DT_EDGES_S),
                    "mean": (round(sum(enq_dt) / len(enq_dt), 6)
                             if enq_dt else None),
                },
            },
        }

    # -- trace export --------------------------------------------------------
    def export_trace(self) -> Dict[str, Any]:
        """Versioned compact trace: legends in the header, one numeric
        row per event — ``[dt_s, model_idx, cls_idx, prompt_len, budget,
        output_len, deadline_ms(-1=None), cached_prefix_len,
        finish_idx(-1=in flight)]``."""
        with self._lock:
            events = list(self._ring)
        models: List[str] = []
        classes: List[str] = []
        finishes: List[str] = []

        def index(legend: List[str], value: str) -> int:
            try:
                return legend.index(value)
            except ValueError:
                legend.append(value)
                return len(legend) - 1

        rows = []
        for e in events:
            rows.append([
                round(e.dt_s, 6),
                index(models, e.model),
                index(classes, e.cls),
                e.prompt_len,
                e.budget,
                e.output_len,
                (-1 if e.deadline_ms is None
                 else round(e.deadline_ms, 3)),
                e.cached_prefix_len,
                (-1 if e.finish is None else index(finishes, e.finish)),
            ])
        return {
            "kind": TRACE_KIND,
            "version": TRACE_VERSION,
            "created_unix": time.time(),
            "models": models,
            "classes": classes,
            "finishes": finishes,
            "events": rows,
        }


class WorkloadTrace:
    """A loaded trace: validated header + decoded events."""

    __slots__ = ("version", "events")

    def __init__(self, version: int, events: List[TrafficEvent]):
        self.version = version
        self.events = events


def load_trace(data: Any) -> WorkloadTrace:
    """Decode an exported trace dict (or JSON string). Raises
    :class:`TraceVersionError` on kind/version skew — a trace from a
    different schema must never replay into plausible-looking numbers."""
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    if not isinstance(data, dict) or data.get("kind") != TRACE_KIND:
        raise TraceVersionError(
            f"not a {TRACE_KIND} payload: kind={data.get('kind')!r}"
            if isinstance(data, dict) else "trace payload is not a dict")
    version = data.get("version")
    if version != TRACE_VERSION:
        raise TraceVersionError(
            f"trace version {version!r} != supported {TRACE_VERSION}")
    models = list(data.get("models") or [])
    classes = list(data.get("classes") or [])
    finishes = list(data.get("finishes") or [])

    def legend(items: List[str], idx: int, default: str) -> Optional[str]:
        if idx < 0:
            return None
        return items[idx] if idx < len(items) else default

    events: List[TrafficEvent] = []
    for row in data.get("events") or []:
        (dt_s, model_i, cls_i, prompt_len, budget, output_len,
         deadline_ms, cached, finish_i) = row
        events.append(TrafficEvent(
            dt_s=float(dt_s),
            model=legend(models, int(model_i), "generate") or "generate",
            cls=legend(classes, int(cls_i), "standard") or "standard",
            prompt_len=int(prompt_len),
            budget=int(budget),
            output_len=int(output_len),
            deadline_ms=(None if deadline_ms is None or deadline_ms < 0
                         else float(deadline_ms)),
            cached_prefix_len=int(cached),
            finish=legend(finishes, int(finish_i), "done"),
        ))
    return WorkloadTrace(version=int(version), events=events)


# -- replay ------------------------------------------------------------------
def _synth_prompt(index: int, length: int, vocab: int, seed: int) -> List[int]:
    """Deterministic content-free prompt of the recorded length: a
    per-(seed, index) affine walk over the vocab, avoiding id 0 so a
    pad-id convention cannot collide. Same trace + seed → bit-identical
    prompts on every replay."""
    span = max(1, vocab - 1)
    base = (seed * 2654435761 + index * 1000003) & 0x7FFFFFFF
    return [(base + j * 97) % span + 1 for j in range(max(1, length))]


def _request_seed(index: int, seed: int) -> int:
    return (seed ^ (index * 0x9E3779B9)) & 0x7FFFFFFF


async def replay_trace(engine, trace: WorkloadTrace,
                       time_scale: float = 1.0,
                       seed: int = 0x5EED,
                       honor_deadlines: bool = False) -> Dict[str, Any]:
    """Replay ``trace`` through a live engine on a virtual clock.

    Admissions happen strictly in recorded order; ``time_scale`` scales
    the recorded inter-arrival deltas (1.0 = arrival-faithful, 0.0 = as
    fast as the loop admits, still ordered). Each request synthesizes a
    prompt of the recorded length, carries a deterministic per-index
    ``Sampling`` seed, decodes with ``eos_id=None``, and targets its
    recorded output length (falling back to the recorded budget for
    events that never finished) — so the admitted-token count per
    request is pinned by the trace, not by model content.

    ``honor_deadlines=False`` (default) admits every request without a
    deadline: outcomes cannot depend on host timing, which is what makes
    two replays bit-identical (the acceptance bar). Flip it on to
    reproduce deadline-class scheduling pressure at the cost of
    timing-dependent shed/expire outcomes. Per-class tallies always key
    on the *recorded* class.

    Returns ``{requests, admitted_tokens, errors, per_class, digest}``
    where ``digest`` hashes the canonical tally — two replays of the
    same trace compare equal iff their digests do."""
    from gofr_tpu_torch.slo import set_request_deadline
    from gofr_tpu_torch.tpu.generate import Sampling

    vocab = int(getattr(getattr(engine, "cfg", None), "vocab_size", 0)) \
        or 32000
    per_class: Dict[str, Dict[str, Any]] = {}
    totals = {"requests": 0, "admitted_tokens": 0, "errors": 0}

    def tally(cls: str) -> Dict[str, Any]:
        entry = per_class.get(cls)
        if entry is None:
            entry = per_class[cls] = {"requests": 0, "tokens": 0,
                                      "outcomes": {}}
        return entry

    async def one(index: int, event: TrafficEvent) -> None:
        prompt = _synth_prompt(index, event.prompt_len, vocab, seed)
        budget = event.output_len if event.output_len > 0 else event.budget
        budget = max(1, budget)
        if honor_deadlines and event.deadline_ms:
            set_request_deadline(event.deadline_ms)
        else:
            set_request_deadline(None)
        entry = tally(event.cls)
        entry["requests"] += 1
        totals["requests"] += 1
        try:
            tokens = await engine.generate(
                prompt, max_new_tokens=budget, eos_id=None,
                sampling=Sampling(seed=_request_seed(index, seed)))
        except Exception as exc:
            totals["errors"] += 1
            outcome = type(exc).__name__
            entry["outcomes"][outcome] = \
                entry["outcomes"].get(outcome, 0) + 1
            return
        entry["tokens"] += len(tokens)
        entry["outcomes"]["ok"] = entry["outcomes"].get("ok", 0) + 1
        totals["admitted_tokens"] += len(tokens)

    from gofr_tpu_torch.aio import spawn_logged
    tasks = []
    for index, event in enumerate(trace.events):
        if time_scale > 0 and event.dt_s > 0 and index > 0:
            await asyncio.sleep(event.dt_s * time_scale)
        tasks.append(spawn_logged(one(index, event),
                                  name=f"replay-{index}"))
    if tasks:
        await asyncio.gather(*tasks)

    result = {
        "requests": totals["requests"],
        "admitted_tokens": totals["admitted_tokens"],
        "errors": totals["errors"],
        "per_class": {cls: per_class[cls] for cls in sorted(per_class)},
    }
    result["digest"] = hashlib.sha256(
        json.dumps(result, sort_keys=True).encode()).hexdigest()[:16]
    return result


def new_traffic_recorder(config, metrics: Any = None) \
        -> Optional[TrafficRecorder]:
    """Composition-root factory (``App.start``): ``TRAFFIC_REC_ENABLED``
    (default on) and ``TRAFFIC_REC_CAPACITY`` (ring size, default 2048;
    <= 0 disables). Returns None when disabled — every hook site treats
    a None recorder as zero-cost."""
    enabled = str((config.get("TRAFFIC_REC_ENABLED") if config else None)
                  or "true").strip().lower()
    if enabled in ("0", "false", "off", "no"):
        return None
    capacity = (config.get_int("TRAFFIC_REC_CAPACITY", 2048)
                if config else 2048)
    if capacity <= 0:
        return None
    return TrafficRecorder(capacity=capacity, metrics=metrics)

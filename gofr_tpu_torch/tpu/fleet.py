"""Fleet control plane: prefix-affinity routing, live decode→decode
migration, resumable decode and a cron-driven autoscaler (a copy of
``gofr_tpu/tpu/fleet.py`` over the port's engines and its in-process
cluster).

Three pieces compose the primitives the port already has into a fleet
that heals, rebalances, and scales itself:

- :class:`FleetPrefixIndex` + :class:`FleetRouter` — each replica's
  clusterz probe carries a compact digest of its resident prefix-cache
  chains (``PrefixStore.digest``); the router intersects an incoming
  prompt's chained page hashes (``prefix_cache.chain_hashes``) with the
  index and routes to the replica holding the longest resident prefix,
  falling back to the registry's least-inflight pick on a miss
  (``app_tpu_fleet_route_total{result=affinity|fallback}``).
- :class:`FleetSession` + :meth:`FleetRouter.migrate_session` — live
  migration of a mid-stream decode session: the source engine snapshots
  the slot (``export_session``), the payload ships over ``kv_wire`` in
  bounded chunks, the target adopts it at refcount 1
  (``adopt_session``), and the session splices the new replica's stream
  onto the client's iterator with no visible gap. Drain becomes
  migrate-out (:meth:`FleetRouter.drain`) instead of wait-for-slots. A
  replica that dies mid-stream is healed by rebuilding the request from
  prompt + delivered tokens on a peer (:meth:`FleetRouter._resume_session`).
- :class:`Autoscaler` — a cron handler that grows/shrinks the decode
  pool from replica rollups (queue depth, pool occupancy), the
  HBM-pressure signal (``hbmz.hbm_occupancy``), and hysteresis streaks,
  guarded by a cooldown and the compile ledger so a scale event can
  never land in the middle of a recompile storm (on the card a compile
  is a CUDA-graph capture). The handler is single-flight: a firing that
  overlaps a still-running step returns immediately.
  :class:`GuardedActuator` holds that guard stack; the operating-point
  auto-tuner (``tpu/autotune.py``) actuates through it too.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from gofr_tpu_torch.hbmz import hbm_occupancy
from gofr_tpu_torch.metrics.timeseries import SeriesRing
from gofr_tpu_torch.tpu import faults, kv_wire
from gofr_tpu_torch.tpu.cluster import (DisaggRouter, NoReplicaAvailable,
                                        Replica, ROLE_DECODE, STATE_DRAINING,
                                        STATE_READY, _RelayStream)
from gofr_tpu_torch.tpu.prefix_cache import chain_hashes

__all__ = ["FleetPrefixIndex", "FleetSeriesRollup", "FleetSession",
           "FleetRouter", "GuardedActuator", "Autoscaler"]


class FleetSeriesRollup:
    """Fleet-wide short-window series built from replica telemetry
    deltas.

    ``FleetRouter.refresh`` pulls each decode replica's
    ``telemetry_delta(cursor)`` (cursor-based, bounded payload) and
    feeds the samples here; the :class:`Autoscaler` then reads
    *window means* instead of instantaneous probe sums. That closes the
    flap the probe sweep had: one stale or dead probe used to silently
    drop its queue-depth contribution from the sum, reading as a fleet
    gone idle and starting a scale-down streak. A window mean keeps the
    missing replica's recent samples contributing until the window
    drains — a probe miss decays instead of cliffing.

    Memory contract: per replica, only :data:`SIGNALS` (3 signals) ×
    one 1s ring of ``capacity`` buckets (default 120) — ~replicas × 3 ×
    120 × 5 floats, independent of uptime. Timestamps in deltas are the
    *source* process's monotonic clock; ``ingest`` re-stamps them onto
    the puller's clock preserving sample spacing."""

    SIGNALS = ("queue_depth", "kv_occupancy", "goodput_tok_s")

    def __init__(self, window_s: float = 30.0, capacity: int = 120):
        self.window_s = float(window_s)
        self.capacity = int(capacity)
        self._rings: Dict[str, Dict[str, SeriesRing]] = {}
        self._cursors: Dict[str, Optional[int]] = {}
        self._last_seen: Dict[str, float] = {}
        self._misses: Dict[str, int] = {}
        self._pulls = 0
        self._resets = 0

    def cursor(self, name: str) -> Optional[int]:
        """The cursor to hand the replica's next ``telemetry_delta``."""
        return self._cursors.get(name)

    def ingest(self, name: str, delta: Dict[str, Any],
               now: Optional[float] = None) -> int:
        """Fold one delta payload into the replica's rings; returns the
        number of samples folded."""
        if now is None:
            now = time.monotonic()
        samples = delta.get("samples") or []
        if delta.get("reset"):
            self._resets += 1
            # the cursor fell off the source's log (or the replica
            # restarted): the carried samples are a fresh start, so the
            # stale window must not blend with them
            self._rings.pop(name, None)
        self._cursors[name] = delta.get("cursor")
        self._pulls += 1
        self._last_seen[name] = now
        if not samples:
            return 0
        rings = self._rings.get(name)
        if rings is None:
            rings = self._rings[name] = {
                sig: SeriesRing(1.0, self.capacity) for sig in self.SIGNALS}
        # re-stamp: align the newest source timestamp to the puller's
        # `now`, shifting every sample by the same offset
        offset = now - float(samples[-1]["t"])
        folded = 0
        for sample in samples:
            at = float(sample["t"]) + offset
            values = sample.get("values") or {}
            for sig in self.SIGNALS:
                value = values.get(sig)
                if value is not None:
                    rings[sig].add(float(value), at)
                    folded += 1
        return folded

    def note_miss(self, name: str, now: Optional[float] = None) -> None:
        """A refresh pass could not reach the replica. The rings keep
        their samples — the window mean decays them out naturally."""
        self._misses[name] = self._misses.get(name, 0) + 1

    def drop(self, name: str) -> None:
        """The replica left the registry for good."""
        self._rings.pop(name, None)
        self._cursors.pop(name, None)
        self._last_seen.pop(name, None)
        self._misses.pop(name, None)

    def fresh(self, now: Optional[float] = None) -> bool:
        """True when at least one replica delivered a delta inside the
        window — the autoscaler's gate before trusting the means."""
        if now is None:
            now = time.monotonic()
        return any(now - at <= self.window_s
                   for at in self._last_seen.values())

    def signals(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Fleet window means: queue depth *summed* across replicas,
        occupancy the fleet *max*, goodput summed — each from the 30s
        window, so a missed probe decays instead of zeroing."""
        if now is None:
            now = time.monotonic()
        queue_depth = 0.0
        queue_seen = False
        occupancy: Optional[float] = None
        goodput = 0.0
        contributing = 0
        for name, rings in self._rings.items():
            depth = rings["queue_depth"].window_mean(self.window_s, now)
            occ = rings["kv_occupancy"].window_mean(self.window_s, now)
            good = rings["goodput_tok_s"].window_mean(self.window_s, now)
            if depth is None and occ is None and good is None:
                continue
            contributing += 1
            if depth is not None:
                queue_depth += depth
                queue_seen = True
            if occ is not None:
                occupancy = occ if occupancy is None else max(occupancy, occ)
            if good is not None:
                goodput += good
        return {
            "queue_depth": queue_depth if queue_seen else None,
            "occupancy": occupancy,
            "goodput_tok_s": goodput,
            "contributing": contributing,
            "window_s": self.window_s,
        }

    def statusz(self, now: Optional[float] = None) -> Dict[str, Any]:
        if now is None:
            now = time.monotonic()
        return {
            "window_s": self.window_s,
            "fresh": self.fresh(now),
            "pulls": self._pulls,
            "resets": self._resets,
            "misses": dict(self._misses),
            "replicas": {
                name: {"age_s": round(now - self._last_seen[name], 3)
                       if name in self._last_seen else None,
                       "cursor": self._cursors.get(name)}
                for name in self._rings},
            "signals": self.signals(now),
        }


class FleetPrefixIndex:
    """Fleet-wide view of which replica holds which resident prefix.

    One entry set per replica, filled from ``PrefixStore.digest``
    payloads carried on clusterz probes. Because digest entries are
    *chained* page hashes, membership of ``hashes[i]`` certifies the
    whole prefix ``tokens[:(i+1)*page]`` is resident on that replica —
    the index never needs the raw tokens."""

    def __init__(self) -> None:
        self._entries: Dict[str, Set[str]] = {}
        self._occupancy: Dict[str, float] = {}
        self._page: Optional[int] = None

    def update(self, name: str, digest: Dict[str, Any]) -> None:
        """Install a replica's latest digest (replaces the previous
        one). Digests with a page size different from the fleet's are
        dropped — chained hashes only match at equal page size."""
        page = int(digest.get("page") or 0)
        if page <= 0:
            self.drop(name)
            return
        if self._page is None:
            self._page = page
        if page != self._page:
            self.drop(name)
            return
        self._entries[name] = set(digest.get("entries") or ())
        self._occupancy[name] = float(digest.get("occupancy") or 0.0)

    def drop(self, name: str) -> None:
        self._entries.pop(name, None)
        self._occupancy.pop(name, None)

    @property
    def page(self) -> Optional[int]:
        """Page size the indexed digests agree on (None until the first
        digest arrives)."""
        return self._page

    def match_depth(self, name: str, hashes: List[str]) -> int:
        """Deepest resident prefix of ``hashes`` on ``name``, in pages."""
        entries = self._entries.get(name)
        if not entries:
            return 0
        for depth in range(len(hashes), 0, -1):
            if hashes[depth - 1] in entries:
                return depth
        return 0

    def best(self, hashes: List[str],
             candidates: List[str]) -> Tuple[Optional[str], int]:
        """``(replica, depth)`` holding the deepest resident prefix among
        ``candidates`` — ``(None, 0)`` when nothing matches. Ties go to
        the replica with the lower cache occupancy (more headroom to
        keep the chain resident)."""
        best_name: Optional[str] = None
        best_depth = 0
        for name in candidates:
            depth = self.match_depth(name, hashes)
            if depth > best_depth or (
                    depth == best_depth and depth > 0
                    and self._occupancy.get(name, 1.0)
                    < self._occupancy.get(best_name, 1.0)):
                best_name, best_depth = name, depth
        return best_name, best_depth

    def stats(self) -> Dict[str, Any]:
        return {
            "page": self._page,
            "replicas": sorted(self._entries),
            "entries": {name: len(entries)
                        for name, entries in self._entries.items()},
        }


class FleetSession:
    """Client-facing token iterator that survives migration AND replica
    death (resumable decode).

    Wraps the router's :class:`_RelayStream`; when the fleet migrates
    the session, the source stream ends (the exporting engine closes its
    queue) and ``__anext__`` awaits the armed splice future for the
    target replica's relay instead of surfacing the end — the client
    sees one uninterrupted stream. The future is armed *before* the
    export starts, so a consumer racing the migration can never fall
    through the gap.

    When the relay *dies* instead (replica crash mid-decode, a migration
    leg failing after the source slot was retired), the session hands
    the failure to :meth:`FleetRouter._resume_session`, which rebuilds
    the request on a surviving replica from the original prompt plus
    every token already delivered — the continuation starts at exactly
    token index ``len(_emitted)``, so the client stream carries no
    duplicate and no missing token (and, under greedy sampling, is
    token-identical to an uninterrupted run)."""

    def __init__(self, router: "FleetRouter", relay: _RelayStream,
                 replica: Replica, stream,
                 request: Optional[Dict[str, Any]] = None) -> None:
        self._router = router
        self._relay = relay
        self._replica = replica
        self._stream = stream          # inner engine TokenStream
        self._next: Optional[asyncio.Future] = None
        self._request = request        # rebuild ctx for resume
        self._emitted: List[int] = []  # tokens the client has seen
        self.migrations = 0
        self.resumes = 0

    @property
    def replica_name(self) -> str:
        return self._replica.name

    @property
    def trace_id(self) -> Optional[str]:
        return self._relay.trace_id

    def __aiter__(self) -> "FleetSession":
        return self

    async def __anext__(self) -> int:
        while True:
            try:
                token = await self._relay.__anext__()
                # chaos site: a decode replica dying
                # mid-stream surfaces to the router as a relay failure
                # AFTER some tokens were delivered — the token fetched
                # above is lost with the replica, exactly like a real
                # crash between produce and deliver
                faults.active().raise_if("crash_mid_decode")
            except StopAsyncIteration:
                fut = self._next
                if fut is None:
                    self._router._unregister(self)
                    raise
                # migration in flight: the source stream just ended at
                # the export point — wait for the spliced continuation
                self._next = None
                try:
                    relay = await fut
                except BaseException as exc:
                    # migration failed after the source slot was retired
                    # (mid-migration crash): the session is still
                    # rebuildable from prompt + emitted tokens
                    relay = await self._router._resume_session(self, exc)
                    if relay is None:
                        self._router._unregister(self)
                        raise
                if relay is None:       # migration aborted; normal end
                    self._router._unregister(self)
                    raise
                self._relay = relay
                continue
            except asyncio.CancelledError:
                self._router._unregister(self)
                raise
            except BaseException as exc:
                relay = await self._router._resume_session(self, exc)
                if relay is None:
                    self._router._unregister(self)
                    raise
                self._relay = relay
                continue
            self._emitted.append(int(token))
            return int(token)

    def cancel(self) -> None:
        self._relay.cancel()
        self._router._unregister(self)

    async def aclose(self) -> None:
        self.cancel()


class FleetRouter(DisaggRouter):
    """Prefix-affinity front-end over the disaggregated router.

    ``refresh()`` pulls each decode replica's prefix digest (the same
    payload clusterz probes carry) into a :class:`FleetPrefixIndex`;
    ``_pick_decode`` routes to the replica with the deepest resident
    prefix and falls back to the registry's least-inflight pick;
    ``migrate_session``/``drain`` move live sessions between replicas
    with zero re-prefill."""

    def __init__(self, registry, logger=None, metrics=None, tracer=None,
                 digest_entries: int = 512):
        super().__init__(registry, logger=logger, metrics=metrics,
                         tracer=tracer)
        self.index = FleetPrefixIndex()
        self.digest_entries = int(digest_entries)
        # fleet series rollup: always created — replicas
        # without a telemetry store simply never feed it, and the
        # autoscaler falls back to the probe sweep while it is empty
        self.rollup = FleetSeriesRollup()
        # the example wiring attaches its Autoscaler here so clusterz
        # can fold its status into the fleet rollup
        self.autoscaler: Optional[Autoscaler] = None
        self._sessions: Dict[str, Set[FleetSession]] = {}
        self._route_affinity = 0
        self._route_fallback = 0
        self._migrations_ok = 0
        self._migrations_failed = 0
        # resumable decode: how many mid-stream failures were
        # healed by rebuilding the request on a surviving replica, and a
        # per-session cap so a poisoned request cannot hop forever
        self._resumes_ok = 0
        self._resumes_failed = 0
        self.resume_budget = 3

    # -- prefix index -------------------------------------------------------
    async def refresh(self) -> Dict[str, Any]:
        """One index refresh pass: probe every decode-serving replica's
        transport for its prefix digest. Unreachable replicas drop out
        of the index (they can still serve via the fallback path); this
        never raises — it is called from the clusterz handler and from
        cron."""
        for name in list(self.registry.replicas()):
            replica = self.registry._replicas.get(name)
            if replica is None or not replica.serves(ROLE_DECODE):
                continue
            observe = getattr(replica.transport, "observe", None)
            if observe is None or not replica.transport.available():
                self.index.drop(name)
                self.rollup.note_miss(name)
                continue
            try:
                obs = await observe()
            except Exception:
                self.index.drop(name)
                self.rollup.note_miss(name)
                continue
            digest = obs.get("prefix_digest") or \
                (obs.get("statusz") or {}).get("prefix_digest")
            if digest:
                self.index.update(name, digest)
            else:
                self.index.drop(name)
            # fleet series rollup: cursor-based telemetry
            # pull rides the same probe pass — bounded payload, and a
            # failed pull is a miss, never a refresh failure
            pull = getattr(replica.transport, "telemetry_delta", None)
            if pull is not None:
                try:
                    delta = await pull(self.rollup.cursor(name))
                except Exception:
                    delta = None
                if delta is not None:
                    self.rollup.ingest(name, delta)
                else:
                    self.rollup.note_miss(name)
        return self.index.stats()

    async def generate_stream(self, prompt_ids, max_new_tokens: int,
                              eos_id: Optional[int] = None,
                              sampling=None):
        """Cache-aware admission. The radix prefix cache only serves an
        engine's *local* admission path (``prefill_export``/``adopt_kv``
        bypass it on both sides), so an affinity hit routes the whole
        request to the holder's engine — its admission skips prefilling
        the resident prefix. A miss serves on the least-inflight in-proc
        replica (which *builds* residency for the next request); when no
        in-proc decode replica exists the disaggregated prefill→adopt
        path takes over unchanged."""
        replica, depth = self._route(prompt_ids)
        if replica is None:
            return await super().generate_stream(
                prompt_ids, max_new_tokens, eos_id=eos_id,
                sampling=sampling)
        engine = replica.transport.engine
        self.registry.note_start(replica)
        try:
            stream = await engine.generate_stream(
                prompt_ids, max_new_tokens, eos_id=eos_id,
                sampling=sampling)
        except BaseException:
            self.registry.note_end(replica)
            raise
        self._requests += 1
        relay = _RelayStream(stream, self.registry, replica)
        request = {
            "prompt_ids": [int(t) for t in prompt_ids],
            "max_new_tokens": int(max_new_tokens),
            "eos_id": eos_id,
            "sampling": sampling,
            "submitted_at": time.monotonic(),
            "trace_id": None,
        }
        return self._wrap_stream(relay, replica, stream, request)

    def _route(self, prompt_ids) -> Tuple[Optional[Replica], int]:
        """``(replica, matched_pages)`` for local serving, or
        ``(None, 0)`` to hand the request to the disagg path. Affinity
        wins when the index knows a READY in-proc replica holding a
        resident prefix of the prompt; otherwise the registry's
        least-inflight pick, kept only if it is in-proc."""
        candidates = [
            r for r in self.registry._replicas.values()
            if r.state == STATE_READY and r.serves(ROLE_DECODE)
            and r.transport.available()
            and getattr(r.transport, "engine", None) is not None]
        page = self.index.page
        if page and candidates:
            hashes = chain_hashes(prompt_ids, page)
            if hashes:
                name, depth = self.index.best(
                    hashes, [r.name for r in candidates])
                if name is not None and depth > 0:
                    self._route_affinity += 1
                    if self.metrics is not None:
                        self.metrics.increment_counter(
                            "app_tpu_fleet_route_total",
                            result="affinity")
                        self.metrics.record_histogram(
                            "app_tpu_fleet_affinity_pages", float(depth))
                    return self.registry._require(name), depth
        self._route_fallback += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_fleet_route_total", result="fallback")
        if not candidates:
            return None, 0
        try:
            picked = self.registry.pick(ROLE_DECODE)
        except NoReplicaAvailable:
            return None, 0
        if getattr(picked.transport, "engine", None) is None:
            # the least-inflight pick is remote: the disagg path owns it
            return None, 0
        return picked, 0

    # -- session registry ---------------------------------------------------
    def _wrap_stream(self, relay: _RelayStream, decoder: Replica,
                     stream, request: Optional[Dict[str, Any]] = None
                     ) -> FleetSession:
        session = FleetSession(self, relay, decoder, stream,
                               request=request)
        self._sessions.setdefault(decoder.name, set()).add(session)
        return session

    def _unregister(self, session: FleetSession) -> None:
        held = self._sessions.get(session._replica.name)
        if held is not None:
            held.discard(session)

    def sessions(self, name: str) -> List[FleetSession]:
        return list(self._sessions.get(name, ()))

    # -- resumable decode ---------------------------------------------------
    async def _resume_session(self, session: FleetSession,
                              exc: BaseException
                              ) -> Optional[_RelayStream]:
        """Heal a mid-stream replica failure: rebuild the request on a
        surviving in-proc decode replica from the original prompt plus
        every token the client already received, with the budget shrunk
        by the same count. The continuation starts at exactly the next
        token index — exactly-once delivery without any wire-level
        dedupe — and, under greedy sampling, is token-identical to an
        uninterrupted run (the new replica's prefill of prompt+emitted
        conditions it on the same committed sequence).

        Returns the spliced relay, or None when the failure must
        surface: no rebuild ctx, the per-session resume budget is spent,
        a migration owns the session's transition, or no healthy peer
        exists. Never called for client cancellation."""
        if isinstance(exc, (asyncio.CancelledError, StopAsyncIteration)):
            return None
        request = session._request
        if request is None or session._next is not None:
            self._note_resume("no_ctx")
            return None
        if session.resumes >= self.resume_budget:
            self._note_resume("budget")
            return None
        remaining = request["max_new_tokens"] - len(session._emitted)
        if remaining <= 0:
            self._note_resume("exhausted")
            return None
        dead = session._replica
        candidates = [
            r for r in self.registry._replicas.values()
            if r.name != dead.name and r.state == STATE_READY
            and r.serves(ROLE_DECODE) and r.transport.available()
            and getattr(r.transport, "engine", None) is not None]
        if not candidates:
            self._note_resume("no_replica")
            return None
        target = min(candidates, key=lambda r: r.inflight)
        # reclaim whatever the dead stream still holds (in-proc the
        # "crash" may leave the engine decoding into an abandoned
        # queue — cancel frees its slot and pages; a truly dead replica
        # ignores this)
        try:
            cancel = getattr(session._stream, "cancel", None)
            if cancel is not None:
                cancel()
        except Exception:   # noqa: BLE001 — the replica is already gone
            pass
        prompt = list(request["prompt_ids"]) + \
            [int(t) for t in session._emitted]
        engine = target.transport.engine
        self.registry.note_start(target)
        try:
            stream = await engine.generate_stream(
                prompt, remaining, eos_id=request.get("eos_id"),
                sampling=request.get("sampling"))
        except BaseException:
            self.registry.note_end(target)
            self._note_resume("error")
            return None
        session.resumes += 1
        relay = _RelayStream(stream, self.registry, target,
                             trace_id=session.trace_id)
        self._sessions.get(dead.name, set()).discard(session)
        session._replica = target
        session._stream = stream
        self._sessions.setdefault(target.name, set()).add(session)
        self._note_resume("ok")
        if self.logger is not None:
            self.logger.warn(
                "fleet: resumed session on %s after %r on %s "
                "(%d tokens already delivered, %d remaining)",
                target.name, exc, dead.name, len(session._emitted),
                remaining)
        return relay

    def _note_resume(self, result: str) -> None:
        if result == "ok":
            self._resumes_ok += 1
        else:
            self._resumes_failed += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_fleet_resume_total", result=result)

    # -- live migration -----------------------------------------------------
    async def migrate_session(self, session: FleetSession,
                              target_name: Optional[str] = None) -> str:
        """Move a live session to another decode replica with no
        client-visible gap and zero re-prefill. Arms the session's
        splice future, exports the slot from the (in-proc) source
        engine, ships the payload over the ``kv_wire`` chunk path, and
        adopts it on the target; the client's iterator continues on the
        target's stream, token-identically. Returns the target replica
        name; raises and surfaces the failure on the client stream if
        the adopt leg fails after the source was already retired."""
        source = session._replica
        engine = getattr(source.transport, "engine", None)
        if engine is None:
            raise ValueError(
                "live migration needs an in-proc source replica (the "
                "export runs inside the source engine)")
        if session._next is not None:
            raise RuntimeError("session already has a migration in flight")
        # resolve the target BEFORE the export: a bad explicit name or an
        # empty fleet must abort while the source slot is still live
        target = self._pick_target(source, target_name)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        session._next = fut            # armed BEFORE the export: no gap
        t0 = time.perf_counter()
        try:
            payload, state = await engine.export_session(session._stream)
        except BaseException:
            # source still live (export aborts restore the slot) or the
            # session finished on its own — either way, no splice
            session._next = None
            fut.set_result(None)
            self._note_migration("error")
            raise
        old_relay = session._relay
        try:
            # the wire leg: pack + bounded chunks, off-loop. In-proc the
            # chunks reassemble immediately; over HTTP/gRPC the same
            # chunking bounds each payload the transport ever holds.
            def ship() -> bytes:
                blob = kv_wire.pack(payload)
                return kv_wire.assemble(kv_wire.iter_chunks(blob))

            blob = await loop.run_in_executor(None, ship)
            # chaos site: the source slot is already retired,
            # the payload never reaches the target — the worst moment a
            # migration can die. Recovery is the session's resume path.
            faults.active().raise_if("crash_mid_migration")
            trace_id = session.trace_id
            traceparent = (f"00-{trace_id}-{os.urandom(8).hex()}-01"
                           if trace_id else None)
            # idempotent adopt: stable id per logical
            # transfer, so a transport retry after a lost response
            # cannot double-claim pages on the target
            dedupe = (f"{trace_id or os.urandom(8).hex()}"
                      f"-mig{session.migrations}")
            self.registry.note_start(target)
            try:
                stream = await target.transport.adopt_session(
                    blob, state, traceparent=traceparent,
                    transfer_s=time.perf_counter() - t0,
                    dedupe=dedupe)
            except BaseException:
                self.registry.note_end(target)
                raise
        except BaseException as exc:
            # the source slot is gone: the client cannot be handed back,
            # so the failure surfaces on the stream
            fut.set_exception(exc)
            self._note_migration("error")
            raise
        downtime = time.perf_counter() - t0
        relay = _RelayStream(stream, self.registry, target,
                             trace_id=session.trace_id)
        self._sessions.get(source.name, set()).discard(session)
        session._replica = target
        session._stream = stream
        session.migrations += 1
        self._sessions.setdefault(target.name, set()).add(session)
        fut.set_result(relay)
        # the source's remaining tokens are already queued client-side;
        # release its in-flight count now so drain is instant
        old_relay._finish()
        self._note_migration("ok", downtime, len(blob))
        if self.logger is not None:
            self.logger.info(
                "fleet: migrated session %s -> %s (%d pages, %.1fms)",
                source.name, target.name, payload.n_pages,
                downtime * 1e3)
        return target.name

    def _pick_target(self, source: Replica,
                     target_name: Optional[str]) -> Replica:
        if target_name is not None:
            target = self.registry._require(target_name)
            if target.name == source.name:
                raise ValueError("migration target equals the source")
            return target
        candidates = [
            r for r in self.registry._replicas.values()
            if r.name != source.name and r.state == STATE_READY
            and r.serves(ROLE_DECODE) and r.transport.available()]
        if not candidates:
            raise NoReplicaAvailable(ROLE_DECODE)
        return min(candidates, key=lambda r: r.inflight)

    def _note_migration(self, result: str, downtime_s: float = 0.0,
                        transfer_bytes: int = 0) -> None:
        if result == "ok":
            self._migrations_ok += 1
        else:
            self._migrations_failed += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_fleet_migrations_total", result=result)
            if result == "ok":
                self.metrics.record_histogram(
                    "app_tpu_fleet_migration_seconds", downtime_s)
                if transfer_bytes:
                    self.metrics.delta_updown_counter(
                        "app_tpu_kv_transfer_bytes_total",
                        float(transfer_bytes))

    async def drain(self, name: str, timeout_s: float = 30.0) -> bool:
        """Drain-by-migration: mark the replica DRAINING (the router
        stops picking it immediately), migrate every live session it
        holds to a peer, then hand off to the registry's drain wait for
        whatever remains (requests that finished mid-migration, the
        engine's own backlog). With a healthy peer available this
        returns in milliseconds instead of a decode-budget's worth of
        wall time."""
        replica = self.registry._require(name)
        self.registry._set_state(replica, STATE_DRAINING)
        failures = 0
        for session in self.sessions(name):
            try:
                await self.migrate_session(session)
            except Exception:
                failures += 1
                if self.logger is not None:
                    self.logger.exception(
                        "fleet: drain migration out of %r failed", name)
        drained = await self.registry.drain(name, timeout_s=timeout_s)
        return drained and failures == 0

    # -- observability ------------------------------------------------------
    def fleet_stats(self) -> Dict[str, Any]:
        """Rollup for clusterz: routing split, migration counters, index
        coverage, live sessions per replica."""
        return {
            "routing": {"affinity": self._route_affinity,
                        "fallback": self._route_fallback},
            "migrations": {"ok": self._migrations_ok,
                           "failed": self._migrations_failed},
            "resumes": {"ok": self._resumes_ok,
                        "failed": self._resumes_failed},
            "index": self.index.stats(),
            "sessions": {name: len(held)
                         for name, held in self._sessions.items()
                         if held},
        }


class GuardedActuator:
    """The guard stack every actuating control loop shares.

    Factored out of :class:`Autoscaler` so the operating-point
    auto-tuner (``tpu/autotune.py``) holds the *same* discipline a scale
    event does — a control loop that mutates serving state earns the
    right to act by passing four gates, not by being called:

    - **single-flight** (``busy``): the cron plane spawns every firing
      as its own task, so a firing that finds the previous step still
      running drops itself instead of stacking probes;
    - **hysteresis** (``observe`` + ``want_up``/``want_down``): an
      actuation needs ``up_after`` consecutive pressure readings (or
      ``down_after`` idle ones) — a single noisy sample never moves
      anything;
    - **cooldown** (``refusal`` → ``"cooldown"``): at least
      ``cooldown_s`` between events, measured from ``fired()``;
    - **compile guard** (``refusal`` → ``"compile_guard"``): while any
      serve-time compile landed inside ``compile_window_s`` on the
      attached ledger (anything with ``serving_compiles(window_s)`` —
      the executor's CompileLedger or the engine's own compile
      accounting), the loop holds rather than piling a state change
      onto a recompile storm.

    The owner keeps its own event ring / metrics / status rendering;
    this class owns only the decision state, so both owners' existing
    observable behavior (fleet tests, statusz payloads) is unchanged."""

    def __init__(self, up_after: int = 2, down_after: int = 3,
                 cooldown_s: float = 60.0,
                 compile_ledger=None, compile_window_s: float = 120.0):
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown_s = float(cooldown_s)
        self.compile_ledger = compile_ledger
        self.compile_window_s = float(compile_window_s)
        self.busy = False
        self.up_streak = 0
        self.down_streak = 0
        self.last_event_at: Optional[float] = None

    def observe(self, pressure: bool, idle: bool) -> None:
        """Advance the hysteresis streaks with one reading. A reading
        that is neither pressure nor idle resets both (mixed signals
        must not creep toward an actuation)."""
        if pressure:
            self.up_streak += 1
            self.down_streak = 0
        elif idle:
            self.down_streak += 1
            self.up_streak = 0
        else:
            self.up_streak = self.down_streak = 0

    def want_up(self) -> bool:
        return self.up_streak >= self.up_after

    def want_down(self) -> bool:
        return self.down_streak >= self.down_after

    def refusal(self, now: Optional[float] = None) -> Optional[str]:
        """The guard that refuses an otherwise-wanted actuation right
        now: ``"cooldown"``, ``"compile_guard"``, or None (clear)."""
        now = time.monotonic() if now is None else now
        if (self.last_event_at is not None
                and now - self.last_event_at < self.cooldown_s):
            return "cooldown"
        if self.compile_ledger is not None and \
                self.compile_ledger.serving_compiles(
                    self.compile_window_s) > 0:
            return "compile_guard"
        return None

    def fired(self, now: Optional[float] = None,
              direction: str = "up") -> None:
        """Record an actuation: starts the cooldown and resets the
        streak that earned it (the other streak is already zero)."""
        self.last_event_at = time.monotonic() if now is None else now
        if direction == "up":
            self.up_streak = 0
        else:
            self.down_streak = 0

    def status(self) -> Dict[str, Any]:
        return {
            "busy": self.busy,
            "streaks": {"up": self.up_streak, "down": self.down_streak},
            "cooldown_s": self.cooldown_s,
            "last_event_at": self.last_event_at,
        }


class Autoscaler:
    """Decode-pool autoscaler, shipped as a cron handler.

    Wire it with ``app.add_cron_job("* * * * *", "fleet-autoscale",
    autoscaler)``. Each firing gathers the fleet signals (admission
    queue depth and KV-pool occupancy from replica probes, the hbmz
    HBM-pressure fraction when a container is provided), applies
    hysteresis (``up_after``/``down_after`` consecutive pressure/idle
    readings), and calls the injected ``scale_up()`` /
    ``scale_down(name)`` callbacks — the operator owns what a "replica"
    is (spawn a process, resize a deployment, ...). Two guards keep
    scale events boring: a cooldown between events, and the compile
    ledger — while any serve-time compile landed inside
    ``compile_window_s`` the autoscaler holds, so a scale step can never
    pile onto a recompile storm.

    The handler is **single-flight**: the cron plane spawns every firing
    as its own task (overlap is possible by design), so a firing that
    finds the previous step still running returns immediately instead
    of stacking probes."""

    def __init__(self, registry,
                 scale_up: Callable[[], Any],
                 scale_down: Callable[[str], Any],
                 router: Optional[FleetRouter] = None,
                 metrics=None, logger=None, container=None,
                 compile_ledger=None,
                 min_decode: int = 1, max_decode: int = 4,
                 queue_high: int = 8, queue_low: int = 1,
                 hbm_high: float = 0.85,
                 up_after: int = 2, down_after: int = 3,
                 cooldown_s: float = 60.0,
                 compile_window_s: float = 120.0,
                 signals_fn: Optional[Callable[[], Any]] = None):
        if min_decode < 1:
            raise ValueError("min_decode must be >= 1")
        if max_decode < min_decode:
            raise ValueError("max_decode must be >= min_decode")
        self.registry = registry
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.router = router
        self.metrics = metrics
        self.logger = logger
        self.container = container
        self.compile_ledger = compile_ledger
        self.min_decode = int(min_decode)
        self.max_decode = int(max_decode)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.hbm_high = float(hbm_high)
        # the shared guard stack (single-flight, hysteresis streaks,
        # cooldown, compile guard) — the same helper the operating-point
        # auto-tuner actuates through
        self.guard = GuardedActuator(
            up_after=up_after, down_after=down_after,
            cooldown_s=cooldown_s, compile_ledger=compile_ledger,
            compile_window_s=compile_window_s)
        self._signals_fn = signals_fn
        self._events: List[Dict[str, Any]] = []

    # -- guard state passthrough (pre-GuardedActuator attribute surface) ----
    @property
    def up_after(self) -> int:
        return self.guard.up_after

    @property
    def down_after(self) -> int:
        return self.guard.down_after

    @property
    def cooldown_s(self) -> float:
        return self.guard.cooldown_s

    @property
    def compile_window_s(self) -> float:
        return self.guard.compile_window_s

    @property
    def _busy(self) -> bool:
        return self.guard.busy

    @_busy.setter
    def _busy(self, value: bool) -> None:
        self.guard.busy = bool(value)

    @property
    def _up_streak(self) -> int:
        return self.guard.up_streak

    @property
    def _down_streak(self) -> int:
        return self.guard.down_streak

    @property
    def _last_event_at(self) -> Optional[float]:
        return self.guard.last_event_at

    async def __call__(self, ctx=None) -> Dict[str, Any]:
        if self._busy:
            # overlap guard: the previous firing's probes are still in
            # flight — this firing is a no-op, not a queued duplicate
            return self._note("overlap", {})
        self._busy = True
        try:
            return await self._step()
        finally:
            self._busy = False

    async def _step(self) -> Dict[str, Any]:
        signals = await self._gather()
        n = signals["decode_replicas"]
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_fleet_decode_replicas",
                                   float(n))
        pressure = (signals["queue_depth"] >= self.queue_high
                    or (signals["hbm"] is not None
                        and signals["hbm"] >= self.hbm_high)
                    or (signals["occupancy"] is not None
                        and signals["occupancy"] >= self.hbm_high))
        idle = (signals["queue_depth"] <= self.queue_low
                and (signals["occupancy"] is None
                     or signals["occupancy"] < self.hbm_high / 2))
        self.guard.observe(pressure, idle)
        want_up = self.guard.want_up() and n < self.max_decode
        want_down = self.guard.want_down() and n > self.min_decode
        if not want_up and not want_down:
            return self._note("hold", signals)
        now = time.monotonic()
        # cooldown, then the compile ledger: a serve-time compile landed
        # recently → adding or removing a replica now would shift batch
        # shapes while the ledger is already hot, so hold until quiet
        refusal = self.guard.refusal(now)
        if refusal is not None:
            return self._note(refusal, signals)
        if want_up:
            result = self.scale_up()
            if asyncio.iscoroutine(result):
                await result
            self.guard.fired(now, "up")
            return self._note("up", signals)
        victim = self._pick_victim()
        if victim is None:
            return self._note("hold", signals)
        result = self.scale_down(victim)
        if asyncio.iscoroutine(result):
            await result
        self.guard.fired(now, "down")
        return self._note("down", signals, victim=victim)

    async def _gather(self) -> Dict[str, Any]:
        """Fleet signal snapshot. ``signals_fn`` (tests, exotic
        topologies) overrides everything; otherwise the router's series
        rollup (30s window means) is preferred when fresh —
        window means decay a dead probe's contribution instead of
        zeroing it, which is what used to flap the scaler — with the
        instantaneous probe sweep as the fallback."""
        if self._signals_fn is not None:
            out = self._signals_fn()
            if asyncio.iscoroutine(out):
                out = await out
            return {"queue_depth": int(out.get("queue_depth", 0)),
                    "occupancy": out.get("occupancy"),
                    "hbm": out.get("hbm"),
                    "decode_replicas": int(out.get("decode_replicas", 0))}
        decode = sum(
            1 for replica in self.registry._replicas.values()
            if replica.serves(ROLE_DECODE)
            and replica.state == STATE_READY)
        hbm: Optional[float] = None
        if self.container is not None:
            hbm = hbm_occupancy(self.container)
        rollup = getattr(self.router, "rollup", None) \
            if self.router is not None else None
        if rollup is not None and rollup.fresh():
            means = rollup.signals()
            if means["queue_depth"] is not None:
                return {"queue_depth": int(round(means["queue_depth"])),
                        "occupancy": means["occupancy"],
                        "hbm": hbm, "decode_replicas": decode,
                        "source": "rollup"}
        queue_depth = 0
        occupancy: Optional[float] = None
        for name in self.registry.replicas():
            replica = self.registry._replicas[name]
            if not replica.serves(ROLE_DECODE) or \
                    replica.state != STATE_READY:
                continue
            observe = getattr(replica.transport, "observe", None)
            if observe is None:
                continue
            try:
                obs = await observe()
            except Exception:
                continue
            stats = obs.get("stats") or \
                (obs.get("statusz") or {}).get("engine") or {}
            queue_depth += int(stats.get("queue_depth") or 0)
            pool = stats.get("kv_pool") or {}
            if "occupancy" in pool:
                occ = float(pool["occupancy"])
                occupancy = occ if occupancy is None \
                    else max(occupancy, occ)
        return {"queue_depth": queue_depth, "occupancy": occupancy,
                "hbm": hbm, "decode_replicas": decode,
                "source": "probe"}

    def _pick_victim(self) -> Optional[str]:
        """Least-loaded READY decode replica (the cheapest to drain by
        migration)."""
        candidates = [
            r for r in self.registry._replicas.values()
            if r.state == STATE_READY and r.serves(ROLE_DECODE)]
        if len(candidates) <= self.min_decode:
            return None
        return min(candidates, key=lambda r: r.inflight).name

    def _note(self, result: str,
              signals: Dict[str, Any], **extra) -> Dict[str, Any]:
        event = {"result": result, "at": time.monotonic(), **extra}
        if signals:
            event["signals"] = signals
        self._events.append(event)
        del self._events[:-64]
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_fleet_autoscale_total", result=result)
        if self.logger is not None and result in ("up", "down"):
            self.logger.info("fleet autoscaler: %s %s", result,
                             extra or "")
        return event

    def status(self) -> Dict[str, Any]:
        """Rollup for clusterz/statusz: streaks, last decision, bounds."""
        return {
            "busy": self._busy,
            "bounds": {"min": self.min_decode, "max": self.max_decode},
            "streaks": {"up": self._up_streak,
                        "down": self._down_streak},
            "cooldown_s": self.cooldown_s,
            "last_event_at": self._last_event_at,
            "recent": self._events[-8:],
        }

"""Bounded retry with jittered backoff, deadlines, and hedging (a copy of
``gofr_tpu/tpu/retry.py``: the same schedule, and the same backoffs from
the same ``random`` seed).

Every retry loop in the serving path runs through ``RetryPolicy`` so the
bound is structural, not conventional: attempts are a ``for`` loop over a
fixed budget, each sleep is exponential
with full jitter, and an optional wall-clock deadline cuts the loop even
when attempts remain. ``hedged`` races a second attempt against a slow
first one — deadline-aware tail-latency insurance for idempotent legs
(prefill dispatch, KV chunk fetch). Non-idempotent legs (session adopts)
must NOT use blind retry; they go through the engine's adopt dedupe
ledger so a replayed adopt returns the prior stream instead of
double-refcounting pages.

Knobs (see docs/references/configs.md): ``DISAGG_RETRY_ATTEMPTS``,
``DISAGG_RETRY_BASE_MS``, ``DISAGG_RETRY_DEADLINE_MS``,
``DISAGG_HEDGE_AFTER_MS``.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Any, Awaitable, Callable, Optional, Tuple

__all__ = ["RetryBudgetExceeded", "RetryPolicy", "new_retry_policy"]


class RetryBudgetExceeded(RuntimeError):
    """All attempts failed (or the deadline lapsed); carries the last
    underlying error as ``__cause__``."""


class RetryPolicy:
    """Immutable retry/hedge schedule shared by the dispatch legs.

    ``attempts`` is the total try count (1 = no retry). Backoff before
    attempt *k* (k >= 2) is ``base_s * multiplier**(k-2)`` scaled by full
    jitter in [jitter, 1]; ``deadline_s`` bounds the whole call chain
    from first attempt, and ``hedge_after_s`` is how long ``hedged``
    waits on the primary before launching the backup.
    """

    def __init__(self, attempts: int = 3, base_s: float = 0.05,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 deadline_s: Optional[float] = None,
                 hedge_after_s: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.attempts = max(1, int(attempts))
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self.deadline_s = deadline_s
        self.hedge_after_s = hedge_after_s
        self._rng = rng or random.Random()

    def backoff_s(self, attempt: int) -> float:
        """Sleep before ``attempt`` (2-based; attempt 1 never waits)."""
        if attempt <= 1:
            return 0.0
        raw = self.base_s * (self.multiplier ** (attempt - 2))
        scale = self.jitter + (1.0 - self.jitter) * self._rng.random()
        return raw * scale

    async def run(self, fn: Callable[[int], Awaitable[Any]], *,
                  retryable: Callable[[BaseException], bool] = None,
                  on_retry: Callable[[int, BaseException], None] = None):
        """Run ``fn(attempt)`` until success, budget, or deadline.

        ``retryable`` gates which errors are worth another attempt
        (default: any Exception); ``on_retry`` observes each failed
        attempt (metrics). Raises RetryBudgetExceeded from the last
        error once the budget or deadline is spent.
        """
        start = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            wait = self.backoff_s(attempt)
            if wait > 0.0:
                if (self.deadline_s is not None
                        and time.monotonic() - start + wait > self.deadline_s):
                    break
                await asyncio.sleep(wait)
            try:
                return await fn(attempt)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if retryable is not None and not retryable(exc):
                    raise
                last = exc
                if on_retry is not None:
                    on_retry(attempt, exc)
                if (self.deadline_s is not None
                        and time.monotonic() - start >= self.deadline_s):
                    break
        raise RetryBudgetExceeded(
            f"retry budget exhausted after {self.attempts} attempts"
        ) from last

    async def hedged(self, primary: Callable[[], Awaitable[Any]],
                     backup: Optional[Callable[[], Awaitable[Any]]] = None,
                     ) -> Tuple[Any, bool]:
        """Race ``backup`` against a slow ``primary``; first success wins.

        Returns ``(result, hedged)`` where ``hedged`` says the backup
        won. With no backup, or hedging disabled, this is just
        ``await primary()``. The loser is cancelled — both callables
        must be idempotent (the whole point of restricting hedging to
        prefill/fetch legs).
        """
        if backup is None or self.hedge_after_s is None:
            return await primary(), False
        # every exit path below awaits or cancels this task (wait_for /
        # shield, asyncio.wait, survivor await), so its exception cannot
        # escape silently
        first = asyncio.ensure_future(primary())
        try:
            return await asyncio.wait_for(
                asyncio.shield(first), self.hedge_after_s), False
        except asyncio.TimeoutError:
            pass
        except Exception:
            first.cancel()
            raise
        # raced against ``first`` via asyncio.wait below; the loser is
        # cancelled, the winner awaited
        second = asyncio.ensure_future(backup())
        done, _ = await asyncio.wait(
            {first, second}, return_when=asyncio.FIRST_COMPLETED)
        # prefer a finished success; if the finisher failed, wait out
        # the survivor before giving up
        for task in done:
            if task.exception() is None:
                for other in (first, second):
                    if other is not task:
                        other.cancel()
                return task.result(), task is second
        survivor = second if first in done else first
        try:
            return await survivor, survivor is second
        except Exception:
            # both legs failed — surface the primary's error
            if first.done() and first.exception() is not None:
                raise first.exception() from None
            raise


def new_retry_policy(config: Any) -> RetryPolicy:
    """Config-driven factory (DISAGG_RETRY_* / DISAGG_HEDGE_AFTER_MS).

    ``DISAGG_RETRY_ATTEMPTS=1`` disables retry; ``DISAGG_HEDGE_AFTER_MS``
    unset (0) disables hedging; ``DISAGG_RETRY_DEADLINE_MS`` unset (0)
    means attempts alone bound the loop.
    """
    attempts = int(config.get_float("DISAGG_RETRY_ATTEMPTS", 3))
    base_ms = config.get_float("DISAGG_RETRY_BASE_MS", 50.0)
    deadline_ms = config.get_float("DISAGG_RETRY_DEADLINE_MS", 0.0)
    hedge_ms = config.get_float("DISAGG_HEDGE_AFTER_MS", 0.0)
    return RetryPolicy(
        attempts=attempts,
        base_s=base_ms / 1000.0,
        deadline_s=(deadline_ms / 1000.0) if deadline_ms > 0 else None,
        hedge_after_s=(hedge_ms / 1000.0) if hedge_ms > 0 else None,
    )

"""Continuous-batching generation engine for the Llama ``/generate`` path,
paged KV (counterpart of ``gofr_tpu/tpu/generate.py``, its paged main
path).

- One :class:`~gofr_tpu_torch.tpu.page_pool.PagePool` holds every KV byte;
  each slot addresses its pages through a host page-table row, uploaded
  to the device when it changes.
- A new request claims a free slot. Admissions are batched: requests
  pending at the top of a loop pass prefill together, grouped by prompt
  bucket, the count padded to a ladder (1, 2, 4, ..., max_slots) and the
  prompts right-padded to the bucket. Prefill (flash-attention kernel on
  the card) fills a small dense cache that one in-place insert scatters
  into freshly allocated pool pages; the first token is sampled inside
  the prefill step.
- A decode tick advances every active slot K steps (K from the ladder
  1, 2, 4, ... <= ``steps_per_tick``, never past the smallest remaining
  budget, and 1 while a pending request could be admitted); each step
  runs ``llama.decode_step_paged`` (ragged paged decode kernel on the
  card) and samples per slot. Inactive slots are frozen (cache_len does
  not advance) and never write the pool.
- ``cfg.kv_int8`` makes the pool int8 with float32 scale planes: the
  insert scatters the quantised prefill rows and scales, and decode and
  verify read them through the ragged kernel's int8 instantiation.
- Speculative decode (``draft_cfg``/``draft_params``): a draft model with
  a dense per-slot cache (flash-decode kernel on the card) proposes g
  tokens in g + 1 steps, the target scores all g + 1 positions in one
  ``llama.verify_step_paged`` (ragged verify kernel on the card), and
  ``speculative_accept`` commits 1 to g + 1 tokens per slot. g walks the
  ladder 1, 2, 4, ... plus ``spec_gamma``, never past the smallest
  remaining budget (g + 1 <= min_wanted) nor the adaptive cap, which
  halves or doubles on the acceptance of every 16 spec ticks. Plain
  ticks serve the last token of a budget and any tick with an admission
  waiting.
- Ticks are synchronous: one host fetch of the tick's tokens. Device work
  runs in a worker thread so the event loop keeps serving callers
  meanwhile.
- Tokens stream: ``generate_stream`` yields ids as each tick's fetch
  lands; ``generate`` gathers them.

Left for later slices (see ROADMAP.md): the dense cache, prefix cache,
disaggregation, grammar-constrained decoding, brownout, auto-tuning,
upload coalescing, mesh sharding, the SLO / metrics / flight-recorder
hooks, the attention-window ladder and the M-deep pipelined tick.
"""

from __future__ import annotations

import asyncio
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.sampling import (filtered_log_probs_batch,
                                         sample_batch, sampled_rows,
                                         speculative_accept)
from gofr_tpu_torch.tpu.page_pool import PagePool

DEFAULT_PROMPT_BUCKETS = (32, 128, 512)

# adaptive-γ controller (speculative decode): windowed acceptance is
# evaluated every N spec ticks; below the shrink threshold the γ cap
# halves (a diverging draft wastes the verify forward), above the grow
# threshold it doubles back toward spec_gamma
_SPEC_WINDOW_TICKS = 16
_SPEC_SHRINK_BELOW = 0.5
_SPEC_GROW_ABOVE = 0.8

# sentinel pushed onto a streaming queue when the request completes
_DONE = object()


class Sampling:
    """Per-request sampling parameters. ``temperature <= 0`` is greedy;
    ``top_k == 0`` and ``top_p >= 1`` disable their filters. ``seed=None``
    draws fresh entropy; pass a seed for a reproducible completion."""
    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = (int(seed) if seed is not None
                     else int.from_bytes(os.urandom(4), "little"))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class TokenStream:
    """Async iterator over one request's generated tokens. ``cancel()``
    (or ``aclose()``) abandons the request and frees its slot, whether or
    not iteration ever started."""

    __slots__ = ("_engine", "_queue", "_future", "_done")

    def __init__(self, engine: "GenerationEngine", queue: asyncio.Queue,
                 future: asyncio.Future):
        self._engine = engine
        self._queue = queue
        self._future = future
        self._done = False

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._done:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _DONE:
            self._finish()
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self._finish()
            raise item
        return item

    def _finish(self) -> None:
        self._done = True
        # keep an engine failure from surfacing as "exception was never
        # retrieved" on the paired future
        if not self._future.done():
            self._future.cancel()
        elif not self._future.cancelled():
            self._future.exception()

    def cancel(self) -> None:
        """Abandon the request: free its slot (or unqueue it)."""
        if not self._done:
            self._engine._cancel_stream(self._queue)
            self._finish()

    async def aclose(self) -> None:
        self.cancel()


class _Request:
    __slots__ = ("prompt", "bucket", "budget", "eos_id", "sampling",
                 "future", "queue", "submitted_at")

    def __init__(self, prompt, bucket, budget, eos_id, sampling, future,
                 queue):
        self.prompt = prompt
        self.bucket = bucket
        self.budget = budget
        self.eos_id = eos_id
        self.sampling = sampling
        self.future = future
        self.queue = queue
        self.submitted_at = time.monotonic()


class _Slot:
    __slots__ = ("future", "remaining", "eos_id", "tokens", "active", "gen",
                 "inflight", "queue", "temperature", "fill", "submitted_at",
                 "pages", "generator")

    def __init__(self):
        self.future: Optional[asyncio.Future] = None
        self.remaining = 0
        self.eos_id: Optional[int] = None
        self.tokens: List[int] = []
        self.active = False
        self.gen = 0          # bumped on claim: stale tick tokens are dropped
        self.inflight = 0     # tokens dispatched on device, not yet published
        self.queue: Optional[asyncio.Queue] = None
        self.temperature = 0.0
        self.fill = 0         # host mirror of the device cache_len
        self.submitted_at = 0.0
        self.pages: List[int] = []   # pool pages this slot owns
        self.generator: Optional[torch.Generator] = None  # sampled rows


def _params_to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {key: _params_to(val, device) for key, val in params.items()}
    return params.to(device)


class GenerationEngine:
    def __init__(self, cfg, params, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets=DEFAULT_PROMPT_BUCKETS,
                 steps_per_tick: int = 1,
                 kv_page: int = 32,
                 kv_pages: Optional[int] = None,
                 kv_page_reserve: Optional[int] = None,
                 draft_cfg=None, draft_params=None,
                 spec_gamma: int = 4,
                 device: Union[str, torch.device] = "cuda",
                 logger=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.max_len)
        if not self.prompt_buckets:
            raise ValueError("no prompt bucket fits max_len")
        # fused-steps ladder 1, 2, 4, ... <= steps_per_tick
        self.steps_per_tick = max(1, int(steps_per_tick))
        self._k_ladder = [1]
        while self._k_ladder[-1] * 2 <= self.steps_per_tick:
            self._k_ladder.append(self._k_ladder[-1] * 2)
        # admission-count ladder 1, 2, 4, ... with max_slots the top rung
        self._n_ladder = [1]
        while self._n_ladder[-1] * 2 <= self.max_slots:
            self._n_ladder.append(self._n_ladder[-1] * 2)
        if self._n_ladder[-1] != self.max_slots:
            self._n_ladder.append(self.max_slots)
        self.kv_page = int(kv_page)
        if self.max_len % self.kv_page:
            raise ValueError(f"max_len {self.max_len} must be a multiple of "
                             f"kv_page {self.kv_page}")
        bad = [b for b in self.prompt_buckets if b % self.kv_page]
        if bad:
            raise ValueError(f"prompt buckets {bad} are not multiples of "
                             f"kv_page {self.kv_page}")
        self.logger = logger
        self.params = _params_to(params, self.device)
        self.pages_per_slot = self.max_len // self.kv_page
        self._pool = PagePool(
            cfg, page=self.kv_page,
            num_pages=(int(kv_pages) if kv_pages is not None
                       else self.max_slots * self.pages_per_slot),
            device=self.device)
        # pages admission must leave free for decode growth of running slots
        self._kv_reserve = (int(kv_page_reserve)
                            if kv_page_reserve is not None
                            else min(self.max_slots,
                                     self._pool.num_pages // 8))
        # host master copy of the page table; the device copy is rebuilt
        # when the version moves
        self._table = np.full((self.max_slots, self.pages_per_slot),
                              self._pool.sentinel, np.int32)
        self._table_version = 0
        self._table_cache: Optional[Tuple[int, torch.Tensor]] = None
        self._reset_slot_tensors()

        # -- speculative draft-verify decode ---------------------------------
        self.spec = draft_cfg is not None and draft_params is not None
        self.spec_gamma = max(1, int(spec_gamma))
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self._draft_cache: Optional[Dict[str, torch.Tensor]] = None
        self._g_ladder: List[int] = []
        if self.spec:
            if getattr(draft_cfg, "vocab_size", None) != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({getattr(draft_cfg, 'vocab_size', None)} vs "
                    f"{cfg.vocab_size})")
            if getattr(draft_cfg, "kv_int8", False):
                raise ValueError(
                    "the draft's dense cache is bf16 only (flash decode "
                    "reads a bf16 cache): build draft_cfg without kv_int8")
            self.draft_params = _params_to(draft_params, self.device)
            # the draft cache is dense: the draft is small, and one
            # (max_slots, max_len) row per slot keeps it independent of
            # the target's paging; the draft prefills the full prompt, so
            # it shares the target's cache_len
            self._draft_cache = llama.init_cache(draft_cfg, self.max_slots,
                                                 self.max_len,
                                                 device=self.device)
            self._g_ladder = [1]
            while self._g_ladder[-1] * 2 <= self.spec_gamma:
                self._g_ladder.append(self._g_ladder[-1] * 2)
            if self._g_ladder[-1] != self.spec_gamma:
                self._g_ladder.append(self.spec_gamma)
        self._gamma_cap = self.spec_gamma if self.spec else 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_window_proposed = 0
        self._spec_window_accepted = 0

        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._free: List[int] = list(range(self.max_slots))
        self._pending: "deque[_Request]" = deque()
        self._cancelled_queues: set = set()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        # run counters: what the kernels' launch counts are checked against
        self.prefill_dispatches = 0
        self.decode_steps = 0         # plain decode steps (ragged decode)
        self.ticks = 0                # plain decode ticks
        self.spec_rungs: Dict[int, int] = {}  # spec ticks run, by g
        self.draft_steps = 0          # Σ(g + 1) draft steps (flash decode)
        self.ttfts: "deque[float]" = deque(maxlen=4096)  # submit → 1st token

    def _reset_slot_tensors(self) -> None:
        dev, n = self.device, self.max_slots
        self.cache_len = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.last_token = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.top_ps = torch.ones((n,), dtype=torch.float32, device=dev)

    # -- device steps --------------------------------------------------------
    def _prefill_insert(self, nb: int, bucket: int, padded: np.ndarray,
                        lengths: np.ndarray, slots: np.ndarray,
                        temps: np.ndarray, top_ks: np.ndarray,
                        top_ps: np.ndarray, gens: List, flat_ids: np.ndarray
                        ) -> np.ndarray:
        """Batched prompt forward for ``nb`` rows of bucket ``bucket``, its
        in-place insert into the pool pages ``flat_ids`` (row-major (nb,
        bucket // page); sentinel entries are skipped), with a draft its
        KV-only prefill into the claimed slots' dense draft rows, and the
        claimed slots' device rows. Returns the first tokens (nb,) on the
        host. Padding rows carry slot ``max_slots`` and are skipped."""
        dev, cfg, page = self.device, self.cfg, self.kv_page
        tokens = torch.as_tensor(padded, device=dev).long()
        lens = torch.as_tensor(lengths, device=dev)
        t_temps = torch.as_tensor(temps, device=dev)
        t_top_ks = torch.as_tensor(top_ks, device=dev)
        t_top_ps = torch.as_tensor(top_ps, device=dev)
        small = llama.init_cache(cfg, nb, bucket, device=dev)
        logits, small, _ = llama.prefill(self.params, cfg, tokens, small,
                                         lengths=lens)
        first = sample_batch(logits, t_temps, t_top_ks, t_top_ps, gens)
        # in-place scatter of the group's KV pages into the pool; each
        # leaf (k/v rows, int8 scale planes) keeps its own trailing shape
        live = np.nonzero(flat_ids != self._pool.sentinel)[0]
        src = torch.as_tensor(live, device=dev)
        dst = torch.as_tensor(flat_ids[live].astype(np.int64), device=dev)
        for name, leaf in self._pool.leaves.items():
            chunks = small[name].reshape(cfg.n_layers, nb * (bucket // page),
                                         page, *small[name].shape[3:])
            leaf[:, dst] = chunks[:, src]
        self._pool.note_writes(len(live))
        rows = np.nonzero(slots < self.max_slots)[0]
        row_t = torch.as_tensor(rows, device=dev)
        slot_t = torch.as_tensor(slots[rows].astype(np.int64), device=dev)
        if self.spec:
            # KV-only draft prefill over the same bucket; its rows land in
            # the claimed slots' dense draft rows (padding rows dropped)
            dcfg = self.draft_cfg
            dsmall = llama.init_cache(dcfg, nb, bucket, device=dev)
            llama.prefill(self.draft_params, dcfg, tokens, dsmall,
                          lengths=lens)
            for name, leaf in self._draft_cache.items():
                leaf[:, slot_t, :bucket] = dsmall[name][:, row_t]
        self.cache_len[slot_t] = lens[row_t].to(torch.int32)
        self.last_token[slot_t] = first[row_t]
        self.temps[slot_t] = t_temps[row_t]
        self.top_ks[slot_t] = t_top_ks[row_t]
        self.top_ps[slot_t] = t_top_ps[row_t]
        return first.cpu().numpy()

    def _decode_tick(self, k: int, active: torch.Tensor, table: torch.Tensor,
                     gens: List) -> np.ndarray:
        """``k`` paged decode steps over every slot; inactive rows keep
        their cache_len and token. Returns the (k, max_slots) tokens on
        the host: the tick's one fetch."""
        token, cache_len = self.last_token, self.cache_len
        steps = []
        for _ in range(k):
            logits, _, new_len = llama.decode_step_paged(
                self.params, self.cfg, token, self._pool.leaves, table,
                cache_len, active)
            nxt = sample_batch(logits, self.temps, self.top_ks, self.top_ps,
                               gens)
            cache_len = torch.where(active, new_len, cache_len)
            token = torch.where(active, nxt, token)
            steps.append(token)
        self.cache_len, self.last_token = cache_len, token
        return torch.stack(steps).cpu().numpy()

    def _spec_tick(self, g: int, active: torch.Tensor, table: torch.Tensor,
                   gens: List) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative tick at rung ``g``: the draft runs g + 1 dense
        decode steps proposing g tokens (the extra step writes the last
        proposal's KV, so a full acceptance leaves the draft cache
        covering every committed position), the target verifies all
        g + 1 positions in one paged forward, and ``speculative_accept``
        commits ``accepts + 1`` tokens per active row. Inactive rows keep
        their cache_len and token. Returns ((g + 1, max_slots) tokens,
        (max_slots,) accept counts) on the host, from the tick's one
        fetch."""
        last, cache_len = self.last_token, self.cache_len
        sampled = bool(sampled_rows(gens))
        token, dlen = last, cache_len
        proposals, q_logps = [], []
        for _ in range(g + 1):
            logits, _, new_len = llama.decode_step(
                self.draft_params, self.draft_cfg, token, self._draft_cache,
                dlen)
            q_logp = (filtered_log_probs_batch(logits, self.temps,
                                               self.top_ks, self.top_ps)
                      if sampled else None)
            proposal = sample_batch(logits, self.temps, self.top_ks,
                                    self.top_ps, gens, logp=q_logp)
            dlen = torch.where(active, new_len, dlen)
            token = torch.where(active, proposal, token)
            proposals.append(token)
            q_logps.append(q_logp)
        draft_tokens = torch.stack(proposals[:g], dim=1)          # (B, g)
        q_logp = torch.stack(q_logps[:g], dim=1) if sampled else None
        verify_tokens = torch.cat([last[:, None], draft_tokens], dim=1)
        t_logits, _ = llama.verify_step_paged(
            self.params, self.cfg, verify_tokens, self._pool.leaves, table,
            cache_len, active)
        out, accepts = speculative_accept(t_logits, q_logp, draft_tokens,
                                          self.temps, self.top_ks,
                                          self.top_ps, gens)
        accepts = torch.where(active, accepts, 0)
        chosen = out.gather(1, accepts[:, None])[:, 0]
        self.last_token = torch.where(active, chosen, last)
        self.cache_len = torch.where(active, cache_len + accepts + 1,
                                     cache_len).to(torch.int32)
        host = torch.cat([out.T, accepts[None].to(out.dtype)]).cpu().numpy()
        return host[:g + 1], host[g + 1]

    def _table_dev(self) -> torch.Tensor:
        cached = self._table_cache
        if cached is not None and cached[0] == self._table_version:
            return cached[1]
        dev = torch.as_tensor(self._table, device=self.device).clone()
        self._table_cache = (self._table_version, dev)
        return dev

    # -- lifecycle -------------------------------------------------------------
    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _validate(self, prompt_ids, max_new_tokens: int
                  ) -> Tuple[List[int], int]:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bucket = next((b for b in self.prompt_buckets if b >= len(prompt)),
                      None)
        if bucket is None:
            raise ValueError(f"prompt length {len(prompt)} exceeds largest "
                             f"bucket {self.prompt_buckets[-1]}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds cache length")
        return prompt, bucket

    def _submit(self, prompt_ids, max_new_tokens, eos_id, sampling,
                queue) -> asyncio.Future:
        prompt, bucket = self._validate(prompt_ids, max_new_tokens)
        future = asyncio.get_running_loop().create_future()
        self._pending.append(_Request(prompt, bucket, max_new_tokens, eos_id,
                                      sampling or Sampling(), future, queue))
        self._wake.set()
        return future

    async def generate(self, prompt_ids, max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling: Optional[Sampling] = None) -> List[int]:
        """Generate up to ``max_new_tokens`` ids (stops early on
        ``eos_id``). Concurrent callers share decode steps."""
        return await self._submit(prompt_ids, max_new_tokens, eos_id,
                                  sampling, None)

    async def generate_stream(self, prompt_ids, max_new_tokens: int,
                              eos_id: Optional[int] = None,
                              sampling: Optional[Sampling] = None
                              ) -> TokenStream:
        """A :class:`TokenStream` yielding ids as they are produced.
        Validation happens here, so a bad request raises before any token
        is streamed."""
        queue: asyncio.Queue = asyncio.Queue()
        future = self._submit(prompt_ids, max_new_tokens, eos_id, sampling,
                              queue)
        return TokenStream(self, queue, future)

    def _cancel_stream(self, queue: asyncio.Queue) -> None:
        """Abandon the request bound to ``queue``: free its slot (stale
        in-flight tokens are dropped by the generation counter) or, if it
        is not admitted yet, mark it so admission skips it."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.queue is queue:
                slot.queue = None
                if slot.future is not None and not slot.future.done():
                    slot.future.cancel()
                self._finish_slot(slot_idx, slot)
                return
        self._cancelled_queues.add(queue)

    @property
    def spec_dispatches(self) -> int:
        """Spec ticks run (each verifies once through every target
        layer)."""
        return sum(self.spec_rungs.values())

    @property
    def active_slots(self) -> int:
        return sum(1 for slot in self._slots if slot.active)

    def stats(self) -> Dict[str, Any]:
        out = {
            "device": str(self.device),
            "active_slots": self.active_slots,
            "pending": len(self._pending),
            "prefill_dispatches": self.prefill_dispatches,
            "decode_steps": self.decode_steps,
            "ticks": self.ticks,
            "kv_pool": self._pool.stats(),
        }
        if self.spec:
            out["speculative"] = {
                "gamma": self.spec_gamma,
                "gamma_cap": self._gamma_cap,
                "gamma_ladder": list(self._g_ladder),
                "spec_ticks": self.spec_dispatches,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance_rate": (self._spec_accepted / self._spec_proposed
                                    if self._spec_proposed else 0.0),
                "draft_steps": self.draft_steps,
                "ticks_by_gamma": dict(sorted(self.spec_rungs.items())),
            }
        return out

    # -- the loop ----------------------------------------------------------------
    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                await self._loop_body(loop)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — the engine must not
                # die silently: fail every caller bound to a slot, rebuild
                # the device state and keep serving the queue
                if self.logger is not None:
                    self.logger.error("generation engine tick failed: %r",
                                      exc)
                self._fail_outstanding(exc)
                self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Fresh pool leaves, an all-sentinel table, zeroed slot rows and
        a fresh draft cache: the failed step may have left any of them
        half written."""
        self._pool.reset()
        if self.spec:
            for leaf in self._draft_cache.values():
                leaf.zero_()
        self._table.fill(self._pool.sentinel)
        self._table_version += 1
        for slot in self._slots:
            slot.pages = []
        self._reset_slot_tensors()

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Fail every caller bound to an active slot. Queued requests were
        never dispatched and are retried against the rebuilt state."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.active:
                self._fail_slot(slot_idx, slot, exc)

    async def _loop_body(self, loop) -> None:
        admitted = await self._admit_pending(loop)
        ticked = False
        if self.active_slots > 0:
            ticked = await self._dispatch_tick(loop)
        if admitted or ticked:
            return
        if self.active_slots == 0 and not self._pending:
            self._wake.clear()
            await self._wake.wait()
        else:
            # work exists but nothing could be dispatched this pass (e.g.
            # admission waits for pages): yield instead of spinning
            await asyncio.sleep(0.001)

    async def _admit_pending(self, loop) -> int:
        """Drain the queue into free slots; one batched prefill per prompt
        bucket. Returns the number of requests admitted."""
        requests: List[_Request] = []
        while self._pending and len(requests) < len(self._free):
            requests.append(self._pending.popleft())
        if not requests:
            return 0
        by_bucket: Dict[int, List[_Request]] = {}
        committed = 0    # pages promised to requests admitted this pass
        for ri, req in enumerate(requests):
            if req.queue is not None and req.queue in self._cancelled_queues:
                self._cancelled_queues.discard(req.queue)
                if not req.future.done():
                    req.future.cancel()
                continue
            need = -(-len(req.prompt) // self.kv_page)
            if need + self._kv_reserve > self._pool.num_pages:
                self._reject(req, RuntimeError(
                    f"prompt needs {need} KV pages but the pool holds "
                    f"{self._pool.num_pages} (reserve {self._kv_reserve}); "
                    "it can never be admitted"))
                continue
            if self._pool.free_pages - committed < need + self._kv_reserve:
                # head-of-line FIFO: this request and every later one wait
                # for pages, ahead of newer arrivals
                self._pending.extendleft(reversed(requests[ri:]))
                break
            committed += need
            by_bucket.setdefault(req.bucket, []).append(req)
        if not self._pending:
            self._cancelled_queues.clear()
        # claim slots for every group before dispatching any, so a failed
        # dispatch reaches every admitted caller through its slot
        staged = [self._claim_group(bucket, group)
                  for bucket, group in sorted(by_bucket.items())]
        admitted = 0
        for nb, bucket, claimed, args in staged:
            first = await loop.run_in_executor(
                None, lambda a=args: self._prefill_insert(*a))
            self.prefill_dispatches += 1
            for slot_idx, gen, row in claimed:
                self._push_tokens(slot_idx, gen, [int(first[row])])
            admitted += len(claimed)
        return admitted

    def _claim_group(self, bucket: int, group: List[_Request]):
        """Bind each request of one bucket group to a slot and its fresh
        pages; returns (nb, bucket, [(slot, gen, row)], prefill args)."""
        nb = next(x for x in self._n_ladder if x >= len(group))
        npg = bucket // self.kv_page
        padded = np.zeros((nb, bucket), np.int64)
        lengths = np.ones((nb,), np.int64)
        slots = np.full((nb,), self.max_slots, np.int64)  # padding: skipped
        temps = np.zeros((nb,), np.float32)
        top_ks = np.zeros((nb,), np.int64)
        top_ps = np.ones((nb,), np.float32)
        gens: List[Optional[torch.Generator]] = [None] * nb
        flat_ids = np.full((nb * npg,), self._pool.sentinel, np.int32)
        claimed = []
        for row, req in enumerate(group):
            slot_idx = self._free.pop()
            slot = self._slots[slot_idx]
            slot.future = req.future
            slot.queue = req.queue
            slot.submitted_at = req.submitted_at
            slot.remaining = req.budget
            slot.eos_id = req.eos_id
            slot.tokens = []
            slot.active = True
            slot.gen += 1
            slot.inflight = 1          # the prefill's first token
            slot.temperature = req.sampling.temperature
            slot.fill = len(req.prompt)
            slot.generator = None
            if not req.sampling.greedy:
                slot.generator = torch.Generator(device=self.device)
                slot.generator.manual_seed(req.sampling.seed & 0xFFFFFFFF)
            n_fresh = -(-len(req.prompt) // self.kv_page)
            ids = self._pool.alloc(n_fresh)
            if ids is None:
                raise RuntimeError(
                    f"kv page pool exhausted at admission: {n_fresh} pages "
                    f"wanted, {self._pool.free_pages} free")
            slot.pages = list(ids)
            self._table[slot_idx, :n_fresh] = ids
            self._table_version += 1
            flat_ids[row * npg:row * npg + n_fresh] = ids
            padded[row, :len(req.prompt)] = req.prompt
            lengths[row] = len(req.prompt)
            slots[row] = slot_idx
            temps[row] = max(req.sampling.temperature, 0.0)
            top_ks[row] = req.sampling.top_k
            top_ps[row] = req.sampling.top_p
            gens[row] = slot.generator
            claimed.append((slot_idx, slot.gen, row))
        args = (nb, bucket, padded, lengths, slots, temps, top_ks, top_ps,
                gens, flat_ids)
        return nb, bucket, claimed, args

    async def _dispatch_tick(self, loop) -> bool:
        """Choose K, run one decode tick over the eligible slots and
        publish its tokens. Slots whose budget is covered by in-flight
        tokens sit the tick out. Returns False when no slot could run."""
        eligible = [(slot_idx, slot)
                    for slot_idx, slot in enumerate(self._slots)
                    if slot.active and slot.remaining > slot.inflight]
        if not eligible:
            return False
        min_wanted = min(slot.remaining - slot.inflight
                         for _, slot in eligible)
        k = 1
        if not self._pending or not self._free:
            k = max(rung for rung in self._k_ladder if rung <= min_wanted)
            # rung g commits up to g + 1 tokens per slot, so it needs
            # g + 1 <= min_wanted: no budget is ever overshot
            g = max((rung for rung in self._g_ladder
                     if rung + 1 <= min_wanted and rung <= self._gamma_cap),
                    default=0)
            if g > 0:
                return await self._dispatch_spec(loop, eligible, g)
        eligible = self._cover_pages(eligible, k)
        if not eligible:
            return False
        active_dev, gens, snapshot = self._charge(eligible, k)
        table = self._table_dev()
        host = await loop.run_in_executor(
            None, self._decode_tick, k, active_dev, table, gens)
        self.decode_steps += k
        self.ticks += 1
        for slot_idx, gen in snapshot:
            self._push_tokens(slot_idx, gen,
                              [int(t) for t in host[:, slot_idx]])
        return True

    async def _dispatch_spec(self, loop, eligible, g: int) -> bool:
        """Run one speculative tick at rung ``g``: charge every slot
        g + 1 in-flight tokens (the worst case), cover pages for fill +
        g + 1, run the tick, then refund the rejected tail so inflight
        and fill track the device advance of accepts + 1 exactly."""
        eligible = self._cover_pages(eligible, g + 1)
        if not eligible:
            return False
        active_dev, gens, snapshot = self._charge(eligible, g + 1)
        table = self._table_dev()
        toks, accepts = await loop.run_in_executor(
            None, self._spec_tick, g, active_dev, table, gens)
        self.spec_rungs[g] = self.spec_rungs.get(g, 0) + 1
        self.draft_steps += g + 1
        proposed = accepted = 0
        for slot_idx, gen in snapshot:
            a = int(accepts[slot_idx])
            slot = self._slots[slot_idx]
            if slot.gen == gen:
                slot.inflight -= g - a
                slot.fill -= g - a
                proposed += g
                accepted += a
            self._push_tokens(slot_idx, gen,
                              [int(t) for t in toks[:a + 1, slot_idx]])
        self._note_spec(proposed, accepted)
        return True

    def _note_spec(self, proposed: int, accepted: int) -> None:
        """Acceptance accounting plus the adaptive-γ controller, called
        once per spec tick after ``spec_rungs`` counts it: every
        ``_SPEC_WINDOW_TICKS`` spec ticks the window's acceptance rate
        halves the γ cap (draft diverging) or doubles it back toward
        ``spec_gamma`` (draft agreeing). A window that proposed nothing
        (every slot cancelled mid-tick) moves nothing."""
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_window_proposed += proposed
        self._spec_window_accepted += accepted
        if self.spec_dispatches % _SPEC_WINDOW_TICKS \
                or not self._spec_window_proposed:
            return
        rate = self._spec_window_accepted / self._spec_window_proposed
        if rate < _SPEC_SHRINK_BELOW:
            self._gamma_cap = max(1, self._gamma_cap // 2)
        elif rate > _SPEC_GROW_ABOVE:
            self._gamma_cap = min(self.spec_gamma, self._gamma_cap * 2)
        self._spec_window_proposed = 0
        self._spec_window_accepted = 0

    def _charge(self, eligible, n: int):
        """Charge each eligible slot ``n`` in-flight tokens and ``n`` of
        fill. Returns the tick's device active mask, the generators of its
        sampled slots (None for greedy ones) and the (slot, generation)
        snapshot its tokens are published against."""
        active = np.zeros((self.max_slots,), bool)
        gens: List[Optional[torch.Generator]] = [None] * self.max_slots
        snapshot = []
        for slot_idx, slot in eligible:
            active[slot_idx] = True
            slot.inflight += n
            slot.fill += n
            if slot.temperature > 0.0:
                gens[slot_idx] = slot.generator
            snapshot.append((slot_idx, slot.gen))
        return torch.as_tensor(active, device=self.device), gens, snapshot

    def _cover_pages(self, eligible, k: int):
        """Grow each slot's pages to cover its fill + k tokens. Slots the
        pool cannot cover sit this tick out."""
        covered = []
        for slot_idx, slot in eligible:
            need = -(-(slot.fill + k) // self.kv_page)
            short = need - len(slot.pages)
            if short > 0:
                ids = self._pool.alloc(short)
                if ids is None:
                    continue
                held = len(slot.pages)
                self._table[slot_idx, held:held + short] = ids
                slot.pages.extend(ids)
                self._table_version += 1
            covered.append((slot_idx, slot))
        return covered

    # -- publishing --------------------------------------------------------------
    def _push_tokens(self, slot_idx: int, gen: int,
                     tokens: List[int]) -> None:
        """Append generated tokens to a slot, handling eos and budget;
        tokens of a stale generation (slot reclaimed since) are dropped."""
        slot = self._slots[slot_idx]
        if slot.gen != gen:
            return
        slot.inflight -= len(tokens)
        if not slot.active:
            return
        if not slot.tokens:
            self.ttfts.append(time.monotonic() - slot.submitted_at)
        for token in tokens:
            if token < 0 or token >= self.cfg.vocab_size:
                self._fail_slot(slot_idx, slot, RuntimeError(
                    f"slot {slot_idx} produced out-of-range token {token} "
                    f"(vocab {self.cfg.vocab_size})"))
                return
            slot.tokens.append(token)
            slot.remaining -= 1
            if slot.queue is not None:
                slot.queue.put_nowait(token)
            if slot.remaining <= 0 or (slot.eos_id is not None
                                       and token == slot.eos_id):
                if slot.future is not None and not slot.future.done():
                    slot.future.set_result(list(slot.tokens))
                if slot.queue is not None:
                    slot.queue.put_nowait(_DONE)
                    slot.queue = None
                self._finish_slot(slot_idx, slot)
                return

    def _reject(self, req: _Request, exc: BaseException) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        if req.queue is not None:
            req.queue.put_nowait(exc)

    def _fail_slot(self, slot_idx: int, slot: _Slot,
                   exc: BaseException) -> None:
        if slot.future is not None and not slot.future.done():
            slot.future.set_exception(exc)
        if slot.queue is not None:
            slot.queue.put_nowait(exc)
            slot.queue = None
        self._finish_slot(slot_idx, slot)

    def _release_slot_kv(self, slot_idx: int, slot: _Slot) -> None:
        """Return a finished slot's pages to the pool and reset its table
        row to the sentinel, so a recycled slot never reads a stale page."""
        if slot.pages:
            self._pool.release(slot.pages)
            slot.pages = []
        row = self._table[slot_idx]
        if (row != self._pool.sentinel).any():
            row.fill(self._pool.sentinel)
            self._table_version += 1

    def _finish_slot(self, slot_idx: int, slot: _Slot) -> None:
        """Retire a slot: inactive, a new generation (in-flight tokens
        are dropped), KV released, back on the free list."""
        slot.active = False
        slot.gen += 1
        slot.inflight = 0
        slot.generator = None
        self._release_slot_kv(slot_idx, slot)
        if slot_idx not in self._free:
            self._free.append(slot_idx)

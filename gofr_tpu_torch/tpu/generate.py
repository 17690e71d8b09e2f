"""Continuous-batching generation engine for the Llama ``/generate`` path
(counterpart of ``gofr_tpu/tpu/generate.py``), with the JAX engine's two
KV layouts: a dense cache (``paged_kv=False``, the default, as in JAX)
or a paged pool (``paged_kv=True``).

- Dense: one (max_slots, max_len) cache row per slot
  (``llama.init_cache``). Each tick attends only the smallest rung of the
  attention-window ladder (128, 256, ... below max_len, then the whole
  cache; ``window_ladder``) that covers every participating slot's fill
  plus the tokens it writes, so an early-fill tick never reads the
  cache's dead tail; writes always go to the full cache. The target
  reads its cache through the ragged kernels, the layer viewed as a pool
  of pages in slot order and one identity page table a rung.
- Paged: one :class:`~gofr_tpu_torch.tpu.page_pool.PagePool` holds every
  KV byte; each slot addresses its pages through a host page-table row,
  uploaded to the device when it changes. Admission waits for pages.
- A new request claims a free slot. Admissions are batched: requests
  pending at the top of a loop pass prefill together, grouped by prompt
  bucket, the count padded to a ladder (1, 2, 4, ..., max_slots) and the
  prompts right-padded to the bucket. Prefill (flash-attention kernel on
  the card) fills a small dense cache that one in-place insert copies
  into the claimed slots' cache rows or scatters into freshly allocated
  pool pages; the first token is sampled inside the prefill step, and
  each claimed slot's PRNG key is made from its request's seed there.
- A decode tick advances every active slot K steps (K from the ladder
  1, 2, 4, ... <= ``steps_per_tick``, never past the smallest remaining
  budget, and 1 while a pending request could be admitted); each step
  runs ``llama.decode_step`` or ``llama.decode_step_paged`` (ragged
  decode kernel on the card) and samples per slot. Inactive slots are
  frozen (cache_len does not advance); their writes land at frozen
  positions past their fill (dense) or in the pool's scratch page.
- ``cfg.kv_int8`` makes the cache or the pool int8 with float32 scale
  planes: the insert copies the quantised prefill rows and scales, and
  decode and verify read them through the ragged kernel's int8
  instantiation.
- Speculative decode (``draft_cfg``/``draft_params``): a draft model with
  a dense per-slot cache (flash-decode kernel on the card, over the
  tick's window in the dense engine) proposes g tokens in g + 1 steps,
  the target scores all g + 1 positions in one ``llama.verify_step`` or
  ``verify_step_paged`` (ragged verify kernel on the card), and
  ``speculative_accept`` commits 1 to g + 1 tokens per slot. g walks the
  ladder 1, 2, 4, ... plus ``spec_gamma``, never past the smallest
  remaining budget (g + 1 <= min_wanted) nor the adaptive cap, which
  halves or doubles on the acceptance of every 16 spec ticks. Plain
  ticks serve the last token of a budget and any tick with an admission
  waiting.
- Compiled ticks: the device state (cache_len, last token, sampling
  parameters, per-slot PRNG keys, active mask, page table or identity
  tables, cache or pool) lives at fixed addresses and is updated in
  place, so each tick is one function of that state. There is one
  executable per plain ``(k, sampled, window)`` rung and per spec ``(g,
  sampled, window)`` rung (window None in the paged engine), as the JAX
  engine keeps one compiled executable each: on the card a
  ``torch.cuda.CUDAGraph`` captured after one eager run on a side stream
  (``warmup()`` captures the ladders at the startup window rungs; a rung
  first met while serving is captured then), on the CPU the same
  function run eagerly. A failed capture or replay raises; there is no
  eager fallback on the card.
- The loop is pipelined M deep (``max_inflight_ticks``, 2 as in the JAX
  engine): a tick's dispatch uploads its mask (and page table) through
  pinned slabs (``tpu/staging``), replays its graph and queues the copy
  of its tokens into a pinned slab, and up to M ticks are dispatched
  before the oldest one's tokens are fetched (a worker thread waits on
  the copy's event). Tokens publish in dispatch order; per-slot
  ``inflight`` and ``fill`` charging keeps every budget, window and page
  cover exact, a spec tick is charged g + 1 and refunded at publish, and
  tokens of a slot that was reclaimed since dispatch are dropped. The
  prefill's first token is fetched the same way.
- All device work is queued from one thread (a single-worker executor),
  in dispatch order: prefill inserts and ticks write the same state, and
  the stream's order is what makes that safe, a page freed while a later
  tick is in flight included.
- Tokens stream: ``generate_stream`` yields ids as each tick's fetch
  lands; ``generate`` gathers them.

Left for later slices (see ROADMAP.md): prefix cache, disaggregation,
grammar-constrained decoding, brownout, auto-tuning, upload coalescing,
mesh sharding and the SLO / metrics / flight-recorder hooks.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.ops.sampling import (filtered_log_probs_batch,
                                         greedy_accept, sample_batch,
                                         speculative_accept)
from gofr_tpu_torch.tpu.page_pool import PagePool
from gofr_tpu_torch.tpu.staging import StagingPool

DEFAULT_PROMPT_BUCKETS = (32, 128, 512)
# the dense cache's view pages the ragged kernel's card checks hold it at
# (cuda_refusals): 32 (chip_smoke.py phases 4, 5, 13) and 16
# (tests/test_torch_cuda_kernels.py)
DENSE_VIEW_PAGES = (16, 32)

# adaptive-γ controller (speculative decode): windowed acceptance is
# evaluated every N spec ticks; below the shrink threshold the γ cap
# halves (a diverging draft wastes the verify forward), above the grow
# threshold it doubles back toward spec_gamma
_SPEC_WINDOW_TICKS = 16
_SPEC_SHRINK_BELOW = 0.5
_SPEC_GROW_ABOVE = 0.8

# sentinel pushed onto a streaming queue when the request completes
_DONE = object()

# a tick executable: (kind "plain" | "spec", k | g, sampled, window rung)
_Key = Tuple[str, int, bool, Optional[int]]


def cuda_refusals(cfg, max_len: int, kv_page: int, draft_cfg=None,
                  spec_gamma: int = 0, paged_kv: bool = False) -> List[str]:
    """What the card's kernels would refuse at the first tick of an engine
    of this configuration, one line each (empty: nothing). The ragged
    kernel serves the target (head_dim 128, GQA group 1/2/4/8, bf16, at
    most ``MAX_VERIFY_TOKENS`` queries a slot, a rank's scores of the
    widest table within ``MAX_DYN_SMEM``); the flash-decode kernel serves
    the draft (head_dim 128, group 1/2/4/8, bf16). The paged engine's
    table has ``max_len / kv_page`` columns of ``kv_page``; the dense
    engine's widest identity table (the top window rung) ``max_len /
    page`` columns of its view page (``llama.dense_page``), which must be
    one of ``DENSE_VIEW_PAGES``, the pages the kernel's checks on the card
    hold it at. The plain versions the CPU runs take any of these."""
    out = []
    models = [("model", cfg, ragged_mod)]
    if draft_cfg is not None:
        models.append(("draft", draft_cfg, decode_mod))
    for name, c, mod in models:
        if c.dtype != torch.bfloat16:
            out.append(f"{name} dtype {c.dtype}: the kernels take bf16")
        if c.head_dim != mod.HEAD_DIM:
            out.append(f"{name} head_dim {c.head_dim}: the kernels take "
                       f"{mod.HEAD_DIM}")
        if c.n_heads % c.n_kv_heads \
                or c.n_heads // c.n_kv_heads not in mod.SUPPORTED_GROUPS:
            out.append(f"{name} GQA group {c.n_heads}/{c.n_kv_heads}: the "
                       f"kernels take {mod.SUPPORTED_GROUPS}")
    g_len = 1
    if draft_cfg is not None:
        g_len = spec_gamma + 1
        if g_len > ragged_mod.MAX_VERIFY_TOKENS:
            out.append(f"spec_gamma {spec_gamma}: verify takes at most "
                       f"MAX_VERIFY_TOKENS = {ragged_mod.MAX_VERIFY_TOKENS} "
                       f"tokens a slot")
    page = kv_page
    if not paged_kv:
        page = llama.dense_page(max_len)
        if page not in DENSE_VIEW_PAGES:
            out.append(f"dense view page {page} (max_len {max_len}): the "
                       f"ragged kernel is held to its gates at pages "
                       f"{DENSE_VIEW_PAGES}; max_len must be a multiple "
                       f"of {min(DENSE_VIEW_PAGES)}")
    if cfg.n_heads % cfg.n_kv_heads == 0 \
            and g_len <= ragged_mod.MAX_VERIFY_TOKENS:
        width = max_len // page
        smem = ragged_mod.dyn_smem_bytes(width, page,
                                         cfg.n_heads // cfg.n_kv_heads, g_len)
        if smem > ragged_mod.MAX_DYN_SMEM:
            out.append(f"a table of {width} columns of {page} at "
                       f"{g_len} queries a slot needs {smem} bytes of "
                       f"shared memory, over MAX_DYN_SMEM = "
                       f"{ragged_mod.MAX_DYN_SMEM}")
    return out


class Sampling:
    """Per-request sampling parameters. ``temperature <= 0`` is greedy;
    ``top_k == 0`` and ``top_p >= 1`` disable their filters. ``seed=None``
    draws fresh entropy; pass a seed for a reproducible completion (its
    low 32 bits make the slot's PRNG key, as ``jax.random.PRNGKey``)."""
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
                 "pages")

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


class _Fetch:
    """One dispatched step whose host copy is in flight: ``task`` resolves
    to its tokens; ``kind`` is prefill, tick or spec; ``payload`` what
    they publish against."""
    __slots__ = ("task", "kind", "payload")

    def __init__(self, task, kind: str, payload):
        self.task = task
        self.kind = kind
        self.payload = payload


class _Graph:
    """A captured tick: the graph, its static token output and the kernel
    launches one replay makes."""
    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph = graph
        self.out = out
        self.launches = launches


def _params_to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {key: _params_to(val, device) for key, val in params.items()}
    return params.to(device)


class GenerationEngine:
    def __init__(self, cfg, params, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets=DEFAULT_PROMPT_BUCKETS,
                 steps_per_tick: int = 1,
                 max_inflight_ticks: int = 2,
                 window_ladder: Optional[bool] = None,
                 paged_kv: bool = False,
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
        # paged KV: one page pool addressed through a per-slot page table;
        # dense (the default, as in JAX): a (max_slots, max_len) cache row
        # per slot
        self.paged = bool(paged_kv)
        self.kv_page = int(kv_page)
        if self.paged:
            if self.max_len % self.kv_page:
                raise ValueError(f"paged_kv: max_len {self.max_len} must be "
                                 f"a multiple of kv_page {self.kv_page}")
            bad = [b for b in self.prompt_buckets if b % self.kv_page]
            if bad:
                raise ValueError(f"paged_kv: prompt buckets {bad} are not "
                                 f"multiples of kv_page {self.kv_page} "
                                 f"(page-aligned inserts need page-aligned "
                                 f"buckets)")
        self.logger = logger
        # attention-window ladder (fill-bounded decode): rungs double from
        # 128 up to max_len; a dense tick attends only the smallest rung
        # covering every participating slot's fill + its steps, so an
        # early-fill tick never reads the cache's dead tail. The top rung
        # is None (the whole cache). The paged engine's ticks read through
        # the whole page table and keep window None: paging already keeps
        # dead memory out of a tick.
        if self.paged and window_ladder is True and logger is not None:
            logger.warning(
                "attention_window ladder requested together with paged_kv: "
                "paging supersedes windowing as the HBM relief mechanism; "
                "the paged ticks read the whole page table")
        window_ladder = True if window_ladder is None else bool(window_ladder)
        self._window_ladder: List[Optional[int]] = [None]
        if window_ladder and self.max_len > 128:
            rungs = []
            w = 128
            while w < self.max_len:
                rungs.append(w)
                w *= 2
            self._window_ladder = rungs + [None]
        self.spec = draft_cfg is not None and draft_params is not None
        self.spec_gamma = max(1, int(spec_gamma))
        if self.device.type == "cuda":
            refused = cuda_refusals(cfg, self.max_len, self.kv_page,
                                    draft_cfg if self.spec else None,
                                    self.spec_gamma, paged_kv=self.paged)
            if refused:
                raise ValueError("the card's kernels refuse this "
                                 "configuration: " + "; ".join(refused))
        self.params = _params_to(params, self.device)
        dev, n = self.device, self.max_slots
        self._pool: Optional[PagePool] = None
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        if self.paged:
            self.pages_per_slot = self.max_len // self.kv_page
            self._pool = PagePool(
                cfg, page=self.kv_page,
                num_pages=(int(kv_pages) if kv_pages is not None
                           else self.max_slots * self.pages_per_slot),
                device=dev)
            # pages admission must leave free for decode growth of running
            # slots
            self._kv_reserve = (int(kv_page_reserve)
                                if kv_page_reserve is not None
                                else min(self.max_slots,
                                         self._pool.num_pages // 8))
            # host master copy of the page table; the device copy is
            # uploaded when the version moves
            self._table = np.full((self.max_slots, self.pages_per_slot),
                                  self._pool.sentinel, np.int32)
            self.table = torch.full((n, self.pages_per_slot),
                                    self._pool.sentinel, dtype=torch.int32,
                                    device=dev)
        else:
            self.cache = llama.init_cache(cfg, n, self.max_len, device=dev)
            # the target reads its cache through the ragged kernels over
            # one identity page table a window rung, each contiguous at a
            # fixed address (a captured graph holds it)
            self._tables = {w: llama.identity_table(n, self.max_len, w,
                                                    device=dev)
                            for w in self._window_ladder}
        self._table_version = 0     # moves with the paged host table

        # -- speculative draft-verify decode ---------------------------------
        self.draft_cfg = None
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
            # the draft decodes through the flash-decode kernel, over the
            # tick's window in the dense engine
            self.draft_cfg = dataclasses.replace(draft_cfg,
                                                 use_flash_decode=True)
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
        self._spec_noted = 0
        self._spec_window_proposed = 0
        self._spec_window_accepted = 0

        # -- device state at fixed addresses ------------------------------
        self.cache_len = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.last_token = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.top_ps = torch.ones((n,), dtype=torch.float32, device=dev)
        self.sample_keys = torch.zeros((n, 2), dtype=torch.int64,
                                       device=dev)
        self.active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._sent_mask: Optional[bytes] = None   # last uploaded mask
        self._sent_table = -1                     # last uploaded version

        # -- tick executables and the pipeline ----------------------------
        self.max_inflight_ticks = max(1, int(max_inflight_ticks))
        self._staging = StagingPool(self.device,
                                    depth=self.max_inflight_ticks + 1)
        # all device work is queued from this one thread, in order
        self._device_exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gofr-torch-device")
        self._graphs: Dict[_Key, _Graph] = {}
        self._graph_pool = None
        self.capture_s = 0.0
        self.graph_replays = 0
        self.lazy_captures = 0     # captures made while serving
        self._publishq: "deque[_Fetch]" = deque()
        self._ticks_inflight = 0
        self._ticks_inflight_peak = 0

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
        # ticks run (plain and spec), by window rung
        self.window_ticks: Dict[Optional[int], int] = {}
        self.ttfts: "deque[float]" = deque(maxlen=4096)  # submit → 1st token

    # -- device steps (the device thread) --------------------------------------
    def _prefill_insert(self, nb: int, bucket: int, n_claimed: int,
                        ints: np.ndarray, floats: np.ndarray):
        """Batched prompt forward for ``nb`` rows of bucket ``bucket``, its
        in-place insert (paged: into the pool pages, sentinel entries
        landing in the scratch page; dense: into the claimed slots' cache
        rows, padding rows dropped, JAX ``_insert_fn``), with a draft its
        KV-only prefill into the claimed slots' dense draft rows, and the
        first ``n_claimed`` rows' slot state, PRNG keys included. ``ints``
        packs (tokens (nb, bucket), lengths, slots, top_ks, seeds (nb,)
        each, and paged the page ids (nb, bucket // page)) and ``floats``
        (temps, top_ps); each goes up in one staged copy. Returns the
        fetch of the first tokens (nb,)."""
        dev, cfg = self.device, self.cfg
        ints_dev = torch.empty(ints.shape, dtype=torch.int64, device=dev)
        floats_dev = torch.empty(floats.shape, dtype=torch.float32,
                                 device=dev)
        self._staging.upload(ints_dev, ints)
        self._staging.upload(floats_dev, floats)
        tokens = ints_dev[:nb * bucket].view(nb, bucket)
        lens, slots, top_ks, seeds = ints_dev[nb * bucket:].view(
            -1, nb)[:4]
        flat_ids = ints_dev[nb * (bucket + 4):]
        temps, top_ps = floats_dev.view(2, nb)
        small = llama.init_cache(cfg, nb, bucket, device=dev)
        logits, small, _ = llama.prefill(self.params, cfg, tokens, small,
                                         lengths=lens)
        first, keys = sample_batch(logits, temps, top_ks, top_ps,
                                   prng.seed_key(seeds))
        slot_t = slots[:n_claimed]
        # in-place insert of the group's KV; each leaf (k/v rows, int8
        # scale planes) keeps its own trailing shape
        if self.paged:
            page = self.kv_page
            for name, leaf in self._pool.leaves.items():
                leaf[:, flat_ids] = small[name].reshape(
                    cfg.n_layers, nb * (bucket // page), page,
                    *small[name].shape[3:])
        else:
            for name, leaf in self.cache.items():
                leaf[:, slot_t, :bucket] = small[name][:, :n_claimed]
        if self.spec:
            # KV-only draft prefill over the same bucket; its rows land in
            # the claimed slots' dense draft rows (padding rows dropped)
            dcfg = self.draft_cfg
            dsmall = llama.init_cache(dcfg, nb, bucket, device=dev)
            llama.prefill(self.draft_params, dcfg, tokens, dsmall,
                          lengths=lens)
            for name, leaf in self._draft_cache.items():
                leaf[:, slot_t, :bucket] = dsmall[name][:, :n_claimed]
        self.cache_len[slot_t] = lens[:n_claimed].to(torch.int32)
        self.last_token[slot_t] = first[:n_claimed]
        self.temps[slot_t] = temps[:n_claimed]
        self.top_ks[slot_t] = top_ks[:n_claimed]
        self.top_ps[slot_t] = top_ps[:n_claimed]
        self.sample_keys[slot_t] = keys[:n_claimed]
        return self._staging.fetch(first)

    def _plain_tick(self, k: int, sampled: bool, window: Optional[int],
                    active: torch.Tensor) -> torch.Tensor:
        """``k`` decode steps over every slot of the device state, updated
        in place (paged: ``llama.decode_step_paged``; dense: JAX
        ``_decode_fn``, ``llama.decode_step`` over the window rung
        ``window`` and its identity table); inactive rows keep their
        cache_len, token and key. Returns the (k, max_slots) tokens."""
        token, cache_len, keys = self.last_token, self.cache_len, \
            self.sample_keys
        steps = []
        for _ in range(k):
            if self.paged:
                logits, _, new_len = llama.decode_step_paged(
                    self.params, self.cfg, token, self._pool.leaves,
                    self.table, cache_len, active)
            else:
                logits, _, new_len = llama.decode_step(
                    self.params, self.cfg, token, self.cache, cache_len,
                    window=window, table=self._tables[window])
            if sampled:
                nxt, new_keys = sample_batch(logits, self.temps, self.top_ks,
                                             self.top_ps, keys)
                keys = torch.where(active[:, None], new_keys, keys)
            else:
                nxt = logits.argmax(dim=-1)
            cache_len = torch.where(active, new_len, cache_len)
            token = torch.where(active, nxt, token)
            steps.append(token)
        out = torch.stack(steps)
        self.cache_len.copy_(cache_len)
        self.last_token.copy_(token)
        if sampled:
            self.sample_keys.copy_(keys)
        return out

    def _spec_tick(self, g: int, sampled: bool, window: Optional[int],
                   active: torch.Tensor) -> torch.Tensor:
        """One speculative tick at rung ``g`` (JAX ``_spec_paged_fn``, and
        dense ``_spec_fn`` over the window rung ``window``): the draft
        runs g + 1 dense decode steps proposing g tokens (the extra step
        writes the last proposal's KV, so a full acceptance leaves the
        draft cache covering every committed position), the target
        verifies all g + 1 positions in one forward (paged:
        ``verify_step_paged``; dense: ``verify_step`` over the window and
        its identity table), and ``speculative_accept`` commits
        ``accepts + 1`` tokens per active row. A sampled tick splits each
        key into g + 2: one a draft step and one for the acceptance.
        Inactive rows keep their cache_len, token and key. Returns (g + 2,
        max_slots): the g + 1 committed candidates, then the accept
        counts."""
        last, cache_len, keys = self.last_token, self.cache_len, \
            self.sample_keys
        if sampled:
            split = prng.split(keys, g + 2)
        token, dlen = last, cache_len
        proposals, q_logps = [], []
        for i in range(g + 1):
            logits, _, new_len = llama.decode_step(
                self.draft_params, self.draft_cfg, token, self._draft_cache,
                dlen, window=window)
            proposal = logits.argmax(dim=-1)
            if sampled:
                q_logp = filtered_log_probs_batch(logits, self.temps,
                                                  self.top_ks, self.top_ps)
                choice = prng.categorical(split[:, i], q_logp)
                proposal = torch.where(self.temps > 0.0, choice, proposal)
                q_logps.append(q_logp)
            dlen = torch.where(active, new_len, dlen)
            token = torch.where(active, proposal, token)
            proposals.append(token)
        draft_tokens = torch.stack(proposals[:g], dim=1)          # (B, g)
        verify_tokens = torch.cat([last[:, None], draft_tokens], dim=1)
        if self.paged:
            t_logits, _ = llama.verify_step_paged(
                self.params, self.cfg, verify_tokens, self._pool.leaves,
                self.table, cache_len, active)
        else:
            t_logits, _ = llama.verify_step(
                self.params, self.cfg, verify_tokens, self.cache, cache_len,
                window=window, table=self._tables[window])
        if sampled:
            out, accepts, carry = speculative_accept(
                t_logits, torch.stack(q_logps[:g], dim=1), draft_tokens,
                self.temps, self.top_ks, self.top_ps, split[:, g + 1])
            self.sample_keys.copy_(torch.where(active[:, None], carry, keys))
        else:
            out, accepts = greedy_accept(t_logits, draft_tokens)
        accepts = torch.where(active, accepts, 0)
        chosen = out.gather(1, accepts[:, None])[:, 0]
        self.last_token.copy_(torch.where(active, chosen, last))
        self.cache_len.copy_(torch.where(active, cache_len + accepts + 1,
                                         cache_len))
        return torch.cat([out.T, accepts[None]])

    def _tick_body(self, key: _Key, active: torch.Tensor) -> torch.Tensor:
        kind, n, sampled, window = key
        if kind == "spec":
            return self._spec_tick(n, sampled, window, active)
        return self._plain_tick(n, sampled, window, active)

    def _capture(self, key: _Key) -> _Graph:
        """Capture the tick ``key`` as a CUDA graph: one eager run first,
        on a side stream with every slot inactive, which builds the
        kernels and sets their attributes, under
        ``set_sync_debug_mode("error")`` so a host sync raises here; then
        the capture, whose launch counts become the graph's. The eager
        run's writes are harmless: the paged engine's go to the pool's
        scratch page; the dense engine's, and a spec tick's into the draft
        cache, land at each row's frozen positions, at or past its fill,
        which the row writes again before it reads them (JAX's argument
        for its inactive rows)."""
        t0 = time.monotonic()
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        idle = torch.zeros_like(self.active)
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._tick_body(key, idle)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = launch_counts.read()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode="thread_local"):
            out = self._tick_body(key, self.active)
        launches = launch_counts.diff(launch_counts.read(), before)
        launch_counts.write(before)             # a capture launches nothing
        entry = _Graph(graph, out, launches)
        self._graphs[key] = entry
        self.capture_s += time.monotonic() - t0
        return entry

    def _run_tick(self, key: _Key,
                  mask: Optional[np.ndarray], table: Optional[np.ndarray]):
        """Upload what moved, run the tick (a graph replay on the card,
        captured first if this rung was not warmed; eager on the CPU) and
        queue its tokens' copy. Returns the fetch."""
        if mask is not None:
            self._staging.upload(self.active, mask)
        if table is not None:
            self._staging.upload(self.table, table)
        if self.device.type != "cuda":
            return self._staging.fetch(self._tick_body(key, self.active))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key)
            self.lazy_captures += 1
        entry.graph.replay()
        launch_counts.add(entry.launches)
        self.graph_replays += 1
        return self._staging.fetch(entry.out)

    def _warm(self, keys) -> None:
        """Capture (on the card) or run once (on the CPU) every tick of
        ``keys``, then run the prefill of one row of every bucket with a
        padding row (no slot is written)."""
        idle = torch.zeros_like(self.active)
        for key in keys:
            if self.device.type == "cuda":
                if key not in self._graphs:
                    self._capture(key)
            else:
                self._tick_body(key, idle)
        for bucket in self.prompt_buckets:
            # tokens, length 1, slot max_slots (none), top_k, seed, pages
            ints = np.zeros(bucket + 4, np.int64)
            if self.paged:
                ints = np.concatenate([ints, np.full(
                    bucket // self.kv_page, self._pool.sentinel, np.int64)])
            ints[bucket:bucket + 2] = (1, self.max_slots)
            floats = np.array([0.0, 1.0], np.float32)      # temp, top_p
            self._prefill_insert(1, bucket, 0, ints, floats)()

    # -- lifecycle -------------------------------------------------------------
    def _startup_window_rungs(self, ks: List[int]) -> List[Optional[int]]:
        """Window rungs reachable right after startup (JAX
        ``_startup_window_rungs``): every rung up to and including the one
        covering the largest prompt bucket plus the largest fused-step
        count. Deeper rungs are captured when a tick first needs them."""
        if len(self._window_ladder) == 1:
            return list(self._window_ladder)
        reach = self._pick_window([max(self.prompt_buckets)],
                                  max(ks) if ks else 1)
        rungs: List[Optional[int]] = []
        for w in self._window_ladder:
            rungs.append(w)
            if w == reach:
                break
        return rungs

    def _pick_window(self, fills: List[int], k: int) -> Optional[int]:
        """Smallest window rung covering every participating slot's fill
        plus the k tokens the tick writes (None = the whole cache; JAX
        ``_pick_window``)."""
        needed = max(fills) + k if fills else k
        for rung in self._window_ladder:
            if rung is None or rung >= needed:
                return rung
        return None

    async def warmup(self, ks: Optional[Tuple[int, ...]] = None,
                     windows: Union[Tuple[Optional[int], ...], str,
                                    None] = None) -> None:
        """Capture the tick executables so the serving path never does
        (the JAX engine's ``warmup``): every rung of the k ladder (``ks``
        restricts it) and, with a draft, of the γ ladder, greedy and
        sampled, at each window rung of ``windows``; then run one prefill
        of every bucket. ``windows``: None, the rungs reachable at startup
        (:meth:`_startup_window_rungs`); ``"all"``, the whole ladder; a
        tuple, exactly those rungs, ``max_len`` standing for the top rung
        (as ``stats()["window_ladder"]`` spells it). The paged engine's
        ticks all take window None. An unwarmed rung is captured when a
        tick first needs it (``lazy_captures``). On the CPU each tick runs
        once instead. Must run before ``start()``: it runs device work
        outside the engine loop."""
        if self._task is not None:
            raise RuntimeError(
                "warmup() must be called before start(): it runs device "
                "work outside the engine loop")
        if ks is None:
            rungs = list(self._k_ladder)
        else:
            unknown = [k for k in ks if k not in self._k_ladder]
            if unknown or not ks:
                raise ValueError(
                    f"warmup ks={unknown or ks} are not k-ladder rungs "
                    f"{self._k_ladder}; nothing would be warmed for them")
            rungs = [k for k in self._k_ladder if k in ks]
        if windows is None:
            window_rungs = self._startup_window_rungs(rungs)
        elif isinstance(windows, str):
            if windows != "all":
                raise ValueError(
                    f"warmup windows={windows!r}: the only string sentinel "
                    f"is 'all' (full-matrix warmup)")
            window_rungs = list(self._window_ladder)
        else:
            requested = [None if w == self.max_len else w for w in windows]
            unknown = [w for w in requested if w not in self._window_ladder]
            if unknown or not requested:
                raise ValueError(
                    f"warmup windows={unknown or list(windows)} are not "
                    f"window-ladder rungs {self._window_ladder} (max_len="
                    f"{self.max_len} aliases the None top rung); nothing "
                    f"would be warmed for them and the first serving tick "
                    f"would capture on the hot path")
            window_rungs = [w for w in self._window_ladder if w in requested]
        if self.paged:
            window_rungs = [None]
        keys = [("plain", k, s, w) for w in window_rungs for k in rungs
                for s in (False, True)]
        keys += [("spec", g, s, w) for w in window_rungs
                 for g in self._g_ladder for s in (False, True)]
        if self.logger is not None:
            self.logger.info("engine warmup: %d tick executables %s",
                             len(keys), keys)
        await asyncio.get_running_loop().run_in_executor(
            self._device_exec, self._warm, keys)

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
            # land what is still in flight: no device work outlives the
            # loop, and a later start() finds the accounting whole
            q = self._publishq
            while q:
                try:
                    host = await q[0].task
                except Exception:  # noqa: BLE001 — its callers are failed
                    q.popleft()    # by the next start's first error
                    continue
                self._publish(q.popleft(), host)

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

    def _by_window(self, windows) -> Dict[int, int]:
        """How many of ``windows`` are each rung, the top one as
        ``max_len``."""
        counts: Dict[int, int] = {}
        for w in windows:
            counts[w or self.max_len] = counts.get(w or self.max_len, 0) + 1
        return dict(sorted(counts.items()))

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
            "max_inflight_ticks": self.max_inflight_ticks,
            "ticks_inflight": self._ticks_inflight,
            "ticks_inflight_peak": self._ticks_inflight_peak,
            "graphs": {
                "captured": len(self._graphs),
                "keys": [list(key) for key in self._graphs],
                "by_window": self._by_window(key[3] for key in self._graphs),
                "capture_s": self.capture_s,
                "replays": self.graph_replays,
                "lazy_captures": self.lazy_captures,
            },
            "max_len": self.max_len,
            "window_ladder": [w or self.max_len
                              for w in self._window_ladder],
            "ticks_by_window": {
                w or self.max_len: n for w, n in sorted(
                    self.window_ticks.items(),
                    key=lambda item: item[0] or self.max_len)},
        }
        if self.paged:
            out["kv_pool"] = self._pool.stats()
        else:
            out["kv_cache"] = {
                "max_slots": self.max_slots,
                "max_len": self.max_len,
                "view_page": llama.dense_page(self.max_len),
                "cache_bytes": sum(leaf.numel() * leaf.element_size()
                                   for leaf in self.cache.values()),
                "tokens_in_cache": sum(slot.fill for slot in self._slots
                                       if slot.active),
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
                # drain in-flight fetches before the reset: their threads
                # may still be reading slabs of the failed ticks
                for entry in self._publishq:
                    try:
                        await entry.task
                    except asyncio.CancelledError:
                        raise        # engine.stop() must still win
                    except Exception:  # noqa: BLE001 — the callers were
                        pass           # already failed above
                self._publishq.clear()
                self._ticks_inflight = 0
                # the device mask and table are cleared below: upload anew
                self._sent_mask, self._sent_table = None, -1
                try:
                    await loop.run_in_executor(self._device_exec,
                                               self._reset_device_state)
                except Exception as reset_exc:  # noqa: BLE001
                    if self.logger is not None:
                        self.logger.error(
                            "engine device-state reset failed: %r",
                            reset_exc)

    def _reset_device_state(self) -> None:
        """Clear the pool or the dense cache, the draft cache and the slot
        state in place (the failed step may have left any of them half
        written; captured graphs hold their addresses). The failed slots'
        pages went back with their slots."""
        if self.paged:
            self._pool.reset()
            self.table.fill_(self._pool.sentinel)
        else:
            for name, leaf in self.cache.items():
                leaf.fill_(1 if name in ("ks", "vs") else 0)
        if self.spec:
            for leaf in self._draft_cache.values():
                leaf.zero_()
        for tensor in (self.cache_len, self.last_token, self.temps,
                       self.top_ks, self.sample_keys, self.active):
            tensor.zero_()
        self.top_ps.fill_(1.0)

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Fail every caller bound to an active slot. Queued requests were
        never dispatched and are retried against the rebuilt state."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.active:
                self._fail_slot(slot_idx, slot, exc)

    async def _loop_body(self, loop) -> None:
        q = self._publishq
        # 1. batched admission; each prefill's first-token fetch is queued
        self._admit_pending(loop)
        # 2. dispatch the next tick up to the pipeline depth; its fetch
        #    follows it
        dispatched = False
        if self.active_slots > 0 \
                and self._ticks_inflight < self.max_inflight_ticks:
            entry = self._dispatch_tick(loop)
            if entry is not None:
                self._ticks_inflight += 1
                self._ticks_inflight_peak = max(self._ticks_inflight_peak,
                                                self._ticks_inflight)
                q.append(entry)
                dispatched = True
        if not q:
            if self.active_slots == 0 and not self._pending:
                self._wake.clear()
                await self._wake.wait()
            else:
                # work exists but nothing could be dispatched this pass
                # (e.g. admission waits for pages): yield, don't spin
                await asyncio.sleep(0.001)
            return
        # 3. publish in dispatch order. Block on the oldest fetch only
        #    when the pipeline cannot go deeper; then drain what landed.
        #    The entry leaves the queue once published, so a stop() while
        #    waiting loses nothing.
        if not dispatched or self._ticks_inflight >= self.max_inflight_ticks:
            host = await asyncio.shield(q[0].task)
            self._publish(q.popleft(), host)
        self._publish_ready()

    def _publish_ready(self) -> None:
        """Publish every fetch at the head of the queue that has landed."""
        q = self._publishq
        while q and q[0].task.done():
            entry = q.popleft()
            self._publish(entry, entry.task.result())

    def _on_device(self, loop, kind: str, payload, fn, *args) -> _Fetch:
        """Queue ``fn(*args)`` on the device thread, behind everything
        queued before it, and return the step's fetch: a task that waits
        for the call (which returns the host copy's waiter) and then, in
        a worker thread, for the copy. The loop does not wait for the
        call: a replay can block its thread until the card drains the
        launch queue, and a short bucket's first tokens must not wait
        behind it."""
        queued = loop.run_in_executor(self._device_exec, fn, *args)

        async def land():
            return await loop.run_in_executor(None, await queued)
        return _Fetch(loop.create_task(land()), kind, payload)

    def _admit_pending(self, loop) -> None:
        """Drain the queue into free slots; one batched prefill per prompt
        bucket, each with its first-token fetch queued for publishing."""
        requests: List[_Request] = []
        while self._pending and len(requests) < len(self._free):
            requests.append(self._pending.popleft())
        if not requests:
            return
        by_bucket: Dict[int, List[_Request]] = {}
        committed = 0    # pages promised to requests admitted this pass
        for ri, req in enumerate(requests):
            if req.queue is not None and req.queue in self._cancelled_queues:
                self._cancelled_queues.discard(req.queue)
                if not req.future.done():
                    req.future.cancel()
                continue
            if not self.paged:
                by_bucket.setdefault(req.bucket, []).append(req)
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
        for claimed, args, pages in staged:
            self._publishq.append(self._on_device(
                loop, "prefill", claimed, self._prefill_insert, *args))
            if self.paged:
                self._pool.note_writes(pages)
            self.prefill_dispatches += 1

    def _claim_group(self, bucket: int, group: List[_Request]):
        """Bind each request of one bucket group to a slot (paged: and its
        fresh pages), rows 0.. in order (padding rows follow); returns
        ([(slot, gen, row)], prefill args, pages written)."""
        nb = next(x for x in self._n_ladder if x >= len(group))
        npg = bucket // self.kv_page if self.paged else 0
        padded = np.zeros((nb, bucket), np.int64)
        rows = np.zeros((4, nb), np.int64)      # lengths, slots, top_ks, seeds
        rows[0] = 1
        rows[1] = self.max_slots               # padding: no slot
        floats = np.zeros((2, nb), np.float32)  # temps, top_ps
        floats[1] = 1.0
        flat_ids = (np.full((nb * npg,), self._pool.sentinel, np.int64)
                    if self.paged else np.zeros(0, np.int64))
        claimed = []
        pages = 0
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
            if self.paged:
                n_fresh = -(-len(req.prompt) // self.kv_page)
                ids = self._pool.alloc(n_fresh)
                if ids is None:
                    raise RuntimeError(
                        f"kv page pool exhausted at admission: {n_fresh} "
                        f"pages wanted, {self._pool.free_pages} free")
                slot.pages = list(ids)
                self._table[slot_idx, :n_fresh] = ids
                self._table_version += 1
                flat_ids[row * npg:row * npg + n_fresh] = ids
                pages += n_fresh
            padded[row, :len(req.prompt)] = req.prompt
            rows[:, row] = (len(req.prompt), slot_idx, req.sampling.top_k,
                            req.sampling.seed & 0xFFFFFFFF)
            floats[:, row] = (max(req.sampling.temperature, 0.0),
                              req.sampling.top_p)
            claimed.append((slot_idx, slot.gen, row))
        ints = np.concatenate([padded.ravel(), rows.ravel(), flat_ids])
        args = (nb, bucket, len(group), ints, floats.ravel())
        return claimed, args, pages

    def _dispatch_tick(self, loop) -> Optional[_Fetch]:
        """Choose K, charge the eligible slots and dispatch one decode
        tick; returns its fetch, or None when no slot could run. Slots
        whose budget is covered by in-flight tokens sit the tick out."""
        eligible = [(slot_idx, slot)
                    for slot_idx, slot in enumerate(self._slots)
                    if slot.active and slot.remaining > slot.inflight]
        if not eligible:
            return None
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
                return self._dispatch_spec(loop, eligible, g)
        eligible = self._cover_pages(eligible, k)
        if not eligible:
            return None
        window = self._tick_window(eligible, k)
        mask, sampled, snapshot = self._charge(eligible, k)
        self.decode_steps += k
        self.ticks += 1
        return self._dispatch(loop, ("plain", k, sampled, window), mask,
                              "tick", snapshot)

    def _dispatch_spec(self, loop, eligible, g: int) -> Optional[_Fetch]:
        """Dispatch one speculative tick at rung ``g``: charge every slot
        g + 1 in-flight tokens and g + 1 of fill (the worst case; the
        publish refunds the rejected tail), cover pages for it."""
        eligible = self._cover_pages(eligible, g + 1)
        if not eligible:
            return None
        window = self._tick_window(eligible, g + 1)
        mask, sampled, snapshot = self._charge(eligible, g + 1)
        self.spec_rungs[g] = self.spec_rungs.get(g, 0) + 1
        self.draft_steps += g + 1
        return self._dispatch(loop, ("spec", g, sampled, window), mask,
                              "spec", (snapshot, g))

    def _tick_window(self, eligible, n: int) -> Optional[int]:
        """The window rung of a tick that writes ``n`` tokens a slot, from
        the fills before it is charged (JAX ``_pick_window``); the paged
        engine's ticks read the whole table (None)."""
        if self.paged:
            return None
        return self._pick_window([slot.fill for _, slot in eligible], n)

    def _dispatch(self, loop, key, mask: np.ndarray, kind: str,
                  payload) -> _Fetch:
        """Queue tick ``key`` with the mask and (paged) the page table,
        each only if it changed since the last upload (a snapshot taken
        here, in dispatch order). Returns its fetch."""
        self.window_ticks[key[3]] = self.window_ticks.get(key[3], 0) + 1
        sent_mask = mask.tobytes()
        mask_up = None if sent_mask == self._sent_mask else mask
        table_up = None
        if self.paged and self._sent_table != self._table_version:
            table_up = self._table.copy()
        self._sent_mask, self._sent_table = sent_mask, self._table_version
        return self._on_device(loop, kind, payload, self._run_tick, key,
                               mask_up, table_up)

    def _note_spec(self, proposed: int, accepted: int) -> None:
        """Acceptance accounting plus the adaptive-γ controller, called
        once per published spec tick: every ``_SPEC_WINDOW_TICKS`` of
        them the window's acceptance rate halves the γ cap (draft
        diverging) or doubles it back toward ``spec_gamma`` (draft
        agreeing). A window that proposed nothing (every slot cancelled
        mid-tick) moves nothing."""
        self._spec_noted += 1
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_window_proposed += proposed
        self._spec_window_accepted += accepted
        if self._spec_noted % _SPEC_WINDOW_TICKS \
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
        fill. Returns the tick's active mask, whether any of its slots
        samples, and the (slot, generation) snapshot its tokens are
        published against."""
        mask = np.zeros((self.max_slots,), bool)
        sampled = False
        snapshot = []
        for slot_idx, slot in eligible:
            mask[slot_idx] = True
            slot.inflight += n
            slot.fill += n
            sampled = sampled or slot.temperature > 0.0
            snapshot.append((slot_idx, slot.gen))
        return mask, sampled, snapshot

    def _cover_pages(self, eligible, k: int):
        """Grow each slot's pages to cover its fill + k tokens. Slots the
        pool cannot cover sit this tick out. A dense slot's cache row
        covers max_len."""
        if not self.paged:
            return eligible
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
    def _publish(self, entry: _Fetch, host: np.ndarray) -> None:
        """Hand a fetched step's tokens to its slots, in dispatch order. A
        spec tick refunds what it charged beyond ``accepts + 1``."""
        if entry.kind == "prefill":
            for slot_idx, gen, row in entry.payload:
                self._push_tokens(slot_idx, gen, [int(host[row])])
            return
        self._ticks_inflight -= 1
        if entry.kind == "tick":
            for slot_idx, gen in entry.payload:
                self._push_tokens(slot_idx, gen,
                                  [int(t) for t in host[:, slot_idx]])
            return
        snapshot, g = entry.payload
        toks, accepts = host[:g + 1], host[g + 1]
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
        row to the sentinel, so a recycled slot never reads a stale page.
        A dense slot's row is overwritten by its next insert."""
        if not self.paged:
            return
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
        self._release_slot_kv(slot_idx, slot)
        if slot_idx not in self._free:
            self._free.append(slot_idx)

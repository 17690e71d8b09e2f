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
  tick's window in the dense engine; a ``kv_int8`` draft through the
  ragged kernel's int8 instantiation over its own identity tables)
  proposes g tokens in g + 1 steps,
  the target scores all g + 1 positions in one ``llama.verify_step`` or
  ``verify_step_paged`` (ragged verify kernel on the card), and
  ``speculative_accept`` commits 1 to g + 1 tokens per slot. g walks the
  ladder 1, 2, 4, ... plus ``spec_gamma``, never past the smallest
  remaining budget (g + 1 <= min_wanted) nor the adaptive cap, which
  halves or doubles on the acceptance of every 16 spec ticks. Plain
  ticks serve the last token of a budget and any tick with an admission
  waiting.
- Compiled ticks and prefills: the device state (cache_len, last token,
  sampling parameters, per-slot PRNG keys, active mask, page table or
  identity tables, cache or pool) lives at fixed addresses and is
  updated in place, so each tick is one function of that state. There
  is one executable per plain ``(k, sampled, window)`` rung and per spec
  ``(g, sampled, window)`` rung (window None in the paged engine), as
  the JAX engine keeps one compiled executable each, and one per prefill
  rung ``(nb, bucket, prefix rung, biased, draft bucket)``, standing for
  JAX's prefill + insert pair (and a draft's): its host part packs the
  group into the rung's static buffers in stream order, and its body
  reads only those and the state, a slot→row map deciding through
  ``torch.where`` which slots take which row, so padding rows write
  nothing whatever their count. On the card each is a
  ``torch.cuda.CUDAGraph`` captured after one eager run on a side stream
  into one shared graph pool (``warmup()`` captures the tick ladders at
  the startup window rungs and the full prefill of every bucket at its
  prompt counts; a rung first met while serving is captured then), on
  the CPU the same function run eagerly. A failed capture or replay
  raises; there is no eager fallback on the card.
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
- Prefix KV reuse (``prefix_cache=True``, JAX's admission plan): a
  :class:`~gofr_tpu_torch.tpu.prefix_cache.PrefixStore` indexes the
  page-aligned heads of earlier prompts. A request whose head is cached
  prefills only its suffix (``llama.prefill(prefix=)``, the cached pages
  rounded down to a rung of the prefix-pages ladder 1, 2, 4, ... up to
  the largest bucket's pages, and a rung dropped while the suffix bucket
  would overrun ``max_len``); admissions group by (rung, bucket). Dense:
  the store owns a pool; a suffix insert copies the prefix pages into
  the slot's rows [0, plen) and the suffix into [plen, plen + bucket),
  and a full prefill publishes its full pages. Paged: the store indexes
  the engine's pool; a hit puts the cached page ids into the slot's host
  table (pinned for the slot's life), fresh pages follow for the suffix,
  a full prefill's full prompt pages are adopted without a copy, and
  eviction of cold prefixes is the pool's ``reclaim`` under page
  pressure. A speculative draft prefills the whole prompt either way.
- All device work is queued from one thread (a single-worker executor),
  in dispatch order: prefill inserts and ticks write the same state, and
  the stream's order is what makes that safe, a page freed while a later
  tick is in flight included, and a prefix page evicted and republished
  while an earlier suffix prefill that reads it is still queued.
- Tokens stream: ``generate_stream`` yields ids as each tick's fetch
  lands; ``generate`` gathers them.
- Admission (JAX's): a request's class comes from its deadline
  (``slo.current_deadline`` at submission, ``tpu/sched.deadline_class``:
  interactive, standard or batch), and the pending queue is a
  :class:`~gofr_tpu_torch.tpu.sched.ClassQueues`, weighted-fair over
  virtual time by ``class_weights``. A paged admission short of pages
  defers the request and every later one of its pass to the overflow
  deque, which the next pass drains first; past ``max(16, 4 *
  max_slots)`` entries the deepest class sheds its newest. A request
  whose deadline passed in the queue is shed before its prefill
  (:class:`~gofr_tpu_torch.slo.DeadlineExceeded`). ``set_brownout``
  (levels 0-3) refuses batch-class submissions from level 1
  (:class:`BrownoutShed`), caps a spec engine's γ at rung 1 at level 2
  and dispatches no spec tick at level 3.
- Grammar-constrained decoding (``response_format``, a regex or a JSON
  schema; ``tpu/constrain``): the grammar compiles through the engine's
  ``GrammarCache`` at submission (a bad one raises ``GrammarError``
  there), a constrained request always takes a full prefill (prefix rung
  0), groups apart from unconstrained ones, and its first token is
  sampled from the logits plus its grammar's start-state bias row. A
  constrained slot joins a tick only with none of its tokens in flight,
  and a tick with one is a ``("bias", 1, sampled, window)`` executable:
  one step, no spec tick, the (max_slots, vocab) float32 bias (each
  constrained slot's current row, 0 elsewhere) uploaded into a buffer at
  a fixed address in stream order before the replay and added to the
  logits before the argmax or the sampler, which then sample float32
  logits as JAX's ``logits + bias`` does. These graphs are captured at
  first use. Each published token advances the slot's
  :class:`~gofr_tpu_torch.tpu.constrain.GrammarWalker`; ``must_stop``
  finishes the slot as eos does.
- Quarantine: a slot whose walker raises, or that produced a token
  outside the vocabulary, is failed alone and counted
  (``stats()["resilience"]["quarantined"]``); the tick's other slots
  keep their tokens.
- Telemetry (JAX's hooks, duck-typed: ``metrics`` takes
  ``increment_counter`` / ``delta_updown_counter`` / ``set_gauge`` /
  ``record_histogram``, ``tracer`` takes ``start_span``, ``slo`` is an
  :class:`~gofr_tpu_torch.slo.SLOTracker`): a request's ``queue.wait``,
  ``prefill`` and ``decode`` spans under the submitting span, a
  :class:`~gofr_tpu_torch.tpu.flightrecorder.RequestRecord` from submit to
  its terminal status, engine-step spans (``tpu.engine.prefill`` /
  ``step`` / ``spec``) linked to their requests and finished at publish,
  each step's dispatch-to-publish seconds charged to its participants'
  SLO classes and to its executable family, a sampled tick anatomy
  (``attach_telemetry``), compiles (graph captures, warmup or serving
  class), and the views ``statusz``, ``xlaz``, ``hbm_attribution`` and
  ``health_check``. Every hook runs on the loop thread and reads host
  state only (slot mirrors, fetched numpy tokens, the clock); the
  device thread carries only a ``torch.profiler`` step annotation, and
  only while a profiler is active.
- Fault sites (``tpu/faults``, off unless a plan is installed):
  ``tick_exception`` raises at the top of a tick's dispatch, where the
  loop's catch-all takes it; ``nan_logits`` poisons the first
  participant's fetched tokens of a plain tick at publish, which
  quarantines exactly that slot.
- The constructor takes every argument the example app passes, JAX's
  keywords in JAX's order. ``model_module`` serves another model family
  through the same ticks and prefills (``models/moe``: its dense prefill
  and its decode over the ragged wrapper): every ``init_cache`` /
  ``prefill`` / ``decode_step`` of the target goes through it, and its
  prefills keep JAX's rows on the card (an MoE's capacity is taken over
  every row). ``page_pool`` shares one pool between paged engines of one
  geometry: their device work goes through the pool's one device thread,
  onto the device's default stream, in submission order; a reset by one
  fails the others' outstanding requests (``_on_pool_reset``), and each
  one's device work dispatched before it learns of the reset runs with
  no slot active over sentinel pages. ``kv_pool_bytes`` sizes an own
  pool. ``ragged_attn="off"`` serves JAX's gather formulation over the
  gather-width rungs. ``coalesce_uploads`` makes a prefill rung's (and a
  paged engine's table and bias) static inputs views of one device
  buffer, filled by one transfer; ``coalesce_stream`` queues a tick's
  tokens as one list. Uploads are metered (``app_tpu_h2d_*`` by path) on
  the device thread and emitted at publish.
- Over a mesh (``mesh=``, ``parallel/mesh.make_mesh``; JAX's dp × tp
  serving): the engine is one controller over the mesh's shards. Slots
  split over the dp rows (``max_slots`` rounded up to a multiple of dp),
  each row's heads, FFN and vocab over its tp ranks, which run the
  model's per-rank body with an all-reduce after ``wo`` and after
  ``w_down`` and the vocab-sharded logits gathered
  (``models/llama.TPShards``, ``parallel/collectives``). Params, the
  dense cache, the page pool and the prefix store are sharded by
  ``parallel/sharding``'s specs, one tensor a coordinate. Prefills run
  on row 0 and insert into each row's slots; a tick runs each row over
  its slots, and every slot samples on the controller. A card engine's
  shards share one card (a tick is one graph); JAX's refusals (a custom
  model module, paged KV over dp > 1, speculative decode) and the
  port's (``_MeshPlan``) hold at construction.
- The operating point (JAX's): ``apply_operating_point`` swaps the prompt
  buckets, ``steps_per_tick``, the γ cap, the page reserve, the class
  weights, ``slots_cap`` (admission claims no slot past it; the ticks
  still run over every row under their mask) and the staging depth, with
  JAX's refusals; a move of the buckets or of ``steps_per_tick`` must
  first be prewarmed. ``prewarm_operating_point`` captures the graphs
  such a move needs while the engine serves, one rung a job on the
  device thread, so the serving ticks run between captures; each new
  graph runs once after its capture (over padding rows, or over an
  inactive mask put in place of the live one and restored after).
  ``shadow_clone`` builds an engine at a candidate point over the same
  parameter tensors, with its own cache or pool and graphs and no hooks.
  ``operating_point()`` (also ``xlaz()["operating_point"]``) reports it.
- The workload plane: ``attach_workload`` hands each submission to a
  :class:`~gofr_tpu_torch.tpu.workload.TrafficRecorder` (before the
  brownout gate, as JAX) and the flight recorder's finish funnel closes
  it; ``xlaz()`` then suggests a bucket ladder from the recorder's recent
  prompt lengths.

- Disaggregated serving (JAX's): ``prefill_export`` runs a prompt's
  forward once on the bucket's export rung (a local prefill's rows, no
  insert, its graph captured by ``warmup()`` with count 1) and ships its
  KV as page-shaped ``tpu/kv_wire`` leaves with the first token and the
  advanced key; ``adopt_kv`` claims a slot and pages on the loop and
  lands the payload in one job on the device thread, behind the ticks in
  flight (the slot inactive until it lands), so the decode replica runs
  no prefill; ``export_session`` quiesces a live slot (``migrating``:
  it joins no new tick), waits for its in-flight tokens, reads its pages
  and rows in one device-thread job and retires it; ``adopt_session``
  resumes it elsewhere. A replayed adopt id returns the first stream
  (the dedupe ledger). ``tpu/cluster`` routes between replicas.

``tpu/fleet`` routes by prefix affinity, migrates, drains and resumes
sessions across engines; ``tpu/autotune`` moves the operating point;
``tpu/batch_lane`` serves offline batches beside the engine.
"""

from __future__ import annotations

import asyncio
import contextlib
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
from gofr_tpu_torch.ops.quant import quantized_specs
from gofr_tpu_torch.ops.sampling import (filtered_log_probs_batch,
                                         greedy_accept, sample_batch,
                                         speculative_accept)
from gofr_tpu_torch.parallel.collectives import Group
from gofr_tpu_torch.parallel.mesh import Mesh, check_one_card
from gofr_tpu_torch.parallel.sharding import (Sharded, assemble, is_sharded,
                                              llama_cache_specs,
                                              llama_param_specs, local_tree,
                                              prune_specs, shard_pytree)
from gofr_tpu_torch.slo import DeadlineExceeded, current_deadline
from gofr_tpu_torch.tpu import capture, faults, kv_wire
# the capture turn's names as the engine had them (its tests read them)
from gofr_tpu_torch.tpu.capture import (  # noqa: F401
    _CAPTURES, no_collection as _no_collection)
from gofr_tpu_torch.tpu.compile_ledger import (ExecutableLedger, ShapeStats,
                                               charge_device_time,
                                               suggest_ladder)
from gofr_tpu_torch.tpu.constrain import (GrammarCache, GrammarWalker,
                                          token_byte_table)
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder, RequestRecord
from gofr_tpu_torch.tpu.page_pool import PagePool
from gofr_tpu_torch.tpu.prefix_cache import PrefixStore
from gofr_tpu_torch.tpu.sched import (CLASS_MIGRATED, DEFAULT_CLASS_WEIGHTS,
                                      ClassQueues, brownout_shed_classes,
                                      deadline_class)
from gofr_tpu_torch.tpu.staging import StagingPool, TransferCoalescer
from gofr_tpu_torch.trace.tracer import (Span, current_span,
                                         extract_traceparent)

DEFAULT_PROMPT_BUCKETS = (32, 128, 512)
# Prefill rows (count x bucket) on the card, at least: with fewer, cuBLAS
# splits a GEMM's reduction, and a row's bits then depend on the row count
# (scripts/prefix_identity_probe.py measures where, projection by
# projection). Padded to this, a prompt's prefill numbers do not depend on
# what it was batched with, so a suffix prefill over cached pages gives a
# full prefill's bits and greedy tokens are the same with the prefix store
# on or off.
CUDA_MIN_PREFILL_ROWS = 256
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

# adopt-dedupe ledger: replayed adoptions within this window return the
# original stream instead of claiming pages twice (JAX's values, the
# exporter-side HandoffTable's default TTL)
_ADOPT_LEDGER_TTL_S = 120.0
_ADOPT_LEDGER_CAP = 256

# a tick executable: (kind "plain" | "spec" | "bias", k | g, sampled,
# window rung); "bias" is the plain tick with the grammar bias added to
# its logits (JAX's ``_decode_bias_fn`` family)
_Key = Tuple[str, int, bool, Optional[int]]
# a prefill executable: (rows nb, bucket, prefix rung, biased, draft
# bucket db), the tick key's counterpart; db is a spec engine's suffix
# group's (its draft prefills the whole prompts), 0 otherwise
_PrefillKey = Tuple[int, int, int, bool, int]


class BrownoutShed(RuntimeError):
    """Admission refused by the brownout level (:meth:`GenerationEngine.
    set_brownout`): the replica is shedding this SLO class to protect
    interactive traffic. Retryable elsewhere — handlers map it to 503."""
    status_code = 503


def cuda_refusals(cfg, max_len: int, kv_page: int, draft_cfg=None,
                  spec_gamma: int = 0, paged_kv: bool = False) -> List[str]:
    """What the card's kernels would refuse at the first tick of an engine
    of this configuration, one line each (empty: nothing). The ragged
    kernel serves the target (a head_dim of its ``SUPPORTED_HEAD_DIMS``,
    GQA group 1/2/4/8, bf16, at most ``MAX_VERIFY_TOKENS`` queries a slot,
    a rank's scores of the widest table within ``MAX_DYN_SMEM`` at the
    model's head_dim); the flash-decode kernel serves a bf16 draft (a
    head_dim of its ``SUPPORTED_HEAD_DIMS``, group 1/2/4/8, bf16), the
    ragged kernel's int8 instantiation a ``kv_int8`` draft (the target's
    limits, at one query a slot over the draft's identity tables). The
    paged engine's
    table has ``max_len / kv_page`` columns of ``kv_page``; the dense
    engine's widest identity table (the top window rung), and an int8
    draft's on either layout, ``max_len / page`` columns of its view page
    (``llama.dense_page``), which must be one of ``DENSE_VIEW_PAGES``, the
    pages the kernel's checks on the card hold it at. The plain versions
    the CPU runs take any of these."""
    out = []
    int8_draft = draft_cfg is not None and draft_cfg.kv_int8
    models = [("model", cfg, ragged_mod)]
    if draft_cfg is not None:
        models.append(("draft", draft_cfg,
                       ragged_mod if int8_draft else decode_mod))
    for name, c, mod in models:
        if c.dtype != torch.bfloat16:
            out.append(f"{name} dtype {c.dtype}: the kernels take bf16")
        if c.head_dim not in mod.SUPPORTED_HEAD_DIMS:
            out.append(f"{name} head_dim {c.head_dim}: the kernels take "
                       f"{mod.SUPPORTED_HEAD_DIMS}")
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
    dense = llama.dense_page(max_len)
    if (not paged_kv or int8_draft) and dense not in DENSE_VIEW_PAGES:
        out.append(f"dense view page {dense} (max_len {max_len}): the "
                   f"ragged kernel is held to its gates at pages "
                   f"{DENSE_VIEW_PAGES}; max_len must be a multiple "
                   f"of {min(DENSE_VIEW_PAGES)}")
    # the ragged kernel's tables: the target's at g_len queries a slot, an
    # int8 draft's identity tables at one
    tables = [(cfg, kv_page if paged_kv else dense, g_len)]
    if int8_draft:
        tables.append((draft_cfg, dense, 1))
    for c, page, g in tables:
        if c.n_heads % c.n_kv_heads or g > ragged_mod.MAX_VERIFY_TOKENS:
            continue
        width = max_len // page
        smem = ragged_mod.dyn_smem_bytes(width, page,
                                         c.n_heads // c.n_kv_heads, g,
                                         c.head_dim)
        if smem > ragged_mod.MAX_DYN_SMEM:
            out.append(f"a table of {width} columns of {page} at "
                       f"{g} queries a slot needs {smem} bytes of "
                       f"shared memory, over MAX_DYN_SMEM = "
                       f"{ragged_mod.MAX_DYN_SMEM}")
    return out


def _prefill_key(nb: int, bucket: int, p_rung: int, biased: bool,
                 layout: List[Tuple[str, tuple]]) -> _PrefillKey:
    """The rung of a prefill group, its draft bucket read off the
    layout."""
    db = dict(layout).get("draft_tokens", (0, 0))[1]
    return (int(nb), int(bucket), int(p_rung), bool(biased), int(db))


def _prefill_kind(key: _PrefillKey) -> str:
    """The JAX executable family a prefill rung's graph stands for."""
    if key[2]:
        return "suffix_prefill"
    return "prefill_bias" if key[3] else "prefill"


def _insert_rows(leaf: torch.Tensor, src: torch.Tensor, row: torch.Tensor,
                 claimed: torch.Tensor, at: int) -> None:
    """Write each claimed slot's row of ``src`` (L, nb, w, ...) into
    ``leaf`` (L, max_slots, T, ...) at positions [at, at + w), in place;
    slot ``s`` takes row ``row[s]`` where ``claimed[s]``, and every other
    slot keeps what it holds (JAX's ``.at[:, slots].set(mode="drop")``
    with no duplicate destination and no index out of range)."""
    view = leaf[:, :, at:at + src.shape[2]]
    mask = claimed.view(1, -1, *([1] * (leaf.dim() - 2)))
    view.copy_(torch.where(mask, src[:, row], view))


def _words(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor``, a bf16 one viewed as its 16-bit words (numpy has no
    bf16 type, and a pinned slab is read through numpy)."""
    return tensor.view(torch.int16) if tensor.dtype == torch.bfloat16 \
        else tensor


def _wire_words(dtype: np.dtype) -> np.dtype:
    """The numpy type of a KV leaf on the wire: a bf16 leaf fetched as
    ``int16`` words is carried as ``uint16`` words
    (:func:`~gofr_tpu_torch.tpu.kv_wire._resolve_dtype`)."""
    return np.dtype(np.uint16) if dtype == np.int16 else dtype


def _torch_dtype(leaf: np.ndarray, payload) -> torch.dtype:
    """The torch type of a wire leaf's bytes: bf16 for the raw codec's
    ``bfloat16`` words, else the numpy type's."""
    if payload.codec == kv_wire.CODEC_RAW and payload.dtype == kv_wire.BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty((0,), leaf.dtype)).dtype


def _pack(arrays: Dict[str, np.ndarray]
          ) -> Tuple[np.ndarray, List[Tuple[str, tuple]]]:
    """Named int arrays as one flat int32 array (one staged upload, a
    4-byte type the coalescer takes) and the layout :func:`_unpack` cuts
    it by. Values past int32 wrap (a 32-bit seed); the body reads them
    back modulo 2**32."""
    layout = [(name, arr.shape) for name, arr in arrays.items()]
    flat = np.concatenate([np.asarray(arr, np.int64).ravel()
                           for arr in arrays.values()]).astype(np.int32)
    return flat, layout


def _unpack(flat: torch.Tensor,
            layout: List[Tuple[str, tuple]]) -> Dict[str, torch.Tensor]:
    """Views of ``flat`` by the layout :func:`_pack` returned."""
    out, at = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].view(shape)
        at += n
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
    not iteration ever started. Under ``coalesce_stream`` the engine puts
    one list of tokens a tick on the queue; iteration drains it token by
    token, so a consumer sees the same sequence either way, and
    :meth:`chunks` yields the lists (JAX ``TokenStream``)."""

    __slots__ = ("_engine", "_queue", "_future", "_done", "_buffer")

    def __init__(self, engine: "GenerationEngine", queue: asyncio.Queue,
                 future: asyncio.Future):
        self._engine = engine
        self._queue = queue
        self._future = future
        self._done = False
        self._buffer: List[int] = []

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._buffer:
            return self._buffer.pop(0)
        if self._done:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _DONE:
            self._finish()
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self._finish()
            raise item
        if isinstance(item, list):
            self._buffer = item[1:]
            return item[0]
        return item

    async def chunks(self):
        """Iterate token deltas: each list is every token that landed
        since the last yield (one tick's under ``coalesce_stream``)."""
        while True:
            if self._buffer:
                chunk, self._buffer = self._buffer, []
                yield chunk
                continue
            if self._done:
                return
            item = await self._queue.get()
            if item is _DONE:
                self._finish()
                return
            if isinstance(item, BaseException):
                self._finish()
                raise item
            chunk = item if isinstance(item, list) else [item]
            # drain whatever else already arrived: one yield a wakeup
            while True:
                try:
                    extra = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if extra is _DONE:
                    yield chunk
                    self._finish()
                    return
                if isinstance(extra, BaseException):
                    yield chunk
                    self._finish()
                    raise extra
                chunk.extend(extra if isinstance(extra, list) else [extra])
            yield chunk

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


class _Flight:
    """A request's observability context from submit to finish (JAX
    ``_Flight``): the span that identifies the request (the caller's
    current span, else the ``queue.wait`` span), the open ``queue.wait``
    span, and its flight-recorder record."""
    __slots__ = ("link_span", "qspan", "record")

    def __init__(self, link_span: Optional[Span], qspan: Optional[Span],
                 record: RequestRecord):
        self.link_span = link_span
        self.qspan = qspan
        self.record = record


class _Request:
    __slots__ = ("prompt", "bucket", "budget", "eos_id", "sampling",
                 "future", "queue", "submitted_at", "cls", "grammar",
                 "deadline", "flight")

    def __init__(self, prompt, bucket, budget, eos_id, sampling, future,
                 queue, cls, grammar, deadline,
                 flight: Optional[_Flight] = None):
        self.prompt = prompt
        self.bucket = bucket
        self.budget = budget
        self.eos_id = eos_id
        self.sampling = sampling
        self.future = future
        self.queue = queue
        self.submitted_at = time.monotonic()
        self.cls = cls              # SLO class (tpu/sched.deadline_class)
        self.grammar = grammar      # CompiledGrammar, or None
        self.deadline = deadline    # absolute monotonic, or None
        # spans and record (a bare record, no spans, when none was given)
        self.flight = flight or _Flight(None, None, RequestRecord(
            prompt_len=len(prompt), budget=budget))


class _Slot:
    __slots__ = ("future", "remaining", "eos_id", "tokens", "active", "gen",
                 "inflight", "queue", "temperature", "fill", "submitted_at",
                 "pages", "nodes", "grammar", "cls", "deadline", "record",
                 "req_span", "phase_span", "spec_proposed", "spec_accepted",
                 "migrating")

    def __init__(self):
        self.migrating = False  # quiescing for export: joins no new tick
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
        self.nodes: List[Any] = []   # paged: pinned prefix-trie nodes
        self.grammar: Optional[GrammarWalker] = None   # constrained decoding
        self.cls = "batch"            # SLO class (tpu/sched.deadline_class)
        self.deadline: Optional[float] = None   # absolute monotonic
        self.record: Optional[RequestRecord] = None   # flight recorder
        self.req_span: Optional[Span] = None     # request span (link target)
        self.phase_span: Optional[Span] = None   # open prefill/decode span
        self.spec_proposed = 0        # draft tokens proposed for it
        self.spec_accepted = 0        # ... and kept


class _Fetch:
    """One dispatched step whose host copy is in flight: ``task`` resolves
    to its tokens; ``kind`` is prefill, tick or spec; ``payload`` what
    they publish against. ``span`` is the open engine-step span, finished
    at publish; ``dispatched_at`` (when the step was queued for the
    device) starts the dispatch-to-publish window charged to the
    participants' SLO classes and to ``family``, the executable family;
    ``anatomy`` is a sampled tick's phase split (None unsampled),
    completed with the device wait at publish."""
    __slots__ = ("task", "kind", "payload", "span", "dispatched_at",
                 "anatomy", "family")

    def __init__(self, task, kind: str, payload,
                 span: Optional[Span] = None,
                 family: Optional[str] = None):
        self.task = task
        self.kind = kind
        self.payload = payload
        self.span = span
        self.dispatched_at = time.monotonic()
        self.anatomy: Optional[Dict[str, Any]] = None
        self.family = family


class _Graph:
    """A captured tick: the graph, its static token output, the kernel
    launches one replay makes and the seconds its capture took."""
    __slots__ = ("graph", "out", "launches", "seconds")

    def __init__(self, graph, out, launches, seconds):
        self.graph = graph
        self.out = out
        self.launches = launches
        self.seconds = seconds


class _Prefill:
    """A prefill rung: its static upload buffers (``ints`` int32 cut by
    ``layout``, ``floats``; with ``coalesce_uploads`` both views of one
    ``arena``), and on the card its graph, the graph's
    static first-token output, the launches one replay makes, the seconds
    its capture took and its replays."""
    __slots__ = ("key", "layout", "ints", "floats", "arena", "graph",
                 "first", "launches", "seconds", "replays")

    def __init__(self, key: _PrefillKey, layout, ints, floats, arena=None):
        self.key = key
        self.layout = layout
        self.ints = ints
        self.floats = floats
        self.arena = arena        # the uint8 buffer both view, coalesced
        self.graph = None
        self.first: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.seconds = 0.0
        self.replays = 0


def _k_rungs(steps_per_tick: int) -> List[int]:
    """The fused-steps ladder 1, 2, 4, ... <= ``steps_per_tick``."""
    rungs = [1]
    while rungs[-1] * 2 <= steps_per_tick:
        rungs.append(rungs[-1] * 2)
    return rungs


def _tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a (nested) dict or list, a sharded leaf's
    every shard; 0 for None."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_tree_bytes(leaf) for leaf in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(leaf) for leaf in tree)
    if isinstance(tree, Sharded):
        return tree.nbytes()
    return tree.numel() * tree.element_size()


def _sharded_leaves(tree: Any) -> List[Sharded]:
    """Every sharded leaf of a tree."""
    if isinstance(tree, Sharded):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for val in tree.values()
                for leaf in _sharded_leaves(val)]
    return []


def _heads_cat(trees: Any) -> Dict[str, torch.Tensor]:
    """The tp ranks' leaves joined along the kv-head axis (dim 3 of every
    (L, B, T, Hkv, ...) leaf): the full leaves; a plain tree as it is."""
    if isinstance(trees, dict):
        return trees
    return {name: torch.cat([tree[name] for tree in trees], dim=3)
            for name in trees[0]}


class _MeshPlan:
    """The engine over a single-controller mesh (``parallel/mesh``):
    slots split over the ``dp`` rows (row d holds slots ``[d * m, (d + 1)
    * m)``, m = max_slots / dp), each row's heads, FFN and vocab over its
    ``tp`` ranks. Params are sharded by ``llama_param_specs`` (int8
    weights by ``quantized_specs``), the dense cache by
    ``llama_cache_specs``, the page pool and the prefix store's by
    ``llama_prefix_pool_specs`` (``parallel/sharding``); each row runs the
    model over its ranks' trees with the all-reduces between them
    (``models/llama.TPShards``). Prefills run on row 0 and insert into
    the claimed slots' rows; a tick runs every row over its slots and
    samples every slot on the controller (the first coordinate's
    device), where the engine's slot state lives.

    Refused at construction, with a ValueError naming the quantity: what
    ``parallel/mesh.check_one_card`` refuses (not a ``Mesh``, devices of
    another type than the engine's, distinct cards: a tick is one CUDA
    graph on one device, so a card engine's shards share it;
    ``xlaz()["mesh"]`` says how many distinct devices the mesh holds);
    a mesh whose devices span processes; axes other than dp and tp
    larger than 1; a tp that does not divide n_heads, n_kv_heads,
    ffn_dim or vocab_size."""

    def __init__(self, mesh, cfg, device: torch.device):
        if isinstance(mesh, Mesh) and mesh.process_count > 1:
            raise ValueError(
                f"mesh: its devices span {mesh.process_count} processes "
                f"(a dcn axis larger than 1); the engine drives the "
                f"devices of its own process only")
        check_one_card(mesh, device, "engine")
        extra = {axis: size for axis, size in mesh.shape.items()
                 if axis not in ("dp", "tp") and size > 1}
        if extra:
            raise ValueError(f"mesh: axes {extra}: the engine shards slots "
                             f"over dp and heads over tp only")
        self.dp = int(mesh.shape.get("dp", 1))
        self.tp = int(mesh.shape.get("tp", 1))
        for name in ("n_heads", "n_kv_heads", "ffn_dim", "vocab_size"):
            value = getattr(cfg, name)
            if value % self.tp:
                raise ValueError(f"mesh: tp {self.tp} does not divide "
                                 f"{name} {value}")
        self.mesh = mesh
        self.cfg = cfg
        self.lines = mesh.axis_coords("tp")
        self.groups = [Group([mesh.devices[c] for c in line])
                       for line in self.lines]

    def shard_params(self, params):
        """``params`` sharded over the mesh (already sharded ones, a
        shadow clone's, as they are)."""
        if is_sharded(params):
            return params
        specs = prune_specs(quantized_specs(llama_param_specs(), params),
                            self.mesh)
        return shard_pytree(params, self.mesh, specs)

    def row_params(self, sharded) -> List[Any]:
        """Each dp row's ``TPShards``: its ranks' param trees and the
        collectives between them."""
        return [llama.TPShards([local_tree(sharded, c) for c in line], group)
                for line, group in zip(self.lines, self.groups)]

    def init_cache(self, slots: int, max_len: int):
        """The dense cache sharded by ``llama_cache_specs``: each
        coordinate's (L, slots / dp, T, Hkv / tp, D) made on its
        device."""
        mesh = self.mesh
        rank_cfg = llama.rank_config(self.cfg, self.tp)
        specs = prune_specs(llama_cache_specs(kv_int8=self.cfg.kv_int8),
                            mesh)
        return assemble(mesh, specs, lambda coord: llama.init_cache(
            rank_cfg, slots // self.dp, max_len, device=mesh.devices[coord]))

    def row_caches(self, cache) -> List[Any]:
        """Each dp row's caches, its ranks' trees."""
        return [[local_tree(cache, c) for c in line] for line in self.lines]

    def small_cache(self, batch: int, length: int) -> List[Any]:
        """A prefill's small caches on row 0's ranks."""
        rank_cfg = llama.rank_config(self.cfg, self.tp)
        return [llama.init_cache(rank_cfg, batch, length, device=dev)
                for dev in self.groups[0].devices]


def _params_to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {key: _params_to(val, device) for key, val in params.items()}
    return params.to(device)


class GenerationEngine:
    """The engine; its keyword arguments are the JAX engine's, in its
    order, with its defaults, meanings, checks and messages, then
    ``device`` (the card unless the caller asks for the CPU). ``mesh``
    (a ``parallel/mesh.Mesh`` of ``device``'s type) serves dp × tp
    (:class:`_MeshPlan`). ``model_module`` serves
    any module with llama's ``init_cache`` / ``prefill`` /
    ``decode_step`` (``models/moe``), with JAX's refusals for one that is
    not llama. ``page_pool`` shares one :class:`PagePool` between paged
    engines of one KV geometry; ``kv_pool_bytes`` sizes the engine's own.
    ``ragged_attn`` (``auto`` | ``on`` | ``off``): the paged engine's
    decode and verify attend through the ragged wrappers unless ``off``,
    which asks for JAX's gather formulation over the gather-width rungs.
    ``coalesce_uploads`` ships a prefill's, and a tick's, 4-byte control
    arrays as one transfer (``tpu/staging.TransferCoalescer``);
    ``coalesce_stream`` puts a tick's tokens on a stream's queue as one
    list."""

    def __init__(self, cfg, params, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 prompt_buckets=DEFAULT_PROMPT_BUCKETS,
                 steps_per_tick: int = 1,
                 max_inflight_ticks: int = 2,
                 mesh=None,
                 window_ladder: Optional[bool] = None,
                 prefix_cache: bool = False,
                 prefix_cache_bytes: int = 64 << 20,
                 prefix_page: int = 32,
                 paged_kv: bool = False,
                 kv_page: int = 32,
                 kv_pages: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None,
                 kv_page_reserve: Optional[int] = None,
                 page_pool: Optional[PagePool] = None,
                 ragged_attn: str = "auto",
                 model_module=None,
                 model_name: str = "generate",
                 draft_cfg=None, draft_params=None,
                 spec_gamma: int = 4,
                 class_weights: Optional[Dict[str, float]] = None,
                 coalesce_uploads: bool = False,
                 coalesce_stream: bool = False,
                 token_table=None,
                 grammar_cache_entries: int = 32,
                 logger=None, metrics=None, tracer=None, recorder=None,
                 slo=None, device: Union[str, torch.device] = "cuda"):
        # the served model module: llama by default; anything with llama's
        # serving contract (init_cache / prefill / decode_step) plugs in,
        # models/moe.py first (JAX ``self._llama``)
        self._model = llama if model_module is None else model_module
        if model_module is not None and model_module is not llama:
            missing = [name for name in ("init_cache", "prefill",
                                         "decode_step")
                       if not hasattr(model_module, name)]
            if missing:
                raise ValueError(
                    f"model_module lacks serving entry points {missing}")
            if mesh is not None:
                raise ValueError(
                    "model_module: sharding specs are llama-specific; "
                    "custom model modules serve unsharded (mesh=None)")
            if paged_kv and not hasattr(model_module, "decode_step_paged"):
                raise ValueError(
                    "paged_kv requires the model module to implement "
                    "decode_step_paged")
            if prefix_cache:
                raise ValueError(
                    "prefix_cache requires the llama model module")
            if draft_cfg is not None:
                raise ValueError(
                    "speculative decode requires the llama model module "
                    "(the target verify step)")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_name = str(model_name)
        # dp × tp over a single-controller mesh: slots split over dp rows,
        # each row's heads and ffn over its tp ranks (_MeshPlan)
        self._plan = _MeshPlan(mesh, cfg, self.device) \
            if mesh is not None else None
        if self._plan is not None:
            dp = self._plan.dp
            max_slots = -(-int(max_slots) // dp) * dp  # round up: dp-divisible
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.max_len)
        if not self.prompt_buckets:
            raise ValueError("no prompt bucket fits max_len")
        # fused-steps ladder 1, 2, 4, ... <= steps_per_tick
        self.steps_per_tick = max(1, int(steps_per_tick))
        self._k_ladder = _k_rungs(self.steps_per_tick)
        # admission-count ladder 1, 2, 4, ... with max_slots the top rung
        self._n_ladder = [1]
        while self._n_ladder[-1] * 2 <= self.max_slots:
            self._n_ladder.append(self._n_ladder[-1] * 2)
        if self._n_ladder[-1] != self.max_slots:
            self._n_ladder.append(self.max_slots)
        # the operating point (JAX's): serving knobs move only through
        # apply_operating_point. slots_cap caps admission below max_slots
        # (the state and the graphs stay sized by max_slots; a tick runs
        # over every row under its mask). _op_prewarmed holds the shape
        # signatures (prompt_buckets, steps_per_tick) whose graphs exist
        # or are captured lazily as before this plane: the seed's
        self.slots_cap: Optional[int] = None
        self._op_source = "seed"
        self._op_generation = 0
        self._op_applied_at: Optional[float] = None
        self._op_prewarmed = {(self.prompt_buckets, self.steps_per_tick)}
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
            if mesh is not None and self._plan.dp > 1:
                raise ValueError(
                    "paged_kv: the shared page pool cannot shard pages "
                    "over dp (any slot may gather any page); use a "
                    "tp-only mesh")
        self.logger = logger
        # -- telemetry hooks (JAX's, duck-typed): metrics, spans (None:
        # off), the flight recorder (always on), the SLO tracker; the
        # prompt-bucket fit, device seconds by (model, class) and by
        # executable family are always kept
        self.metrics = metrics
        self.tracer = tracer
        self.recorder: FlightRecorder = recorder or FlightRecorder()
        self.slo = slo
        self.shapes = ShapeStats(metrics)
        self.exec_ledger = ExecutableLedger(metrics=metrics)
        self._device_seconds: Dict[Tuple[str, str], float] = {}
        # the sampled tick anatomy: None until attach_telemetry; every
        # ``_tick_every``-th dispatched tick carries its phase split
        self.telemetry = None
        self._tick_seq = 0
        self._tick_every = 64
        # the workload recorder: None until attach_workload
        self.workload = None
        self._steps = 0               # ticks dispatched (plain and spec)
        # compiles: one graph capture each (warmup class inside warmup(),
        # serving class otherwise), noted on the loop thread when the
        # capture is queued
        self._warming = 0
        # keys captured or queued to be (on the CPU: run or queued to be)
        self._compiled: set = set()
        self._compile_events: List[Tuple[float, str, str]] = []
        self._compiles_by_class = {"warmup": 0, "serving": 0}
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
        if self.spec and mesh is not None:
            raise ValueError(
                "speculative decode does not compose with a mesh yet "
                "(the draft has no sharding specs)")
        if self.device.type == "cuda":
            # a tp rank's kernels run at its own heads: judge its geometry
            refused = cuda_refusals(
                llama.rank_config(cfg, self._plan.tp) if self._plan
                else cfg, self.max_len, self.kv_page,
                draft_cfg if self.spec else None, self.spec_gamma,
                paged_kv=self.paged)
            if refused:
                raise ValueError("the card's kernels refuse this "
                                 "configuration: " + "; ".join(refused))
        dev, n = self.device, self.max_slots
        if self._plan is None:
            self.params = _params_to(params, self.device)
            self._row_params: List[Any] = [self.params]
        else:
            self.params = self._plan.shard_params(params)
            self._row_params = self._plan.row_params(self.params)
        self._pool: Optional[PagePool] = None
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        self._shared_pool = False
        if self.paged:
            self.pages_per_slot = self.max_len // self.kv_page
            if page_pool is not None:
                # multi-model tenancy: engines of one KV geometry address
                # one pool, page ids interchangeable
                if page_pool.page != self.kv_page:
                    raise ValueError(
                        f"shared page_pool page size {page_pool.page} != "
                        f"engine kv_page {self.kv_page}")
                if PagePool._page_bytes(cfg, self.kv_page) \
                        != page_pool.page_bytes:
                    raise ValueError(
                        "shared page_pool KV geometry does not match this "
                        "engine's config (layers/kv-heads/head-dim/dtype "
                        "must agree; heterogeneous models need their own "
                        "pools carved from an HBMBudget)")
                if page_pool.mesh is not mesh:
                    raise ValueError(
                        "shared page_pool is laid out over another mesh "
                        "than this engine's (engines sharing a pool share "
                        "its mesh)")
                self._pool = page_pool
                self._shared_pool = True
            elif kv_pages is not None:
                self._pool = PagePool(cfg, page=self.kv_page,
                                      num_pages=int(kv_pages), device=dev,
                                      mesh=mesh, metrics=metrics)
            elif kv_pool_bytes is not None:
                self._pool = PagePool(cfg, page=self.kv_page,
                                      budget_bytes=int(kv_pool_bytes),
                                      device=dev, mesh=mesh, metrics=metrics)
            else:
                # capacity parity with the dense cache
                self._pool = PagePool(
                    cfg, page=self.kv_page,
                    num_pages=self.max_slots * self.pages_per_slot,
                    device=dev, mesh=mesh, metrics=metrics)
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
            # a co-resident's reset of a shared pool: this engine's page
            # ids dangle (JAX ``_on_pool_reset``); ``_pool_epoch`` is the
            # pool epoch this engine's host state belongs to
            self._in_pool_reset = False
            self._pool_epoch = self._pool.epoch
            self._pool.subscribe(self._on_pool_reset)
            self._row_caches: List[Any] = []
        else:
            if self._plan is None:
                self.cache = self._model.init_cache(cfg, n, self.max_len,
                                                    device=dev)
                self._row_caches = [self.cache]
            else:
                self.cache = self._plan.init_cache(n, self.max_len)
                self._row_caches = self._plan.row_caches(self.cache)
            # the target reads its cache through the ragged kernels over
            # one identity page table a window rung, each contiguous at a
            # fixed address (a captured graph holds it); a dp row's table
            # covers its own slots
            rows = n // self._dp
            self._tables = {w: llama.identity_table(rows, self.max_len, w,
                                                    device=dev)
                            for w in self._window_ladder}
        self._table_version = 0     # moves with the paged host table
        # ragged paged attention (JAX ``ragged_attn``): "auto" and "on"
        # read the pool through the ragged wrappers (the kernel on the
        # card, its plain version on the CPU); "off" asks for the gather
        # formulation over the gather-width rungs (table columns = window
        # rung / kv_page), which is what it serves: it is never taken in
        # a kernel's place
        self.ragged_attn = str(ragged_attn).lower()
        if self.ragged_attn not in ("auto", "on", "off"):
            raise ValueError(
                f"ragged_attn must be auto|on|off, got {ragged_attn!r}")
        if self.ragged_attn == "on" and not self.paged:
            raise ValueError("ragged_attn='on' requires paged_kv=True "
                             "(the kernel walks the page pool)")
        self._ragged = self.paged and self.ragged_attn != "off"
        # zero-copy data plane: a prefill's and a tick's 4-byte control
        # arrays as one transfer (bit-exact: views of one buffer), a
        # tick's tokens as one stream item
        self.coalesce_uploads = bool(coalesce_uploads)
        self.coalesce_stream = bool(coalesce_stream)

        # -- prefix KV reuse: the store and the prefix-pages ladder 1, 2,
        # 4, ... plus the largest bucket's pages; a cached prefix rounds
        # down to a rung and the rest rides the suffix
        self._prefix: Optional[PrefixStore] = None
        self._p_ladder: List[int] = []
        if prefix_cache:
            if self.paged:
                # one pool: a prefix page is a decode page, so a hit is a
                # page-table entry and not a copy
                prefix_page = self.kv_page
            max_pages = max(self.prompt_buckets) // int(prefix_page)
            if max_pages > 0:
                self._p_ladder = [1]
                while self._p_ladder[-1] * 2 <= max_pages:
                    self._p_ladder.append(self._p_ladder[-1] * 2)
                if self._p_ladder[-1] != max_pages:
                    self._p_ladder.append(max_pages)
                self._prefix = PrefixStore(
                    cfg, page=int(prefix_page),
                    budget_bytes=prefix_cache_bytes, max_pages=max_pages,
                    pool=self._pool, device=dev, mesh=mesh)
            elif logger is not None:
                logger.warning(
                    "prefix cache disabled: page size %d exceeds the "
                    "largest prompt bucket %d", prefix_page,
                    max(self.prompt_buckets))

        # -- speculative draft-verify decode ---------------------------------
        self.draft_cfg = None
        self.draft_params = None
        self._draft_cache: Optional[Dict[str, torch.Tensor]] = None
        self._draft_tables: Dict[Optional[int], torch.Tensor] = {}
        self._g_ladder: List[int] = []
        if self.spec:
            if getattr(draft_cfg, "vocab_size", None) != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({getattr(draft_cfg, 'vocab_size', None)} vs "
                    f"{cfg.vocab_size})")
            # a bf16 draft decodes through the flash-decode kernel, over
            # the tick's window in the dense engine; a kv_int8 draft (JAX
            # serves it as given) through the ragged kernel's int8
            # instantiation over its own identity tables, one a window
            # rung, as the dense target reads its cache
            self.draft_cfg = dataclasses.replace(
                draft_cfg, use_flash_decode=not draft_cfg.kv_int8)
            self.draft_params = _params_to(draft_params, self.device)
            # the draft cache is dense: the draft is small, and one
            # (max_slots, max_len) row per slot keeps it independent of
            # the target's paging; the draft prefills the full prompt, so
            # it shares the target's cache_len
            self._draft_cache = llama.init_cache(draft_cfg, self.max_slots,
                                                 self.max_len,
                                                 device=self.device)
            if draft_cfg.kv_int8:
                self._draft_tables = {
                    w: llama.identity_table(n, self.max_len, w, device=dev)
                    for w in self._window_ladder}
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
        # the grammar bias a "bias" tick adds to its logits, uploaded in
        # stream order ahead of each such tick; paged, the page table
        # too; with coalesce_uploads both views of one arena, so a biased
        # tick that moves the table uploads them in one transfer
        self._tick_arena: Optional[torch.Tensor] = None
        bias_spec = ((n, cfg.vocab_size), torch.float32)
        if self.paged and self.coalesce_uploads:
            self._tick_arena, (self.table, self.bias) = \
                TransferCoalescer.arena(dev, [
                    ((n, self.pages_per_slot), torch.int32), bias_spec])
            self.table.fill_(self._pool.sentinel)
        else:
            self.bias = torch.zeros(bias_spec[0], dtype=torch.float32,
                                    device=dev)
            if self.paged:
                self.table = torch.full((n, self.pages_per_slot),
                                        self._pool.sentinel,
                                        dtype=torch.int32, device=dev)
        self._sent_mask: Optional[bytes] = None   # last uploaded mask
        self._sent_table = -1                     # last uploaded version

        # -- tick executables and the pipeline ----------------------------
        self.max_inflight_ticks = max(1, int(max_inflight_ticks))
        self._staging = StagingPool(self.device,
                                    depth=self.max_inflight_ticks + 1)
        self._coalescer = TransferCoalescer(self._staging)
        self._own_exec: Optional[ThreadPoolExecutor] = None
        self._graphs: Dict[_Key, _Graph] = {}
        self._graph_pool = None
        self.capture_s = 0.0
        self.graph_replays = 0
        self.lazy_captures = 0     # captures made while serving
        # prefill rungs: static buffers, and on the card their graphs, in
        # the ticks' graph pool
        self._prefills: Dict[_PrefillKey, _Prefill] = {}
        self.prefill_lazy_captures = 0
        self.export_lazy_captures = 0   # export rungs captured serving
        self._publishq: "deque[_Fetch]" = deque()
        self._ticks_inflight = 0
        self._ticks_inflight_peak = 0

        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._free: List[int] = list(range(self.max_slots))
        # -- admission: SLO-class weighted-fair queues (every admitted slot
        # rides every tick, so WFQ at this gate is the per-class share of
        # the ticks); requests a paged pass could not give pages wait in
        # the overflow, ahead of the queues, up to a cap past which the
        # deepest class sheds its newest
        self.class_weights = dict(class_weights or DEFAULT_CLASS_WEIGHTS)
        self._pending = ClassQueues(self.class_weights)
        self._overflow: "deque[_Request]" = deque()
        self._overflow_cap = max(16, 4 * self.max_slots)
        self._shed_by_class: Dict[str, int] = {}
        self._brownout = 0
        self._quarantined: Dict[str, int] = {}
        # -- grammar-constrained decoding: compiled grammars cached per
        # canonical source, bias rows per (grammar, state); the token
        # byte table defaults to the raw-byte identity (ids 0..255 are
        # bytes, the base of the repo's byte-level BPE)
        self._token_table = (list(token_table) if token_table is not None
                             else token_byte_table(vocab_size=cfg.vocab_size))
        self.grammar_cache = GrammarCache(self._token_table,
                                          max_entries=grammar_cache_entries)
        self._constrained_requests = 0
        self._constrained_ticks = 0
        self._cancelled_queues: set = set()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake = asyncio.Event()
        # run counters: what the kernels' launch counts are checked against
        self.prefill_dispatches = 0
        self.prefill_bucket_tokens = 0   # bucket rows x columns prefilled
        self.prefill_real_tokens = 0     # the prompt tokens inside them
        self._page_stalls = 0    # slots that sat a tick out for want of pages
        self.suffix_prefill_dispatches = 0   # prefills over a cached prefix
        self.prefix_admissions: Dict[int, int] = {}   # requests by rung
        self.decode_steps = 0         # plain decode steps (ragged decode)
        self.ticks = 0                # plain decode ticks
        self.spec_rungs: Dict[int, int] = {}  # spec ticks run, by g
        self.draft_steps = 0          # Σ(g + 1) draft steps (flash decode)
        # ticks run (plain and spec), by window rung
        self.window_ticks: Dict[Optional[int], int] = {}
        self.ttfts: "deque[float]" = deque(maxlen=4096)  # submit → 1st token
        # -- disaggregated handoff (JAX's counters): prompt KV exported and
        # adopted, live sessions exported and resumed; the export rungs by
        # bucket; the adopt dedupe ledger {id: (monotonic, stream)}
        self._kv_exports = 0
        self._kv_adoptions = 0
        self._session_exports = 0
        self._session_adoptions = 0
        self._exports: Dict[int, _Prefill] = {}
        self._adopt_ledger: Dict[str, Tuple[float, "TokenStream"]] = {}
        self._adopt_dedup_hits = 0

    # -- device steps (the device thread) --------------------------------------
    def _prefill_rung(self, key: _PrefillKey,
                      layout: List[Tuple[str, tuple]],
                      n_floats: int) -> "_Prefill":
        """The rung ``key``'s static upload buffers (made at its first
        use: an int32 buffer cut by ``layout``, a float32 one of
        ``n_floats``; with ``coalesce_uploads`` two views of one arena)."""
        rung = self._prefills.get(key)
        if rung is None:
            size = sum(int(np.prod(shape)) for _, shape in layout)
            specs = [((size,), torch.int32), ((n_floats,), torch.float32)]
            arena = None
            if self.coalesce_uploads:
                arena, (ints, floats) = TransferCoalescer.arena(self.device,
                                                                specs)
            else:
                ints, floats = (torch.zeros(shape, dtype=dtype,
                                            device=self.device)
                                for shape, dtype in specs)
            rung = _Prefill(key, layout, ints, floats, arena)
            self._prefills[key] = rung
        return rung

    def _upload_prefill(self, rung: "_Prefill", ints: np.ndarray,
                        floats: np.ndarray) -> None:
        """A prefill group's two arrays into the rung's buffers, in stream
        order: one coalesced transfer of its arena with
        ``coalesce_uploads``, else one upload each (JAX
        ``_upload_group``)."""
        self._coalescer.upload(rung.arena, [(rung.ints, ints),
                                            (rung.floats, floats)])

    def _prefill_insert(self, nb: int, bucket: int, n_claimed: int,
                        p_rung: int, ints: np.ndarray,
                        layout: List[Tuple[str, tuple]], floats: np.ndarray,
                        biased: bool = False, epoch: Optional[int] = None):
        """The host part of one group's prefill: upload ``ints`` (the
        named int arrays of ``layout``, :func:`_pack`) and ``floats``
        (temps, top_ps and, ``biased``, the (nb, vocab) grammar bias rows)
        into the rung's static buffers, in stream order behind every step
        queued before, then run :meth:`_prefill_body` over them: on the
        card a replay of the rung's graph (captured first if the rung was
        not warmed), on the CPU eagerly. ``n_claimed`` is the group's
        count of real rows; nothing reads it, padding rows write nothing
        whatever their count. ``epoch`` is the pool epoch the group was
        claimed in (paged): if a co-resident engine reset the shared pool
        since, the group's pages are gone, and its rows run as padding
        (no slot claimed, sentinel pages) for callers the reset fails.
        Returns the fetch of the first tokens (nb,)."""
        key = _prefill_key(nb, bucket, p_rung, biased, layout)
        rung = self._prefill_rung(key, layout, floats.size)
        cuda = self.device.type == "cuda"
        if cuda and rung.graph is None:
            self._capture_prefill(rung)
            self.prefill_lazy_captures += 1
        if self._stale(epoch):
            ints, _ = _pack(self._group_arrays(*key[:3], key[4]))
            floats = self._group_floats(nb, biased)
        self._upload_prefill(rung, ints, floats)
        if not cuda:
            return self._staging.fetch(self._prefill_body(rung))
        rung.graph.replay()
        launch_counts.add(rung.launches)
        rung.replays += 1
        return self._staging.fetch(rung.first)

    def _prefill_forward(self, rung: "_Prefill"):
        """A prefill rung's prompt forward and first-token draw (JAX's
        ``_prefill_fn`` / ``_suffix_prefill_fn`` / ``_prefill_bias_fn``),
        read off the rung's buffers: the small caches made here, the
        prompts run through the model (at prefix rung > 0 over the cached
        prefix gathered from the store), a biased rung's bias rows added
        to the logits, and each row's first token sampled with the key
        made from its seed. Returns (the int arrays by name, the small
        caches, the first tokens (nb,), the advanced keys (nb, 2), the
        gathered prefix or None, the prefix length)."""
        nb, bucket, p_rung, biased, _ = rung.key
        dev, cfg = self.device, self.cfg
        arg = {name: arr.long()
               for name, arr in _unpack(rung.ints, rung.layout).items()}
        tokens, lens = arg["tokens"], arg["lengths"]
        temps, top_ps = rung.floats[:2 * nb].view(2, nb)
        small = self._model.init_cache(cfg, nb, bucket, device=dev) \
            if self._plan is None else self._plan.small_cache(nb, bucket)
        plen, prefix, kw = 0, None, {}
        if p_rung:
            plen = p_rung * self._prefix.page
            prefix = self._prefix.gather(arg["prefix_ids"])
            kw = dict(prefix=prefix, prefix_len=plen)
        logits, small, _ = self._model.prefill(self._row_params[0], cfg,
                                               tokens, small, lengths=lens,
                                               **kw)
        if biased:
            # bf16 + float32 promotes to float32, as in JAX
            logits = logits + rung.floats[2 * nb:].view(nb, cfg.vocab_size)
        first, keys = sample_batch(logits, temps, arg["top_ks"], top_ps,
                                   prng.seed_key(arg["seeds"]))
        return arg, small, first, keys, prefix, plen

    def _prefill_body(self, rung: "_Prefill") -> torch.Tensor:
        """One group's prompt forward and its in-place insert, as a
        function of the rung's static buffers and the engine's state
        alone (JAX's prefill + insert pair of the rung, with a draft its
        draft prefill + insert too): no shape or branch depends on the
        group, so one graph serves every group of the rung.

        The buffers hold, by ``rung.layout``: tokens (nb, bucket), lengths,
        top_ks, seeds (nb,), ``row_of_slot`` (max_slots,: the row that
        claims each slot, -1 for none); paged the page ids (nb * bucket //
        page, the sentinel for padding); at prefix rung > 0 the cached
        pages (nb, p_rung) and, with a draft, the whole prompts and their
        lengths (nb, db); dense with the store on, the ids of the pages to
        publish (the store's sentinel where none). Floats: temps, top_ps
        (nb,) and, biased, the (nb, vocab) grammar bias rows (0 for
        padding rows), added to the logits before the first token is
        sampled (JAX ``_prefill_bias_fn``).

        Full prefill: paged, the rows scatter into the pool pages
        (sentinel entries landing in the scratch page); dense, into the
        claimed slots' cache rows (JAX ``_insert_fn``), then the store
        publishes the new full pages. Suffix prefill: the tokens are the
        suffixes, attending the cached prefix gathered from the store's
        pool; paged, the suffix rows scatter into fresh pages after the
        prefix's; dense, the prefix pages fill rows [0, plen) and the
        suffix [plen, plen + bucket) (JAX ``_suffix_insert_fn``);
        cache_len is plen + the suffix's length. The dense insert, the
        draft's and the slot state go through ``torch.where`` over all
        ``max_slots`` rows by the slot→row map, so a slot no row claims
        keeps its bits. The small caches are allocated here (inside the
        graph, from its pool). Returns the first tokens (nb,)."""
        nb, bucket, p_rung, _, _ = rung.key
        dev, cfg = self.device, self.cfg
        arg, small, first, keys, prefix, plen = self._prefill_forward(rung)
        tokens, lens = arg["tokens"], arg["lengths"]
        temps, top_ps = rung.floats[:2 * nb].view(2, nb)
        claimed = arg["row_of_slot"] >= 0
        row = arg["row_of_slot"].clamp(min=0)
        # in-place insert of the group's KV; each leaf (k/v rows, int8
        # scale planes) keeps its own trailing shape
        if self.paged:
            page = self.kv_page
            for leaves, rows in zip(llama.rank_trees(self._pool_leaves()),
                                    llama.rank_trees(small)):
                for name, leaf in leaves.items():
                    leaf[:, arg["page_ids"]] = rows[name].reshape(
                        cfg.n_layers, nb * (bucket // page), page,
                        *rows[name].shape[3:])
        else:
            # each dp row's slots take their rows, into each of its ranks
            m = self.max_slots // self._dp
            prefixes = llama.rank_trees(prefix)
            smalls = llama.rank_trees(small)
            for d, caches in enumerate(self._row_caches):
                d_row, d_claimed = row[d * m:(d + 1) * m], \
                    claimed[d * m:(d + 1) * m]
                for r, cache in enumerate(llama.rank_trees(caches)):
                    for name, leaf in cache.items():
                        if p_rung:
                            _insert_rows(leaf, prefixes[r][name], d_row,
                                         d_claimed, 0)
                        _insert_rows(leaf, smalls[r][name], d_row,
                                     d_claimed, plen)
            if "publish_ids" in arg:
                self._prefix.publish(small, arg["publish_ids"],
                                     arg["publish_ids"].shape[0] // nb)
        if self.spec:
            # KV-only draft prefill of the whole prompts (the draft has no
            # prefix store) into the claimed slots' dense draft rows
            dtokens = arg.get("draft_tokens", tokens)
            dcfg = self.draft_cfg
            dsmall = llama.init_cache(dcfg, nb, dtokens.shape[1], device=dev)
            llama.prefill(self.draft_params, dcfg, dtokens, dsmall,
                          lengths=arg.get("draft_lengths", lens))
            for name, leaf in self._draft_cache.items():
                _insert_rows(leaf, dsmall[name], row, claimed, 0)
        for state, new in ((self.cache_len, (plen + lens).to(torch.int32)),
                           (self.last_token, first), (self.temps, temps),
                           (self.top_ks, arg["top_ks"]),
                           (self.top_ps, top_ps), (self.sample_keys, keys)):
            mask = claimed.view(-1, *([1] * (state.dim() - 1)))
            state.copy_(torch.where(mask, new[row], state))
        return first

    def _plain_tick(self, k: int, sampled: bool, window: Optional[int],
                    active: torch.Tensor,
                    biased: bool = False) -> torch.Tensor:
        """``k`` decode steps over every slot of the device state, updated
        in place (paged: ``llama.decode_step_paged``; dense: JAX
        ``_decode_fn``, the model module's ``decode_step`` over the window
        rung ``window`` and its identity table; paged under
        ``ragged_attn="off"``, the gather formulation over the window's
        gather width); inactive rows keep their
        cache_len, token and key. ``biased`` adds :attr:`bias` to each
        step's logits before the argmax or the sampler (JAX
        ``_decode_bias_fn`` / ``_decode_paged_bias_fn``): bf16 logits
        plus the float32 bias are float32, as in JAX. Returns the (k,
        max_slots) tokens."""
        token, cache_len, keys = self.last_token, self.cache_len, \
            self.sample_keys
        steps = []
        for _ in range(k):
            if self.paged:
                logits, _, new_len = llama.decode_step_paged(
                    self._row_params[0], self.cfg, token,
                    self._pool_leaves(), self._table_view(window),
                    cache_len, active, ragged=self._ragged)
            else:
                logits, new_len = self._dense_decode(token, cache_len,
                                                     window)
            if biased:
                logits = logits + self.bias
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
        # the paged engine's draft reads its whole dense cache (JAX
        # ``_spec_paged_fn``); a paged window rung is a gather width
        dwin = None if self.paged else window
        for i in range(g + 1):
            logits, _, new_len = llama.decode_step(
                self.draft_params, self.draft_cfg, token, self._draft_cache,
                dlen, window=dwin, table=self._draft_tables.get(dwin))
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
                self._table_view(window), cache_len, active,
                ragged=self._ragged)
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

    @property
    def _dp(self) -> int:
        """dp rows of the mesh (1 without one)."""
        return self._plan.dp if self._plan is not None else 1

    def _pool_leaves(self):
        """What the paged steps read and write: the pool's leaves, or over
        a mesh its tp ranks' (a list)."""
        return self._pool.leaves if self._plan is None \
            else self._pool.ranks()

    def _dense_decode(self, token: torch.Tensor, cache_len: torch.Tensor,
                      window: Optional[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One dense decode step of every slot: the model module's
        ``decode_step`` over the window rung and its identity table, each
        dp row over its own slots and caches (its tp ranks'), the rows'
        logits and lengths joined in slot order. Returns (logits (B, V),
        cache_len + 1)."""
        if self._dp == 1:
            logits, _, new_len = self._model.decode_step(
                self._row_params[0], self.cfg, token, self._row_caches[0],
                cache_len, window=window, table=self._tables[window])
            return logits, new_len
        m = self.max_slots // self._dp
        outs = [self._model.decode_step(
                    params, self.cfg, token[d * m:(d + 1) * m], caches,
                    cache_len[d * m:(d + 1) * m], window=window,
                    table=self._tables[window])
                for d, (params, caches) in enumerate(zip(self._row_params,
                                                         self._row_caches))]
        return torch.cat([out[0] for out in outs]), \
            torch.cat([out[2] for out in outs])

    def _table_view(self, window: Optional[int]) -> torch.Tensor:
        """The paged ticks' page table: whole with the ragged route, else
        its first ``_pick_page_width(window)`` columns (a view)."""
        pw = self._pick_page_width(window)
        return self.table if pw == self.pages_per_slot else self.table[:, :pw]

    def _tick_body(self, key: _Key, active: torch.Tensor) -> torch.Tensor:
        kind, n, sampled, window = key
        if kind == "spec":
            return self._spec_tick(n, sampled, window, active)
        return self._plain_tick(n, sampled, window, active,
                                biased=kind == "bias")

    def _record(self, eager, body):
        """Capture ``body()`` as a CUDA graph into the engine's one graph
        pool (:func:`capture.record`: ``eager()`` first, on the process's
        one side stream under ``set_sync_debug_mode("error")``, then the
        capture, in the process's capture turn with the cyclic collector
        off). Returns (graph, its static output, launches)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return capture.record(self.device, self._graph_pool, eager, body)

    def _capture(self, key: _Key) -> _Graph:
        """Capture the tick ``key`` as a CUDA graph (:meth:`_record`),
        its eager run with every slot inactive. That run's writes are
        harmless: the paged engine's go to the pool's scratch page; the
        dense engine's, and a spec tick's into the draft cache, land at
        each row's frozen positions, at or past its fill, which the row
        writes again before it reads them (JAX's argument for its
        inactive rows)."""
        t0 = time.monotonic()
        idle = torch.zeros_like(self.active)
        graph, out, launches = self._record(
            lambda: self._tick_body(key, idle),
            lambda: self._tick_body(key, self.active))
        entry = _Graph(graph, out, launches, time.monotonic() - t0)
        self._graphs[key] = entry
        self.capture_s += entry.seconds
        return entry

    def _capture_prefill(self, rung: _Prefill) -> None:
        """Capture the prefill rung as a CUDA graph (:meth:`_record`) over
        its static buffers, which hold padding rows only for it (no slot
        claimed, sentinel pages, nothing to publish): its eager run and
        the capture write nothing that any slot or cached page reads, and
        its first replay sees the group's own upload."""
        t0 = time.monotonic()
        nb, bucket, p_rung, biased, db = rung.key
        ints, _ = _pack(self._group_arrays(nb, bucket, p_rung, db))
        self._upload_prefill(rung, ints, self._group_floats(nb, biased))
        graph, first, launches = self._record(
            lambda: self._prefill_body(rung),
            lambda: self._prefill_body(rung))
        rung.graph, rung.first, rung.launches = graph, first, launches
        rung.seconds = time.monotonic() - t0

    # -- the disaggregated handoff's device side (the device thread) ----------
    def _export_rung(self, bucket: int) -> _Prefill:
        """The export rung of ``bucket`` (made at its first use): JAX's
        ``_prefill_fn(1, bucket)`` at the rows a local admission of one
        prompt of the bucket takes (:meth:`_prefill_count`), so an
        exported prompt's bits are those of a local prefill. Its buffers
        hold tokens (nb, bucket), lengths, top_ks, seeds (nb,) and the
        floats temps, top_ps (nb,); row 0 is the prompt, every other row
        padding."""
        rung = self._exports.get(bucket)
        if rung is None:
            nb = self._prefill_count(1, bucket)
            ints, layout = _pack(self._export_arrays(nb, bucket))
            specs = [((ints.size,), torch.int32), ((2 * nb,), torch.float32)]
            buffers = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for shape, dtype in specs]
            rung = _Prefill((nb, bucket, 0, False, 0), layout, *buffers)
            self._exports[bucket] = rung
        return rung

    def _export_arrays(self, nb: int, bucket: int,
                       prompt: Optional[List[int]] = None,
                       sampling: Optional["Sampling"] = None
                       ) -> Dict[str, np.ndarray]:
        """An export rung's int arrays: ``prompt`` in row 0 (with its
        sampling's top_k and seed), padding rows elsewhere (length 1)."""
        arrays = {"tokens": np.zeros((nb, bucket), np.int64),
                  "lengths": np.ones((nb,), np.int64),
                  "top_ks": np.zeros((nb,), np.int64),
                  "seeds": np.zeros((nb,), np.int64)}
        if prompt is not None:
            arrays["tokens"][0, :len(prompt)] = prompt
            arrays["lengths"][0] = len(prompt)
            arrays["top_ks"][0] = sampling.top_k
            arrays["seeds"][0] = sampling.seed & 0xFFFFFFFF
        return arrays

    def _export_body(self, rung: _Prefill) -> List[torch.Tensor]:
        """An export rung's device work: the prompt forward and first-token
        draw of a local prefill (:meth:`_prefill_forward`), no insert and
        no state written. Returns the first tokens (nb,), the advanced
        keys (nb, 2) and row 0 of each small-cache leaf (L, bucket, ...),
        contiguous, in the wire's leaf order."""
        _, small, first, keys, _, _ = self._prefill_forward(rung)
        small = _heads_cat(small)
        names = kv_wire.leaf_names(kv_wire.codec_for_cfg(self.cfg))
        return [first, keys] + [small[name][:, 0].contiguous()
                                for name in names]

    def _capture_export(self, rung: _Prefill) -> None:
        """Capture an export rung as a CUDA graph (:meth:`_record`) over
        padding rows; its static outputs are the graph's outputs."""
        t0 = time.monotonic()
        nb, bucket = rung.key[:2]
        ints, _ = _pack(self._export_arrays(nb, bucket))
        self._upload_prefill(rung, ints, self._group_floats(nb, False))
        graph, outs, launches = self._record(
            lambda: self._export_body(rung), lambda: self._export_body(rung))
        rung.graph, rung.first, rung.launches = graph, outs, launches
        rung.seconds = time.monotonic() - t0

    def _export_run(self, bucket: int, ints: np.ndarray,
                    floats: np.ndarray):
        """One export on the device thread, behind every step queued
        before: upload the rung's buffers, replay its graph (captured
        first if the bucket's rung was not warmed) or, on the CPU, run
        its body, and queue the copies of its outputs to pinned slabs
        (a bf16 leaf as its 16-bit words). Returns the function that
        waits for the copies and returns them as numpy arrays."""
        rung = self._export_rung(bucket)
        cuda = self.device.type == "cuda"
        if cuda and rung.graph is None:
            self._capture_export(rung)
            self.export_lazy_captures += 1
        self._upload_prefill(rung, ints, floats)
        if cuda:
            rung.graph.replay()
            launch_counts.add(rung.launches)
            rung.replays += 1
            outs = rung.first
        else:
            outs = self._export_body(rung)
        waits = [self._staging.fetch(_words(out)) for out in outs]
        return lambda: [wait() for wait in waits]

    def _warm_export(self, bucket: int) -> None:
        """Capture the export rung of ``bucket`` (on the card; nothing on
        the CPU) and run it once over padding rows, its staging slabs
        made, so an export after warmup captures nothing and its graph's
        first launch is not a request's."""
        if self.device.type != "cuda":
            return
        rung = self._export_rung(bucket)
        if rung.graph is None:
            self._capture_export(rung)
        nb = rung.key[0]
        ints, _ = _pack(self._export_arrays(nb, bucket))
        self._upload_prefill(rung, ints, self._group_floats(nb, False))
        for buf in (rung.ints, rung.floats):
            self._staging.reserve(buf)
        for out in rung.first:
            self._staging.reserve(_words(out), upload=False)
        rung.graph.replay()
        launch_counts.add(rung.launches)

    def _adopt_job(self, slot_idx: int, ids: List[int], payload,
                   sampling: "Sampling", epoch: Optional[int]) -> None:
        """Land a migrated payload on the device thread, behind every step
        queued before (JAX's ``_adopt_fn`` scatter): the page ids, the
        slot's rows (cache_len, last token, sampling parameters, key) and
        every leaf go up as one metered ``path="kv"`` transfer through a
        pinned slab, each leaf is copied into the pool at the slot's pages
        (``index_copy_`` along the page axis), and the rows into the
        slot's state. Eager, and queued only: nothing here waits for the
        card. A co-resident's
        reset of the shared pool since the claim (``epoch`` stale) fails
        the adoption: its pages are gone."""
        if self._stale(epoch):
            raise RuntimeError(
                "shared kv page pool was reset by a co-resident engine")
        names = kv_wire.leaf_names(payload.codec)
        key = payload.sample_key
        rows = np.asarray([payload.tokens, payload.first_token,
                           sampling.top_k, key[0] & 0xFFFFFFFF,
                           key[1] & 0xFFFFFFFF], np.int64)
        floats = np.asarray([max(sampling.temperature, 0.0),
                             sampling.top_p], np.float32)
        parts = [np.asarray(ids, np.int64), rows, floats] + [
            payload.leaves[name] for name in names]
        buf, offsets = self._staging.upload_parts(parts, path="kv")
        idx, rows, floats = (
            buf[off:off + part.nbytes].view(dtype) for off, part, dtype in
            zip(offsets, parts, (torch.int64, torch.int64, torch.float32)))
        for name, part, off in zip(names, parts[3:], offsets[3:]):
            src = buf[off:off + part.nbytes].view(
                _torch_dtype(part, payload)).view(part.shape)
            if self._plan is None:
                leaf = self._pool.leaves[name]
                leaf.index_copy_(1, idx, src.to(leaf.dtype))
                continue
            # over a mesh each tp rank takes its kv heads
            at = 0
            for leaves in self._pool.ranks():
                leaf = leaves[name]
                h = leaf.shape[3]
                leaf.index_copy_(1, idx, src[:, :, :, at:at + h].to(
                    leaf.dtype))
                at += h
        # the slot's rows, copied on the device from the upload (a
        # host scalar written into a device tensor would sync)
        one = slice(slot_idx, slot_idx + 1)
        for state, value in ((self.cache_len[one], rows[0:1]),
                             (self.last_token[one], rows[1:2]),
                             (self.top_ks[one], rows[2:3]),
                             (self.sample_keys[slot_idx], rows[3:5]),
                             (self.temps[one], floats[0:1]),
                             (self.top_ps[one], floats[1:2])):
            state.copy_(value)

    def _snapshot_job(self, slot_idx: int, ids: List[int],
                      names: Tuple[str, ...]):
        """Read a quiesced slot on the device thread, behind every step
        queued before: its pages of each leaf (gathered along the page
        axis) and its last token, key, temperature, top_k and top_p rows,
        each copied to a pinned slab. Returns the function that waits for
        the copies and returns them as numpy arrays."""
        buf, _ = self._staging.upload_parts([np.asarray(ids, np.int64)],
                                            path="kv")
        idx = buf.view(torch.int64)
        if self._plan is None:
            outs = [self._pool.leaves[name].index_select(1, idx)
                    for name in names]
        else:
            # over a mesh the tp ranks' kv heads, joined
            outs = [torch.cat([leaves[name].index_select(1, idx)
                               for leaves in self._pool.ranks()], dim=3)
                    for name in names]
        outs += [state[slot_idx:slot_idx + 1] for state in (
            self.last_token, self.sample_keys, self.temps, self.top_ks,
            self.top_ps)]
        waits = [self._staging.fetch(_words(out)) for out in outs]
        return lambda: [wait() for wait in waits]

    def _run_tick(self, key: _Key,
                  mask: Optional[np.ndarray], table: Optional[np.ndarray],
                  bias: Optional[np.ndarray] = None,
                  epoch: Optional[int] = None):
        """Upload what moved (and a "bias" tick's grammar bias), run the
        tick (a graph replay on the card, captured first if this rung was
        not warmed; eager on the CPU) and queue its tokens' copy. The
        uploads are queued on the stream ahead of the replay and behind
        every earlier tick, so a tick in flight never sees a later tick's
        bias. The mask goes alone (``path="mask"``, a bool array no
        coalescing takes); a paged table and a bias that both moved go
        as one transfer with ``coalesce_uploads``. A paged tick
        dispatched before a co-resident's reset of the shared pool
        (``epoch`` stale) runs with every slot inactive over sentinel
        pages: it writes nothing but the scratch page. Returns the
        fetch."""
        if self._stale(epoch):
            mask = np.zeros((self.max_slots,), bool)
            table = np.full(self._table.shape, self._pool.sentinel,
                            np.int32)
        if mask is not None:
            self._staging.upload(self.active, mask, path="mask")
        group = []
        if table is not None:
            group.append((self.table, table))
        if bias is not None:
            group.append((self.bias, bias))
        self._coalescer.upload(
            self._tick_arena if len(group) == 2 else None, group)
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
        """Run every tick of ``keys`` once with every slot inactive, as
        JAX's warmup runs each tick it compiles (:meth:`_warm_tick`), the
        device mask first made all inactive (the engine is not serving)."""
        if self.device.type == "cuda":
            self._staging.upload(self.active,
                                 np.zeros((self.max_slots,), bool),
                                 path="mask")
        for key in keys:
            self._warm_tick(key)

    def _warm_tick(self, key: _Key, live: bool = False) -> bool:
        """Run tick ``key`` once with every slot inactive: on the card its
        graph is captured first (if it was not) and the run is a replay
        over an inactive mask (its writes are those of the capture's eager
        run), so the graph's first launch, which uploads it to the card,
        is not a request's; on the CPU the body runs. ``live``: the engine
        is serving, so the device mask is saved, cleared and restored
        around the replay, in stream order between the ticks before and
        after. Returns whether it captured (on the CPU: True, it ran)."""
        if self.device.type != "cuda":
            self._tick_body(key, torch.zeros_like(self.active))
            return True
        entry = self._graphs.get(key)
        captured = entry is None
        if captured:
            entry = self._capture(key)
        saved = self.active.clone() if live else None
        if live:
            self.active.zero_()
        entry.graph.replay()
        launch_counts.add(entry.launches)
        if live:
            self.active.copy_(saved)
        return captured

    def _warm_prefills(self, keys: List[_PrefillKey]) -> None:
        """Run every prefill rung of ``keys`` once over padding rows
        (:meth:`_warm_prefill`), as JAX's warmup runs each prefill it
        compiles."""
        for key in keys:
            self._warm_prefill(key)

    def _warm_prefill(self, key: _PrefillKey) -> bool:
        """Run prefill rung ``key`` once over padding rows (no slot or
        cached page is written): on the card its graph is captured first
        (if it was not), its staging slabs made, and the run is a replay,
        so the graph's first launch (which uploads it to the card) is not
        a request's; on the CPU the body runs. The rung's buffers hold
        what the run uploads until a group of the rung uploads its own,
        in stream order. Returns whether it captured (on the CPU: True,
        it ran)."""
        cuda = self.device.type == "cuda"
        nb, bucket, p_rung, biased, db = key
        ints, layout = _pack(self._group_arrays(nb, bucket, p_rung, db))
        floats = self._group_floats(nb, biased)
        rung = self._prefill_rung(key, layout, floats.size)
        captured = cuda and rung.graph is None
        if captured:
            self._capture_prefill(rung)
        self._upload_prefill(rung, ints, floats)
        if not cuda:
            self._prefill_body(rung)
            return True
        for buf in ((rung.arena,) if rung.arena is not None
                    else (rung.ints, rung.floats)):
            self._staging.reserve(buf)
        self._staging.reserve(rung.first, upload=False)
        rung.graph.replay()
        launch_counts.add(rung.launches)
        return captured

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

    async def warmup(self, prompt_counts: Tuple[int, ...] = (1,),
                     ks: Optional[Tuple[int, ...]] = None,
                     sampling: bool = False,
                     windows: Union[Tuple[Optional[int], ...], str,
                                    None] = None) -> None:
        """Capture the tick and prefill executables and run each once, so
        the serving path never captures nor first-launches one (the JAX
        engine's ``warmup``, its signature): every rung of the k ladder
        (``ks`` restricts it) and, with a draft, of the γ ladder at each
        window rung of ``windows``, with every slot inactive; then the
        full prefill of every bucket at each count of ``prompt_counts``
        (its rows the count's rung of the admission ladder, raised on the
        card to ``CUDA_MIN_PREFILL_ROWS``), over padding rows, with a
        draft its draft prefill inside the same graph. Suffix, biased and
        draft-bucket prefill rungs are captured at first use, as JAX
        compiles them lazily, and count as serving compiles. With 1 among
        ``prompt_counts`` each bucket's export rung (:meth:`prefill_export`)
        is captured and run once too, as JAX's exports run its warm
        count-1 prefill.
        ``sampling`` keeps JAX's meaning (warm the sampled variants too);
        the port captures each tick rung greedy and sampled either way.
        ``windows``: None, the rungs reachable at startup
        (:meth:`_startup_window_rungs`); ``"all"``, the whole ladder; a
        tuple, exactly those rungs, ``max_len`` standing for the top rung
        (as ``stats()["window_ladder"]`` spells it). The paged engine's
        ticks all take window None, except under ``ragged_attn="off"``,
        where a rung is a gather width. An unwarmed rung is captured when a
        tick or a prefill first needs it (``lazy_captures``). On the CPU
        each tick and each prefill runs once instead. Must run before
        ``start()``: it runs device work outside the engine loop."""
        if self._task is not None:
            raise RuntimeError(
                "warmup() must be called before start(): it runs device "
                "work outside the engine loop")
        counts = [int(n) for n in prompt_counts]
        if not counts or any(n < 1 or n > self.max_slots for n in counts):
            raise ValueError(
                f"warmup prompt_counts={tuple(prompt_counts)}: each count "
                f"must be 1..max_slots ({self.max_slots})")
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
        if self._ragged:
            window_rungs = [None]
        keys = [("plain", k, s, w) for w in window_rungs for k in rungs
                for s in (False, True)]
        keys += [("spec", g, s, w) for w in window_rungs
                 for g in self._g_ladder for s in (False, True)]
        pkeys = list(dict.fromkeys(
            (self._prefill_count(n, bucket), bucket, 0, False, 0)
            for bucket in self.prompt_buckets for n in counts))
        # JAX's exports run its count-1 prefill executables: with count 1
        # warmed, so is each bucket's export rung
        ebuckets = list(self.prompt_buckets) if 1 in counts else []
        if self.logger is not None:
            self.logger.info("engine warmup: %d tick executables %s, %d "
                             "prefill executables %s", len(keys), keys,
                             len(pkeys), pkeys)
        self._warming += 1
        try:
            for key in keys:
                self._note_capture(key)
            for key in pkeys:
                self._note_prefill(key)
            for bucket in ebuckets:
                self._note_export(self._prefill_count(1, bucket), bucket)
        finally:
            self._warming -= 1
        # the warm replays run over an inactive mask: the first tick
        # uploads its own
        self._sent_mask = None
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._device_exec, self._warm, keys)
        await loop.run_in_executor(self._device_exec, self._warm_prefills,
                                   pkeys)
        for bucket in ebuckets:
            await loop.run_in_executor(self._device_exec, self._warm_export,
                                       bucket)

    @property
    def _device_exec(self) -> ThreadPoolExecutor:
        """The one thread all device work is queued from, in order. The
        engines sharing a pool share its one thread, so their work on its
        pages is queued in the order it was submitted; an engine of its
        own makes its thread at first use, and :meth:`stop` ends it. A
        thread's exit hands its cuBLAS handle back to the pool, and the
        next thread takes it up with the workspaces cuBLAS keeps for it,
        so engines built and stopped again and again (a shadow clone a
        scoring pass) leave no workspace behind."""
        if self._shared_pool:
            return self._pool.executor
        if self._own_exec is None:
            self._own_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gofr-torch-device")
        return self._own_exec

    async def start(self) -> None:
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            # bound to the loop that serves: an engine stopped under one
            # event loop may be started again under another
            self._wake = asyncio.Event()
            self._task = self._loop.create_task(self._run())

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
        own = self._own_exec
        if own is not None:
            # forgotten only once it has ended: device work submitted
            # while it shuts down is refused (RuntimeError), never run on
            # a second thread beside the jobs still queued on this one
            await asyncio.get_running_loop().run_in_executor(
                None, own.shutdown)
            if self._own_exec is own:
                self._own_exec = None

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
        self.shapes.record("prompt", len(prompt), bucket)
        return prompt, bucket

    def _new_flight(self, prompt: List[int], budget: int) -> _Flight:
        """Open the request's observability context at submit (JAX
        ``_new_flight``): a ``queue.wait`` span under the caller's current
        span (the port's contextvar) and a flight-recorder record tagged
        with the request span's ids."""
        parent = current_span() if self.tracer is not None else None
        qspan = (self.tracer.start_span("queue.wait", parent=parent)
                 if self.tracer is not None else None)
        link_span = parent if parent is not None else qspan
        record = RequestRecord(
            model=self.model_name, prompt_len=len(prompt), budget=budget,
            trace_id=link_span.trace_id if link_span is not None else None,
            span_id=link_span.span_id if link_span is not None else None)
        self.recorder.start(record)
        return _Flight(link_span, qspan, record)

    def _close_flight(self, flight: _Flight, status: str,
                      span_status: str) -> None:
        """End a request that never reached a slot: its ``queue.wait``
        span with ``span_status`` and its record with ``status``."""
        if flight.qspan is not None:
            flight.qspan.set_status(span_status)
            flight.qspan.finish()
        self.recorder.finish(flight.record, status)

    def set_brownout(self, level: int) -> None:
        """Apply a brownout level (JAX's ``set_brownout``, clamped to
        0..3): 0 healthy, 1 refuse batch-class submissions, 2 also cap
        speculative γ at rung 1, 3 also dispatch no spec tick."""
        level = max(0, min(int(level), 3))
        if level == self._brownout:
            return
        previous, self._brownout = self._brownout, level
        if self.logger is not None:
            log = self.logger.warning if level > previous \
                else self.logger.info
            log("engine: brownout level %d -> %d", previous, level)

    def _brownout_gate(self, cls: str, flight: _Flight) -> None:
        """Refuse a class the current brownout level sheds, before it is
        queued: a 503 the client can retry on another replica beats
        queue time on one that would shed the request anyway. Counted
        as the overflow's sheds are (record ``expired``, SLO outcome
        ``expired``, ``app_tpu_sched_shed_total``)."""
        if not self._brownout or cls not in brownout_shed_classes(
                self._brownout):
            return
        self._close_flight(flight, "expired", "ERROR")
        self._count_shed(cls)
        raise BrownoutShed(
            f"brownout level {self._brownout}: shedding {cls!r} admissions")

    def _count_shed(self, cls: str) -> None:
        self._shed_by_class[cls] = self._shed_by_class.get(cls, 0) + 1
        if self.slo is not None:
            self.slo.record_outcome("expired", cls=cls,
                                    model=self.model_name)
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_sched_shed_total", model=self.model_name, cls=cls)

    def _compile_grammar(self, response_format, eos_id):
        """Resolve a request's ``response_format`` through the engine's
        grammar cache; a malformed one raises
        :class:`~gofr_tpu_torch.tpu.constrain.GrammarError` (a
        ``ValueError``) before anything is queued."""
        if response_format is None:
            return None
        grammar = self.grammar_cache.get(response_format, eos_id)
        self._constrained_requests += 1
        return grammar

    def _submit(self, prompt_ids, max_new_tokens, eos_id, sampling,
                queue, response_format=None) -> asyncio.Future:
        """Validate, compile the grammar, class the request by the
        submitting context's deadline, record its admission with the
        workload recorder, pass the brownout gate and queue it under its
        class. Raises (nothing queued) on any refusal."""
        prompt, bucket = self._validate(prompt_ids, max_new_tokens)
        grammar = self._compile_grammar(response_format, eos_id)
        flight = self._new_flight(prompt, max_new_tokens)
        deadline = current_deadline()
        cls = deadline_class(deadline)
        if self.workload is not None:
            self.workload.admit(flight.record, cls, deadline)
        self._brownout_gate(cls, flight)
        future = asyncio.get_running_loop().create_future()
        self._pending.put_nowait(
            _Request(prompt, bucket, max_new_tokens, eos_id,
                     sampling or Sampling(), future, queue, cls, grammar,
                     deadline, flight), cls)
        self._set_queue_gauges()
        self._wake.set()
        return future

    async def generate(self, prompt_ids, max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling: Optional[Sampling] = None,
                       response_format: Optional[dict] = None) -> List[int]:
        """Generate up to ``max_new_tokens`` ids (stops early on
        ``eos_id``). Concurrent callers share decode steps.
        ``response_format`` (``{"type": "regex" | "json_schema", ...}``)
        constrains decoding to a grammar: per-step token masks bias the
        logits, and generation finishes as soon as the match is
        complete."""
        return await self._submit(prompt_ids, max_new_tokens, eos_id,
                                  sampling, None, response_format)

    async def generate_stream(self, prompt_ids, max_new_tokens: int,
                              eos_id: Optional[int] = None,
                              sampling: Optional[Sampling] = None,
                              response_format: Optional[dict] = None
                              ) -> TokenStream:
        """A :class:`TokenStream` yielding ids as they are produced.
        Validation, grammar compilation and the brownout gate happen
        here, so a bad or refused request raises before any token is
        streamed."""
        queue: asyncio.Queue = asyncio.Queue()
        future = self._submit(prompt_ids, max_new_tokens, eos_id, sampling,
                              queue, response_format)
        return TokenStream(self, queue, future)

    # -- disaggregated serving: prefill export / KV adoption -------------------
    def _adopt_ledger_get(self, dedupe: str) -> Optional[TokenStream]:
        """Idempotent-adopt lookup (JAX's): a replayed transfer id inside
        the TTL returns the stream the first adoption produced instead of
        claiming a second slot and page set for the same KV."""
        now = time.monotonic()
        if len(self._adopt_ledger) > _ADOPT_LEDGER_CAP:
            self._adopt_ledger = {
                key: entry for key, entry in self._adopt_ledger.items()
                if now - entry[0] < _ADOPT_LEDGER_TTL_S}
        hit = self._adopt_ledger.get(dedupe)
        if hit is None or now - hit[0] >= _ADOPT_LEDGER_TTL_S:
            return None
        self._adopt_dedup_hits += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_adopt_dedup_total", model=self.model_name)
        if self.logger is not None:
            self.logger.warn(
                "engine %s: replayed adoption %s served from the dedupe "
                "ledger", self.model_name, dedupe)
        return hit[1]

    async def prefill_export(self, prompt_ids,
                             sampling: Optional[Sampling] = None,
                             traceparent: Optional[str] = None):
        """Prefill-replica half of the disaggregated handoff (JAX's): run
        the prompt forward once and export its KV as a page-aligned
        :class:`~gofr_tpu_torch.tpu.kv_wire.KVPayload` instead of
        inserting it into a local slot. The payload carries the first
        sampled token and the advanced PRNG key, so the adopting decode
        replica continues token-identically without recomputing a prompt
        position. No slot is claimed and the engine loop need not run.

        The forward is the bucket's export rung (:meth:`_export_rung`: a
        local prefill's rows, no insert), one CUDA graph a bucket
        captured by ``warmup()``, queued on the device thread behind the
        steps before it; its outputs come back through pinned slabs, and
        the page-shaped leaves are built off the loop as JAX builds them
        (rows past the prompt's last page zero, scale planes one). Works
        for dense and paged engines alike (it reads the small cache,
        never a pool)."""
        sampling = sampling or Sampling()
        prompt, bucket = self._validate(prompt_ids, 1)
        page = self.kv_page
        n_pages = -(-len(prompt) // page)
        cfg = self.cfg
        # a router-supplied traceparent joins this export to the disagg
        # request's trace, so both halves' records share one trace_id
        remote = extract_traceparent(traceparent) if traceparent else None
        span = None
        if self.tracer is not None:
            parent = current_span()
            span = self.tracer.start_span("prefill.export", parent=parent,
                                          remote_parent=remote)
        trace_id = span.trace_id if span is not None else None
        if trace_id is None and remote is not None:
            trace_id = remote.get("trace_id")
        record = RequestRecord(
            model=self.model_name, prompt_len=len(prompt), budget=1,
            trace_id=trace_id,
            span_id=span.span_id if span is not None else None)
        self.recorder.start(record)
        record.admitted()
        nb = self._prefill_count(1, bucket)
        ints, _ = _pack(self._export_arrays(nb, bucket, prompt, sampling))
        floats = self._group_floats(nb, False)
        floats[0] = max(sampling.temperature, 0.0)
        floats[nb] = sampling.top_p
        codec = kv_wire.codec_for_cfg(cfg)
        names = kv_wire.leaf_names(codec)
        span_tokens = n_pages * page
        self._note_export(nb, bucket)

        def host_leaves(wait):
            # JAX's page-shaped leaves, built in a worker thread
            outs = wait()
            host = {}
            for name, leaf in zip(names, outs[2:]):
                shape = (leaf.shape[0], span_tokens) + leaf.shape[2:]
                out = np.zeros(shape, _wire_words(leaf.dtype))
                if name in ("ks", "vs"):
                    out[:] = 1.0   # pool scale planes initialize to ones
                copy = min(span_tokens, leaf.shape[1])
                out[:, :copy] = leaf[:, :copy].view(out.dtype)
                host[name] = out.reshape(
                    (out.shape[0], n_pages, page) + out.shape[2:])
            key_row = outs[1][0]
            return (int(outs[0][0]), host,
                    (int(key_row[0]) & 0xFFFFFFFF,
                     int(key_row[1]) & 0xFFFFFFFF))

        loop = asyncio.get_running_loop()
        wait = await loop.run_in_executor(self._device_exec,
                                          self._export_run, bucket, ints,
                                          floats)
        first, host, key = await loop.run_in_executor(None, host_leaves,
                                                      wait)
        self.prefill_dispatches += 1
        self.prefill_bucket_tokens += nb * bucket
        self.prefill_real_tokens += len(prompt)
        self._kv_exports += 1
        record.first_token()
        record.tokens = 1
        self.recorder.finish(record, "exported")
        if span is not None:
            span.set_attribute("prompt_len", len(prompt))
            span.set_attribute("bucket", bucket)
            span.set_attribute("pages", n_pages)
            span.finish()
        return kv_wire.KVPayload(
            codec=codec, dtype=self._wire_dtype(codec), page=page,
            tokens=len(prompt), n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            n_pages=n_pages, first_token=first, sample_key=key,
            model=self.model_name, leaves=host)

    def _wire_dtype(self, codec: int) -> str:
        """The header dtype of this engine's KV leaves: ``int8`` under the
        int8 codec, else the cache dtype's numpy name (``bfloat16`` for
        bf16, as ``ml_dtypes`` names it in the JAX package)."""
        if codec == kv_wire.CODEC_INT8:
            return "int8"
        dtype = self.cfg.dtype
        return kv_wire.BF16 if dtype == torch.bfloat16 \
            else str(dtype).replace("torch.", "")

    async def adopt_kv(self, payload, max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling: Optional[Sampling] = None,
                       submitted_at: Optional[float] = None,
                       traceparent: Optional[str] = None,
                       transfer_s: float = 0.0,
                       transfer_bytes: int = 0,
                       resume: bool = False,
                       dedupe: Optional[str] = None) -> TokenStream:
        """Decode-replica half of the handoff (JAX's, its checks, their
        order and messages): admit an exported
        :class:`~gofr_tpu_torch.tpu.kv_wire.KVPayload` straight into the
        page pool as page-table entries and start decoding from its
        first token, with no prefill (``prefill_bucket_tokens`` does not
        move). The pages are allocated at refcount 1 as a local
        admission's and released through the normal slot teardown.

        The slot is claimed on the loop with ``active`` False; the
        payload lands in one job on the device thread
        (:meth:`_adopt_job`), queued behind the ticks in flight, which
        leave the inactive slot's rows alone; then the slot joins the next
        tick, whose dispatch uploads the moved table and mask.
        ``traceparent`` stitches the remote prefill trace across the hop;
        ``transfer_s`` / ``transfer_bytes`` put the wire cost on the
        flight record and the ``app_tpu_kv_transfer_*`` series. Raises
        :class:`~gofr_tpu_torch.tpu.kv_wire.KVWireError` on a geometry or
        codec mismatch and ``RuntimeError`` when no slot or pages are
        free. ``dedupe`` makes the adoption idempotent: a replayed id
        gets the first adoption's stream back."""
        if dedupe is not None:
            prior = self._adopt_ledger_get(dedupe)
            if prior is not None:
                return prior
        if not self.paged:
            raise ValueError("adopt_kv needs paged_kv=True (migrated KV "
                             "is admitted as page-table entries)")
        sampling = sampling or Sampling()
        cfg = self.cfg
        if payload.page != self.kv_page:
            raise kv_wire.KVWireError(
                f"payload page size {payload.page} != engine kv_page "
                f"{self.kv_page}")
        if (payload.n_layers, payload.n_kv_heads, payload.head_dim) != \
                (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim):
            raise kv_wire.KVWireError(
                f"payload geometry (L={payload.n_layers}, "
                f"Hkv={payload.n_kv_heads}, Dh={payload.head_dim}) does "
                f"not match this model")
        if payload.codec != kv_wire.codec_for_cfg(cfg):
            raise kv_wire.KVWireError(
                f"payload codec {payload.codec} does not match the pool "
                "storage format (no transcoding on adopt)")
        # a session snapshot's first_token was already delivered by the
        # exporting replica: only adopt_session may admit one
        if bool(payload.flags & kv_wire.FLAG_SESSION) != resume:
            raise kv_wire.KVWireError(
                "session-flagged payloads must be adopted via "
                "adopt_session (and prefill payloads via adopt_kv)")
        if max_new_tokens < 1:
            raise ValueError("adopt_kv needs max_new_tokens >= 1")
        if payload.tokens + max_new_tokens > self.max_len:
            raise ValueError("migrated prompt + max_new_tokens exceeds "
                             "cache length")
        need = payload.n_pages
        if need + self._kv_reserve > self._pool.num_pages:
            raise RuntimeError(
                f"migrated prompt needs {need} KV pages but the pool "
                f"holds {self._pool.num_pages} (reserve "
                f"{self._kv_reserve}); it can never be adopted")
        if not self._free:
            raise RuntimeError("no free slot to adopt migrated KV into")
        if self._pool_stale():
            raise RuntimeError(
                "shared kv page pool was reset by a co-resident engine")
        while (self._pool.free_pages - need < self._kv_reserve
                and self._prefix is not None and self._prefix.evict_one()):
            pass
        if self._pool.free_pages - need < self._kv_reserve:
            raise RuntimeError(
                f"kv page pool short for adoption: {need} pages wanted, "
                f"{self._pool.free_pages} free (reserve "
                f"{self._kv_reserve})")
        ids = self._pool.alloc(
            need, reclaim=(self._prefix.evict_one
                           if self._prefix is not None else None),
            epoch=self._pool_epoch)
        if ids is None:
            raise RuntimeError(
                f"kv page pool exhausted at adoption: {need} pages "
                f"wanted, {self._pool.free_pages} free")

        # the adopt span joins the remote prefill trace when the
        # transport forwarded a traceparent
        span = None
        remote = extract_traceparent(traceparent) if traceparent else None
        if self.tracer is not None:
            span = self.tracer.start_span(
                "kv_adopt", remote_parent=remote,
                parent=None if remote else current_span())
            span.set_attribute("tokens", payload.tokens)
            span.set_attribute("pages", need)
            if transfer_bytes:
                span.set_attribute("transfer_bytes", transfer_bytes)
        trace_id = span.trace_id if span is not None else None
        if trace_id is None and remote is not None:
            trace_id = remote.get("trace_id")
        record = RequestRecord(
            model=self.model_name, prompt_len=payload.tokens,
            budget=max_new_tokens, trace_id=trace_id,
            span_id=span.span_id if span is not None else None)
        self.recorder.start(record)
        record.admitted()
        record.pages_held = need
        record.kv_transfer_s = float(transfer_s)
        record.kv_transfer_bytes = int(transfer_bytes)
        if self.metrics is not None and transfer_bytes:
            self.metrics.delta_updown_counter(
                "app_tpu_kv_transfer_bytes_total", float(transfer_bytes),
                model=self.model_name)

        # claim the slot with no await before the table write; active
        # stays False until the job has landed the pages
        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        future = loop.create_future()
        slot_idx = self._free.pop()
        slot = self._slots[slot_idx]
        slot.future = future
        slot.submitted_at = (submitted_at if submitted_at is not None
                             else time.monotonic())
        slot.deadline = current_deadline()
        slot.remaining = max_new_tokens
        slot.eos_id = eos_id
        slot.tokens = []
        slot.active = False
        slot.migrating = False
        slot.gen += 1
        gen = slot.gen
        # a prefill handoff ships one already-sampled token to publish;
        # a resumed session's last token was delivered by the exporter
        slot.inflight = 0 if resume else 1
        slot.queue = queue
        slot.temperature = sampling.temperature
        slot.cls = CLASS_MIGRATED
        slot.grammar = None        # migrated sessions decode unconstrained
        slot.spec_proposed = 0
        slot.spec_accepted = 0
        slot.fill = payload.tokens
        slot.nodes = []
        slot.pages = list(ids)
        slot.record = record
        slot.req_span = span
        slot.phase_span = None     # decode span opens at the first push
        self._table[slot_idx, :need] = ids
        self._table_version += 1
        try:
            await loop.run_in_executor(
                self._device_exec, self._adopt_job, slot_idx, list(ids),
                payload, sampling, self._pool_epoch)
        except BaseException:
            slot.gen += 1
            slot.queue = None
            slot.future = None
            self._finish_slot(slot_idx, slot, "error")
            if span is not None:
                span.set_status("ERROR")
                span.finish()
            raise
        self._pool.note_writes(need)
        slot.active = True
        self._kv_adoptions += 1
        if resume:
            self._session_adoptions += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_kv_adoptions_total", model=self.model_name)
        self._wake.set()
        if not resume:
            # publish the shipped first token through the normal path, as
            # if a local prefill's fetch had just landed
            self._push_tokens(slot_idx, gen, [payload.first_token])
        if span is not None:
            span.finish()
        stream = TokenStream(self, queue, future)
        if dedupe is not None:
            self._adopt_ledger[dedupe] = (time.monotonic(), stream)
        return stream

    async def adopt_session(self, payload, remaining: int,
                            eos_id: Optional[int] = None,
                            sampling: Optional[Sampling] = None,
                            submitted_at: Optional[float] = None,
                            traceparent: Optional[str] = None,
                            transfer_s: float = 0.0,
                            transfer_bytes: int = 0,
                            dedupe: Optional[str] = None) -> TokenStream:
        """Resume a live decode session a peer's :meth:`export_session`
        shipped (JAX's): the pages carry the session's committed KV,
        ``first_token`` is the last token the exporter committed and
        ``sample_key`` its advanced key, so decode continues
        token-identically with no prefill. The stream yields only the
        tokens generated after the hop."""
        return await self.adopt_kv(
            payload, remaining, eos_id=eos_id, sampling=sampling,
            submitted_at=submitted_at, traceparent=traceparent,
            transfer_s=transfer_s, transfer_bytes=transfer_bytes,
            resume=True, dedupe=dedupe)

    async def export_session(self, stream, timeout_s: float = 5.0):
        """Snapshot a live decode session for migration (JAX's): the slot
        joins no further tick (``migrating``), its in-flight tokens drain
        through the normal publish, then one job on the device thread
        reads its committed pages and its device rows (last token, key,
        sampling parameters), and the slot retires: pages freed, stream
        ended, flight record ``migrated``.

        Returns ``(payload, state)``: a session-flagged
        :class:`~gofr_tpu_torch.tpu.kv_wire.KVPayload` and the host state
        (``remaining``, ``eos_id``, sampling parameters, ``emitted``,
        ``cls``) for the adopting replica's :meth:`adopt_session`.
        Raises ``KeyError`` when the stream is bound to no slot,
        ``ValueError`` for a constrained session (its grammar walker is
        host state that does not ship) or a dense engine, and
        ``TimeoutError`` when its in-flight ticks do not drain in
        ``timeout_s``."""
        if not self.paged:
            raise ValueError("export_session needs paged_kv=True (the "
                             "session ships as page-pool rows)")
        queue = getattr(stream, "_queue", stream)
        slot_idx = next((i for i, s in enumerate(self._slots)
                         if s.queue is queue), None)
        if slot_idx is None:
            raise KeyError("stream is not bound to a live slot")
        slot = self._slots[slot_idx]
        if slot.grammar is not None:
            raise ValueError("constrained sessions hold host-side "
                             "grammar state and cannot migrate")
        gen0 = slot.gen
        slot.migrating = True

        def live() -> bool:
            return (slot.gen == gen0 and slot.queue is queue
                    and slot.active)

        try:
            deadline = time.monotonic() + timeout_s
            while slot.inflight > 0:
                if not live():
                    raise RuntimeError(
                        "session finished before it could be exported")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "in-flight decode ticks did not drain in "
                        f"{timeout_s}s")
                await asyncio.sleep(0.001)
            if not live():
                raise RuntimeError(
                    "session finished before it could be exported")

            fill = slot.fill
            page = self.kv_page
            n_pages = -(-fill // page)
            ids = [int(self._table[slot_idx, j]) for j in range(n_pages)]
            if any(pid == self._pool.sentinel for pid in ids):
                raise RuntimeError(
                    f"slot {slot_idx} table row holds a sentinel inside "
                    f"its {n_pages}-page fill span")
            codec = kv_wire.codec_for_cfg(self.cfg)
            names = kv_wire.leaf_names(codec)

            def snapshot(wait):
                outs = wait()
                host = {name: leaf.view(_wire_words(leaf.dtype))
                        for name, leaf in zip(names, outs)}
                last, key_row, temp, top_k, top_p = outs[len(names):]
                return (host, int(last[0]),
                        (int(key_row[0, 0]) & 0xFFFFFFFF,
                         int(key_row[0, 1]) & 0xFFFFFFFF),
                        float(temp[0]), int(top_k[0]), float(top_p[0]))

            loop = asyncio.get_running_loop()
            wait = await loop.run_in_executor(
                self._device_exec, self._snapshot_job, slot_idx, ids, names)
            host, last, key, temp, top_k, top_p = \
                await loop.run_in_executor(None, snapshot, wait)
            if not live():
                raise RuntimeError("session was cancelled during export")
        except BaseException:
            slot.migrating = False   # re-joins ticks if still live
            raise

        payload = kv_wire.KVPayload(
            codec=codec, dtype=self._wire_dtype(codec), page=page,
            tokens=fill, n_layers=self.cfg.n_layers,
            n_kv_heads=self.cfg.n_kv_heads, head_dim=self.cfg.head_dim,
            n_pages=n_pages, first_token=last, sample_key=key,
            model=self.model_name, leaves=host,
            flags=kv_wire.FLAG_SESSION)
        state = {
            "remaining": slot.remaining,
            "eos_id": slot.eos_id,
            "temperature": temp,
            "top_k": top_k,
            "top_p": top_p,
            "emitted": len(slot.tokens),
            "cls": slot.cls,
        }
        # retire the source slot: in-flight drained above, so this is the
        # normal teardown minus the token publish; the rest of the
        # completion streams from the adopting replica
        slot.migrating = False
        q = slot.queue
        slot.queue = None
        self._session_exports += 1
        self._finish_slot(slot_idx, slot, "migrated")
        if slot.future is not None and not slot.future.done():
            # non-streaming waiters get the tokens this replica produced
            slot.future.set_result(list(slot.tokens))
        if q is not None:
            q.put_nowait(_DONE)
        return payload, state

    def _cancel_stream(self, queue: asyncio.Queue) -> None:
        """Abandon the request bound to ``queue``: free its slot (stale
        in-flight tokens are dropped by the generation counter) or, if it
        is not admitted yet, mark it so admission skips it."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.queue is queue:
                slot.queue = None
                if slot.future is not None and not slot.future.done():
                    slot.future.cancel()
                self._finish_slot(slot_idx, slot, "cancelled")
                return
        self._cancelled_queues.add(queue)

    def _by_window(self, windows) -> Dict[int, int]:
        """How many of ``windows`` are each rung, the top one as
        ``max_len``."""
        counts: Dict[int, int] = {}
        for w in windows:
            counts[w or self.max_len] = counts.get(w or self.max_len, 0) + 1
        return dict(sorted(counts.items()))

    def _capture_s_by_kind(self) -> Dict[str, float]:
        """Capture seconds summed by tick kind ("plain", "spec", "bias")."""
        out: Dict[str, float] = {}
        for key, entry in self._graphs.items():
            out[key[0]] = out.get(key[0], 0.0) + entry.seconds
        return out

    def _prefill_graph_stats(self) -> Dict[str, Any]:
        """The prefill rungs' graphs beside the ticks': captured, by JAX
        kind, their capture seconds (by kind), replays, and captures made
        while serving."""
        by_kind: Dict[str, int] = {}
        seconds: Dict[str, float] = {}
        captured = [r for r in list(self._prefills.values())
                    if r.graph is not None]
        for rung in captured:
            kind = _prefill_kind(rung.key)
            by_kind[kind] = by_kind.get(kind, 0) + 1
            seconds[kind] = seconds.get(kind, 0.0) + rung.seconds
        return {"captured": len(captured),
                "keys": [list(rung.key) for rung in captured],
                "by_kind": by_kind,
                "capture_s": sum(seconds.values()),
                "capture_s_by_kind": seconds,
                "replays": sum(rung.replays for rung in captured),
                "lazy_captures": self.prefill_lazy_captures}

    def _export_graph_stats(self) -> Dict[str, Any]:
        """The export rungs' graphs: captured, by bucket, their capture
        seconds, replays, and captures made while serving."""
        captured = [r for r in list(self._exports.values())
                    if r.graph is not None]
        return {"captured": len(captured),
                "keys": [list(rung.key[:2]) for rung in captured],
                "capture_s": sum(rung.seconds for rung in captured),
                "replays": sum(rung.replays for rung in captured),
                "lazy_captures": self.export_lazy_captures}

    def prefix_digest(self,
                      max_entries: int = 512) -> Optional[Dict[str, Any]]:
        """The resident prefix chains as hashes, for fleet routing; None
        without a prefix store."""
        if self._prefix is None:
            return None
        return self._prefix.digest(max_entries=max_entries)

    # -- compiles, telemetry and the views -------------------------------------
    @property
    def attn_path(self) -> str:
        """The decode-attention formulation ticks run (``app_tpu_attn_
        kernel_total{path}``): on the paged engine ``ragged`` (the ragged
        wrappers over the pool's page table) or, under
        ``ragged_attn="off"``, ``gather`` (each slot's pages gathered, then
        dense attention); ``dense`` (cache rows, read through identity
        tables) otherwise."""
        if not self.paged:
            return "dense"
        return "ragged" if self._ragged else "gather"

    def _pick_page_width(self, rung: Optional[int]) -> int:
        """Window rung → page-gather width, table columns (JAX
        ``_pick_page_width``): the whole table with the ragged route or
        for the top rung, else ``ceil(rung / kv_page)``."""
        if self._ragged or rung is None:
            return self.pages_per_slot
        return min(self.pages_per_slot, -(-rung // self.kv_page))

    def _note_capture(self, key: _Key) -> None:
        """Note tick ``key``'s graph capture as one compile, once, on the
        loop thread when it is queued (on the card; the CPU runs ticks
        eagerly and captures nothing, and only remembers the key)."""
        if key in self._compiled:
            return
        self._compiled.add(key)
        if self.device.type != "cuda":
            return
        kind = {"plain": "decode", "bias": "decode_bias",
                "spec": "spec"}[key[0]] + ("_paged" if self.paged else "")
        self._note_compile(kind, key[1:])

    def _note_prefill(self, key: _PrefillKey) -> None:
        """Note prefill rung ``key``'s graph capture as one compile, once,
        under JAX's kind name (one graph stands for JAX's prefill + insert
        pair, and a draft's too), on the loop thread when it is queued (on
        the card only, as :meth:`_note_capture`)."""
        tag = ("prefill",) + key
        if tag in self._compiled:
            return
        self._compiled.add(tag)
        if self.device.type == "cuda":
            self._note_compile(_prefill_kind(key), key)

    def _note_export(self, nb: int, bucket: int) -> None:
        """Note the export rung of ``bucket`` as one compile, once, under
        JAX's kind (its export runs ``_prefill_fn(1, bucket)``), on the
        card only, as :meth:`_note_prefill`."""
        tag = ("export", nb, bucket)
        if tag in self._compiled:
            return
        self._compiled.add(tag)
        if self.device.type == "cuda":
            self._note_compile("prefill", (nb, bucket))

    def _note_compile(self, kind: str, key) -> None:
        """Charge one compile (JAX ``_note_compile``): warmup class inside
        ``warmup()``, serving class otherwise — the recompile-storm
        signal the watchdog reads through :meth:`serving_compiles`."""
        cls = "warmup" if self._warming else "serving"
        self._compiles_by_class[cls] += 1
        self._compile_events.append((time.monotonic(), cls, f"{kind}{key}"))
        del self._compile_events[:-256]
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_engine_compiles_total", cls=cls,
                model=self.model_name)

    def serving_compiles(self, window_s: float = 60.0,
                         now: Optional[float] = None) -> int:
        """Serving-class compiles inside the trailing window (the
        ``CompileLedger`` seam the watchdog's ``ledger`` reads)."""
        now = time.monotonic() if now is None else now
        return sum(1 for at, cls, _ in self._compile_events
                   if cls == "serving" and now - at <= window_s)

    def _set_queue_gauges(self) -> None:
        """Per-class admission backlog gauge (class queues plus the
        page-deferred overflow). A zero row stays published."""
        if self.metrics is None:
            return
        depths = self._pending.depths()
        for req in self._overflow:
            depths[req.cls] = depths.get(req.cls, 0) + 1
        for cls, depth in depths.items():
            self.metrics.set_gauge(
                "app_tpu_admission_queue_depth", float(depth),
                model=self.model_name, cls=cls)

    def attach_telemetry(self, store, every: int = 64) -> None:
        """Give ``store`` (anything with ``note_tick``) the phase split of
        every ``every``-th dispatched tick: ``admission_s``,
        ``host_dispatch_s``, ``device_wait_s`` (dispatch to publish),
        ``kind``, ``batch``, ``step``, ``at``. Never called, the loop
        pays one attribute test a pass."""
        self.telemetry = store
        self._tick_every = max(1, int(every))

    def attach_workload(self, recorder) -> None:
        """Wire the workload recorder (JAX ``attach_workload``): each
        submission calls ``recorder.admit`` and every terminal status
        reaches ``recorder.finish`` through the flight recorder's one
        finish funnel. Never called, ``workload`` stays None."""
        self.workload = recorder
        self.recorder.workload = recorder

    # -- the operating point (JAX's) --------------------------------------------
    def operating_point(self) -> Dict[str, Any]:
        """The live operating point with its provenance (JAX
        ``operating_point``): every knob :meth:`apply_operating_point`
        moves, ``staging_depth`` being the depth of the engine's staging
        rings, and where the values came from (``source`` is ``seed``
        until the first apply)."""
        return {
            "prompt_buckets": list(self.prompt_buckets),
            "steps_per_tick": self.steps_per_tick,
            "gamma_cap": self._gamma_cap,
            "kv_reserve": self._kv_reserve if self.paged else None,
            "class_weights": self._pending.weights(),
            "slots_cap": self.slots_cap,
            "staging_depth": self._staging.depth,
            "max_slots": self.max_slots,
            "source": self._op_source,
            "generation": self._op_generation,
            "applied_at": self._op_applied_at,
        }

    def _op_shape_sig(self, point) -> Tuple[Tuple[int, ...], int]:
        """The (prompt_buckets, steps_per_tick) signature of a candidate
        point, the knobs that map to graphs; an absent knob keeps the
        engine's value."""
        buckets = getattr(point, "prompt_buckets", None)
        buckets = (self.prompt_buckets if buckets is None
                   else tuple(sorted({int(b) for b in buckets})))
        k = getattr(point, "steps_per_tick", None)
        k = self.steps_per_tick if k is None else max(1, int(k))
        return buckets, k

    def _op_keys(self, buckets: Tuple[int, ...], k: int
                 ) -> Tuple[List[_PrefillKey], List[_Key]]:
        """The graphs a point of ``buckets`` and ``k`` serves through that
        were not captured (on the CPU: not run) or queued: the full
        prefill of every bucket at every count of the admission ladder
        (its rows raised on the card as :meth:`_prefill_count` raises
        them), and every rung of ``k``'s ladder, greedy and sampled, at
        every window rung (dense), gather-width rung (paged under
        ``ragged_attn="off"``) or window None (ragged)."""
        rungs = _k_rungs(k)
        windows = [None] if self._ragged else list(self._window_ladder)
        pkeys = [key for key in dict.fromkeys(
            (self._prefill_count(n, b), b, 0, False, 0)
            for b in buckets for n in self._n_ladder)
            if ("prefill",) + key not in self._compiled]
        keys = [key for key in (("plain", r, s, w) for w in windows
                                for r in rungs for s in (False, True))
                if key not in self._compiled]
        return pkeys, keys

    async def prewarm_operating_point(self, point) -> Dict[str, Any]:
        """Capture every graph an operating-point move needs (JAX
        ``prewarm_operating_point``, its refusals and its answer), charged
        as warmup-class compiles, while the engine serves: the rungs of
        :meth:`_op_keys`, each captured and then run once (over padding
        rows, or over an inactive mask put in place of the live one and
        restored after), so no graph's first launch is a request's. Each
        rung is one job on the device thread, so the serving ticks queued
        meanwhile run between them: after each job, the prewarm waits
        for the loop to queue a tick (:meth:`_tick_since`) if it has one
        coming. A capture's eager run writes what an
        inactive tick writes (each row's frozen positions, at or past its
        fill, which the row writes again before it reads them), in stream
        order with the ticks in flight. ``compiled`` counts the graphs
        captured; on the CPU, where nothing is captured, the rungs run."""
        buckets, k = self._op_shape_sig(point)
        bad = [b for b in buckets if b > self.max_len]
        if bad or not buckets:
            raise ValueError(
                f"prewarm: prompt buckets {bad or buckets} out of range "
                f"(max_len={self.max_len})")
        if self.paged:
            bad = [b for b in buckets if b % self.kv_page]
            if bad:
                raise ValueError(
                    f"prewarm: prompt buckets {bad} are not multiples of "
                    f"kv_page {self.kv_page}")
        pkeys, keys = self._op_keys(buckets, k)
        self._warming += 1
        try:
            for key in pkeys:
                self._note_prefill(key)
            for key in keys:
                self._note_capture(key)
        finally:
            self._warming -= 1
        loop = asyncio.get_running_loop()
        compiled = 0
        jobs = [(self._warm_prefill, key) for key in pkeys] \
            + [(self._warm_tick, key, True) for key in keys]
        for job in jobs:
            compiled += await loop.run_in_executor(self._device_exec, *job)
            await self._tick_since(self._steps)
        self._op_prewarmed.add((buckets, k))
        if self.logger is not None and compiled:
            self.logger.info(
                "engine prewarm: compiled %d executables for operating "
                "point (buckets=%s k=%d)", compiled, list(buckets), k)
        return {"compiled": compiled, "prompt_buckets": list(buckets),
                "steps_per_tick": k}

    async def _tick_since(self, steps: int) -> None:
        """While the engine's loop has work that leads to a tick (a step in
        flight, or a request it can admit now), wait until it has
        dispatched a tick since the count ``steps``: that tick is then
        queued on the device thread ahead of the next prewarm job, so
        serving waits behind one capture at a time."""
        while self._task is not None and self._steps == steps and (
                self._publishq
                or (self._admit_room(0) and not self._pending.empty())):
            await asyncio.sleep(0.0005)

    def apply_operating_point(self, point,
                              source: str = "autotune") -> Dict[str, Any]:
        """Swap the engine's operating point (JAX
        ``apply_operating_point``, its refusals, order and messages).
        ``point`` duck-types the knobs (an absent or None one keeps the
        engine's value): ``prompt_buckets``, ``steps_per_tick``,
        ``gamma_cap``, ``kv_reserve``, ``class_weights``, ``slots_cap``,
        ``staging_depth``. Refused, with nothing applied: under a
        brownout, a shape-changing move (buckets or steps_per_tick) not
        prewarmed, a value out of range. Everything is validated first,
        then swapped with no await between, so the loop sees the old
        point or the new one. The outgoing shape stays prewarmed (its
        graphs stay), so moving back captures nothing; a changed
        ``steps_per_tick`` rebuilds the k ladder."""
        if self._brownout > 0:
            raise RuntimeError(
                f"apply_operating_point refused: brownout level "
                f"{self._brownout} active")
        buckets, k = self._op_shape_sig(point)
        current_sig = (self.prompt_buckets, self.steps_per_tick)
        if not buckets:
            raise ValueError("apply_operating_point: empty prompt buckets")
        bad = [b for b in buckets if b > self.max_len or b < 1]
        if bad:
            raise ValueError(
                f"apply_operating_point: buckets {bad} out of range "
                f"(max_len={self.max_len})")
        if self.paged:
            bad = [b for b in buckets if b % self.kv_page]
            if bad:
                raise ValueError(
                    f"apply_operating_point: buckets {bad} are not "
                    f"multiples of kv_page {self.kv_page}")
        if (buckets, k) != current_sig \
                and (buckets, k) not in self._op_prewarmed:
            raise RuntimeError(
                "apply_operating_point refused: shape-changing move "
                f"(buckets={list(buckets)} k={k}) was not prewarmed — "
                "call prewarm_operating_point first so compiles stay "
                "off the serving path")
        gamma = getattr(point, "gamma_cap", None)
        if gamma is not None and self.spec:
            gamma = max(1, min(int(gamma), self.spec_gamma))
        reserve = getattr(point, "kv_reserve", None)
        if reserve is not None and self.paged:
            reserve = int(reserve)
            if not 0 <= reserve < self._pool.num_pages:
                raise ValueError(
                    f"apply_operating_point: kv_reserve {reserve} out of "
                    f"range [0, {self._pool.num_pages})")
        weights = getattr(point, "class_weights", None)
        if weights:
            weights = {str(name): float(w) for name, w in weights.items()}
            bad_w = [name for name, w in weights.items() if w <= 0]
            if bad_w:
                raise ValueError(
                    f"apply_operating_point: non-positive class weights "
                    f"{bad_w}")
        cap = getattr(point, "slots_cap", None)
        if cap is not None:
            cap = int(cap)
            if not 1 <= cap <= self.max_slots:
                raise ValueError(
                    f"apply_operating_point: slots_cap {cap} out of "
                    f"range [1, {self.max_slots}]")
        depth = getattr(point, "staging_depth", None)
        if depth is not None:
            depth = max(1, int(depth))
        # validated: swap with no await between
        self._op_prewarmed.add(current_sig)
        self.prompt_buckets = buckets
        self.steps_per_tick = k
        self._k_ladder = _k_rungs(k)
        if gamma is not None and self.spec:
            self._gamma_cap = gamma
        if reserve is not None and self.paged:
            self._kv_reserve = reserve
        if weights:
            self.class_weights = dict(weights)
            self._pending.set_weights(weights)
        self.slots_cap = cap if cap is not None else self.slots_cap
        if depth is not None:
            self._staging.depth = depth
        self._op_source = str(source)
        self._op_generation += 1
        self._op_applied_at = time.monotonic()
        if self.logger is not None:
            self.logger.info(
                "engine operating point applied (gen %d, source=%s): "
                "buckets=%s k=%d", self._op_generation, self._op_source,
                list(buckets), k)
        return self.operating_point()

    def shadow_clone(self, point=None) -> "GenerationEngine":
        """A fresh engine over the same config and the same parameter
        tensors (shared storage, never copied) at a candidate point (JAX
        ``shadow_clone``, its keywords, then ``device``): its own cache or
        page pool and its own graphs, and no metrics, tracer, recorder
        hooks or telemetry, so scoring traffic touches nothing live.
        Speculative decode and the prefix store are not cloned."""
        buckets, k = self._op_shape_sig(point) if point is not None \
            else (self.prompt_buckets, self.steps_per_tick)
        weights = getattr(point, "class_weights", None) \
            if point is not None else None
        kwargs: Dict[str, Any] = dict(
            max_slots=self.max_slots, max_len=self.max_len,
            prompt_buckets=buckets, steps_per_tick=k,
            mesh=self.mesh,
            window_ladder=len(self._window_ladder) > 1,
            model_module=None if self._model is llama else self._model,
            model_name=f"{self.model_name}@shadow",
            class_weights=dict(weights or self.class_weights),
            coalesce_uploads=self.coalesce_uploads,
            coalesce_stream=self.coalesce_stream)
        if self.paged:
            kwargs.update(paged_kv=True, kv_page=self.kv_page,
                          kv_pages=self._pool.num_pages,
                          ragged_attn=self.ragged_attn)
        return GenerationEngine(self.cfg, self.params, device=self.device,
                                **kwargs)

    def _admit_room(self, taken: int) -> bool:
        """True while admission may claim another slot this pass (JAX
        ``_admit_room``): free slots remain beyond the ``taken`` already
        claimed, and ``slots_cap`` (when set) is not reached."""
        if len(self._free) - taken <= 0:
            return False
        cap = self.slots_cap
        if cap is not None and \
                (self.max_slots - len(self._free)) + taken >= cap:
            return False
        return True

    def admission_depth(self) -> int:
        """Requests queued for admission (class queues plus overflow)."""
        return self._pending.qsize() + len(self._overflow)

    def kv_free_headroom(self) -> Optional[int]:
        """Free pool pages above the reserve (paged; None dense)."""
        if not self.paged:
            return None
        return self._pool.free_pages - self._kv_reserve

    def data_plane(self) -> Dict[str, Any]:
        """Host-to-device upload totals of the engine's staging slabs and
        the coalescer's (JAX ``data_plane``). The rate is bytes over the
        host seconds of the upload calls, which queue their copies
        without waiting for them."""
        staging = self._staging.stats()
        return {
            "coalesce_uploads": self.coalesce_uploads,
            "coalesce_stream": self.coalesce_stream,
            "h2d_uploads": staging["uploads"],
            "h2d_bytes": staging["upload_bytes"],
            "h2d_mb_per_s": staging["upload_mb_per_s"],
            "coalescer": self._coalescer.stats(),
        }

    def hbm_attribution(self) -> Dict[str, Any]:
        """Device memory this engine placed (JAX ``hbm_attribution``, for
        ``/debug/hbmz``) against the allocator's figure: parameters (and
        a draft's), the paged pool by ownership class, or the dense
        cache; the draft's cache. The staging slabs are pinned host
        memory (``staging_bytes``, not attributed). The residual is
        what nobody claims (graph pools, activations, cuBLAS
        workspaces, fragmentation). Host bookkeeping only."""
        params = _tree_bytes(self.params) + _tree_bytes(self.draft_params)
        out: Dict[str, Any] = {"model": self.model_name,
                               "params_bytes": params}
        attributed = params
        if self.paged:
            pool = self._pool
            page_bytes = pool.page_bytes
            decode_pages = migrated_pages = 0
            for slot in self._slots:
                if not slot.active:
                    continue
                if slot.cls == CLASS_MIGRATED:
                    migrated_pages += len(slot.pages)
                else:
                    decode_pages += len(slot.pages)
            # pages in use that no slot holds are the prefix trie's
            prefix_pages = max(0, pool.used_pages - decode_pages
                               - migrated_pages)
            out["page_pool"] = {
                "pool_bytes": pool.pool_bytes,
                "page_bytes": page_bytes,
                "pages": {"total": pool.num_pages, "free": pool.free_pages,
                          "decode": decode_pages, "migrated": migrated_pages,
                          "prefix_pinned": prefix_pages},
                "bytes": {"free": pool.free_pages * page_bytes,
                          "decode": decode_pages * page_bytes,
                          "migrated": migrated_pages * page_bytes,
                          "prefix_pinned": prefix_pages * page_bytes},
            }
            attributed += pool.pool_bytes
        else:
            out["page_pool"] = None
            attributed += _tree_bytes(self.cache)
        attributed += _tree_bytes(self._draft_cache)
        out["staging_bytes"] = self._staging.stats()["slab_bytes"]
        out["attributed_bytes"] = attributed
        out["device_bytes_in_use"] = self.device_bytes_in_use()
        out["unattributed_bytes"] = (
            None if out["device_bytes_in_use"] is None
            else out["device_bytes_in_use"] - attributed)
        out["device_seconds"] = self._device_seconds_view()
        if self._plan is not None:
            # over a mesh: what each device holds (params and KV shards)
            out["by_device"] = self._mesh_view()["bytes_by_device"]
        return out

    def device_bytes_in_use(self) -> Optional[int]:
        """Bytes the caching allocator has handed out on the engine's card
        (``torch.cuda.memory_stats``' ``allocated_bytes.all.current``:
        tensors, captured graphs' private pools included; not the
        allocator's reserve, the CUDA context or kernel images); None on
        the CPU."""
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.memory_stats(self.device)[
            "allocated_bytes.all.current"])

    def _device_seconds_view(self) -> Dict[str, float]:
        return {f"{model}/{cls}": round(seconds, 6)
                for (model, cls), seconds
                in sorted(self._device_seconds.items())}

    def statusz(self, recent: int = 32) -> Dict[str, Any]:
        """Live JSON snapshot for ``/debug/statusz`` (JAX ``statusz``):
        queue depth, per-slot state, KV occupancy, the data plane, the
        stats, the flight recorder's ring and the executable families'
        device seconds. Host bookkeeping only."""
        slots = []
        for slot_idx, slot in enumerate(self._slots):
            slots.append({
                "slot": slot_idx,
                "state": "active" if slot.active else "free",
                "cls": slot.cls if slot.active else None,
                "fill": slot.fill if slot.active else 0,
                "remaining": slot.remaining if slot.active else 0,
                "inflight_tokens": slot.inflight,
                "spec_accepted": slot.spec_accepted if slot.active else 0,
                "spec_proposed": slot.spec_proposed if slot.active else 0,
                "streaming": slot.queue is not None,
                "pages_held": (len(slot.pages) + len(slot.nodes)
                               if slot.active else 0),
                "trace_id": (slot.record.trace_id
                             if slot.record is not None else None),
            })
        tokens_in_cache = sum(s.fill for s in self._slots if s.active)
        if self.paged:
            capacity = self._pool.num_pages * self.kv_page
            pages_held = sum(len(s.pages) + len(s.nodes)
                             for s in self._slots if s.active)
            kv_cache = {
                "paged": True,
                "attn_path": self.attn_path,
                "max_slots": self.max_slots,
                "max_len": self.max_len,
                "page_tokens": self.kv_page,
                "pool_pages": self._pool.num_pages,
                "pages_in_use": self._pool.used_pages,
                "slot_pages_held": pages_held,
                "tokens_in_cache": tokens_in_cache,
                "occupancy": round(tokens_in_cache / capacity, 6)
                if capacity else 0.0,
                "ragged_fill_ratio": round(
                    tokens_in_cache / (pages_held * self.kv_page), 6)
                if pages_held else 0.0,
            }
        else:
            capacity = self.max_slots * self.max_len
            kv_cache = {
                "max_slots": self.max_slots,
                "max_len": self.max_len,
                "tokens_in_cache": tokens_in_cache,
                "occupancy": round(tokens_in_cache / capacity, 6)
                if capacity else 0.0,
            }
        return {
            "queue_depth": self._pending.qsize(),
            "ticks_inflight": self._ticks_inflight,
            "slots": slots,
            "kv_cache": kv_cache,
            "data_plane": self.data_plane(),
            "stats": self.stats(),
            "requests": self.recorder.snapshot(limit=recent),
            "executables": self.exec_ledger.snapshot(limit=8),
        }

    def xlaz(self, recent: int = 64, max_rungs: int = 4) -> Dict[str, Any]:
        """Compile-plane view for ``/debug/xlaz`` (JAX ``xlaz``): the
        observed prompt lengths against the buckets and the
        padding-optimal ladder they suggest, padding, the executable
        families' device seconds, compiles by class, and the tick
        graphs captured (``paged_kv.decode_executables``,
        ``speculative.compiled_spec_fns``; the prefill graphs, each with
        the draft's prefill inside, as
        ``speculative.compiled_draft_prefill_fns``; the paged engine's
        ``ragged_attn`` mode and gather widths), and the live operating
        point. With a workload recorder attached, the suggested ladder
        weighs the recorder's recent prompt lengths
        (``ladder_source="workload_trace"``) in place of the lifetime
        observed ones."""
        ladder_source = "observed_lengths"
        observed: Dict[int, int] = {}
        if self.workload is not None:
            observed = self.workload.prompt_length_distribution(
                self.model_name)
            if observed:
                ladder_source = "workload_trace"
        if not observed:
            observed = self.shapes.distribution("prompt")
        out: Dict[str, Any] = {
            "models": {
                "prompt": {
                    "ladder": list(self.prompt_buckets),
                    "observed_batch_sizes": {
                        str(k): v for k, v in sorted(observed.items())},
                    "bucket_hits": {
                        str(k): v for k, v in
                        sorted(self.shapes.bucket_hits("prompt").items())},
                    "suggested_ladder": suggest_ladder(
                        observed,
                        max_rungs=max(len(self.prompt_buckets), max_rungs)),
                    "ladder_source": ladder_source,
                },
            },
            "padding": self.shapes.snapshot(),
            "executables": self.exec_ledger.snapshot(limit=max_rungs * 3),
            "operating_point": self.operating_point(),
            "compiles": dict(self._compiles_by_class),
        }
        if self._prefix is not None:
            out["prefix_cache"] = {
                "page_ladder": list(self._p_ladder),
                "page_tokens": self._prefix.page,
                "store": self._prefix.stats(),
                "prefill_bucket_tokens": self.prefill_bucket_tokens,
                "prefill_real_tokens": self.prefill_real_tokens,
            }
        if self.paged:
            out["paged_kv"] = {
                "page_tokens": self.kv_page,
                "attn_path": self.attn_path,
                "ragged_attn": self.ragged_attn,
                "gather_widths": sorted({self._pick_page_width(w)
                                         for w in self._window_ladder}),
                "decode_executables": sorted(
                    str(key) for key in self._graphs if key[0] != "spec"),
                "pool": self._pool.stats(),
            }
        if self.spec:
            out["speculative"] = {
                "gamma_ladder": list(self._g_ladder),
                "gamma_cap": self._gamma_cap,
                "compiled_spec_fns": sum(1 for key in self._graphs
                                         if key[0] == "spec"),
                "compiled_draft_prefill_fns":
                    self._prefill_graph_stats()["captured"],
            }
        if self._plan is not None:
            out["mesh"] = self._mesh_view()
        return out

    def _mesh_view(self) -> Dict[str, Any]:
        """The mesh an engine serves over (``xlaz()["mesh"]``): its axes,
        its shards, the distinct devices they sit on (1 when every shard
        shares the card) and the KV and param bytes each device holds."""
        mesh = self._plan.mesh
        by_device: Dict[str, int] = {}
        kv = self._pool.leaves if self.paged else self.cache
        for tree in (self.params, kv):
            for leaf in _sharded_leaves(tree):
                for shard in leaf.distinct_shards():
                    key = str(shard.device)
                    by_device[key] = by_device.get(key, 0) \
                        + shard.numel() * shard.element_size()
        return {"shape": dict(mesh.shape), "shards": mesh.size,
                "devices": mesh.distinct_devices,
                "bytes_by_device": by_device}

    def health_check(self) -> Dict[str, Any]:
        """Container-health contract (JAX ``health_check``): the stats
        and, on the card, its allocated bytes."""
        details: Dict[str, Any] = dict(self.stats())
        try:
            in_use = self.device_bytes_in_use()
            index = self.device.index if self.device.index is not None \
                else 0
            details["devices"] = {str(index): {
                "hbm_bytes_in_use": in_use or 0}}
            status = "UP"
        except Exception as exc:  # noqa: BLE001 — reported as DOWN
            details["error"] = repr(exc)
            status = "DOWN"
        return {"status": status, "details": details}

    @property
    def spec_dispatches(self) -> int:
        """Spec ticks run (each verifies once through every target
        layer)."""
        return sum(self.spec_rungs.values())

    @property
    def active_slots(self) -> int:
        return sum(1 for slot in self._slots if slot.active)

    def stats(self) -> Dict[str, Any]:
        """The engine's counters: JAX's ``model``, ``active_slots``,
        ``free_slots`` and ``queue_depth`` (the class queues), which the
        telemetry store's default signals and the diagnosis window read,
        beside the port's own (``pending`` counts the page-deferred
        overflow too). Host bookkeeping only."""
        out = {
            "model": self.model_name,
            "device": str(self.device),
            "active_slots": self.active_slots,
            "free_slots": len(self._free),
            "queue_depth": self._pending.qsize(),
            "pending": self._pending.qsize() + len(self._overflow),
            "prefill_dispatches": self.prefill_dispatches,
            # JAX's names: prefill dispatches, and the bucket tokens
            # dispatched against the real (non-padding, non-reused)
            # prompt tokens inside them
            "prefill_batches": self.prefill_dispatches,
            "prefill_bucket_tokens": self.prefill_bucket_tokens,
            "prefill_real_tokens": self.prefill_real_tokens,
            # the disaggregated handoff (JAX's keys): prompt forwards
            # shipped out, migrated prompts admitted with no prefill, and
            # live sessions shipped out and resumed
            "kv_exports": self._kv_exports,
            "kv_adoptions": self._kv_adoptions,
            "session_exports": self._session_exports,
            "session_adoptions": self._session_adoptions,
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
                "capture_s_by_kind": self._capture_s_by_kind(),
                "replays": self.graph_replays,
                "lazy_captures": self.lazy_captures,
                "prefill": self._prefill_graph_stats(),
                "export": self._export_graph_stats(),
            },
            "max_len": self.max_len,
            "window_ladder": [w or self.max_len
                              for w in self._window_ladder],
            "mesh": dict(self.mesh.shape) if self.mesh is not None
            else None,
            "ticks_by_window": {
                w or self.max_len: n for w, n in sorted(
                    self.window_ticks.items(),
                    key=lambda item: item[0] or self.max_len)},
            "device_seconds": self._device_seconds_view(),
            "compiles": dict(self._compiles_by_class),
        }
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
            out["prefix_cache"]["page_ladder"] = list(self._p_ladder)
            out["prefix_cache"]["admissions_by_rung"] = dict(
                sorted(self.prefix_admissions.items()))
            out["prefix_cache"]["suffix_prefills"] = \
                self.suffix_prefill_dispatches
        if self.paged:
            out["kv_pool"] = dict(self._pool.stats(),
                                  reserve_pages=self._kv_reserve,
                                  pages_per_slot=self.pages_per_slot,
                                  page_stalls=self._page_stalls,
                                  deferred_requests=len(self._overflow),
                                  attn_path=self.attn_path,
                                  ragged_attn=self.ragged_attn)
        else:
            out["kv_cache"] = {
                "max_slots": self.max_slots,
                "max_len": self.max_len,
                "view_page": llama.dense_page(self.max_len),
                "cache_bytes": _tree_bytes(self.cache),
                "tokens_in_cache": sum(slot.fill for slot in self._slots
                                       if slot.active),
            }
        out["classes"] = {
            "weights": self._pending.weights(),
            "depths": self._pending.depths(),
            "served": self._pending.served(),
            "shed": dict(self._shed_by_class),
        }
        if self._constrained_requests or len(self.grammar_cache):
            out["constrained"] = {
                "requests": self._constrained_requests,
                "ticks": self._constrained_ticks,
                "grammar_cache": self.grammar_cache.stats(),
            }
        if (self._brownout or self._quarantined or self._adopt_dedup_hits
                or self._adopt_ledger):
            # sparse, so a healthy engine's stats are unchanged
            out["resilience"] = {
                "brownout_level": self._brownout,
                "quarantined": dict(self._quarantined),
                "adopt_dedup_hits": self._adopt_dedup_hits,
                "adopt_ledger_entries": len(self._adopt_ledger),
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
    async def _run(self) -> None:
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
                    if entry.span is not None:
                        entry.span.set_status("ERROR")
                        entry.span.finish()
                    try:
                        # shielded: a stop() here cancels the loop, not
                        # the fetch, which stop() then lands
                        await asyncio.shield(entry.task)
                    except asyncio.CancelledError:
                        raise        # engine.stop() must still win
                    except Exception:  # noqa: BLE001 — the callers were
                        pass           # already failed above
                self._publishq.clear()
                self._ticks_inflight = 0
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
        pages went back with their slots. The prefix store forgets every
        prefix: its pages may hold what the failed step half wrote. The
        device mask and table are cleared: the next tick uploads both."""
        self._sent_mask, self._sent_table = None, -1
        if self._prefix is not None:
            self._prefix.reset()
        if self.paged:
            # a shared pool's reset notifies its co-residents; the guard
            # keeps this engine's own observer out (it rebuilds here)
            self._in_pool_reset = True
            try:
                self._pool.reset()
            finally:
                self._in_pool_reset = False
            self._pool_epoch = self._pool.epoch
            self.table.fill_(self._pool.sentinel)
        else:
            for caches in self._row_caches:
                for cache in llama.rank_trees(caches):
                    for name, leaf in cache.items():
                        leaf.fill_(1 if name in ("ks", "vs") else 0)
        if self.spec:
            for name, leaf in self._draft_cache.items():
                leaf.fill_(1 if name in ("ks", "vs") else 0)
        for tensor in (self.cache_len, self.last_token, self.temps,
                       self.top_ks, self.sample_keys, self.active):
            tensor.zero_()
        self.top_ps.fill_(1.0)

    def _stale(self, epoch: Optional[int]) -> bool:
        """Whether device work stamped with pool ``epoch`` at dispatch
        was overtaken by a reset of the shared pool (device thread)."""
        return epoch is not None and epoch != self._pool.epoch

    def _on_pool_reset(self) -> None:
        """Shared-pool reset observer (JAX ``_on_pool_reset``): a
        co-resident engine reset the pool every page id of this engine
        points into. Called on the resetting engine's device thread; the
        host part (:meth:`_pool_reset_host`) runs on this engine's loop.
        Until then this engine's device work dispatched before it runs
        with no slot active over sentinel pages (``_stale``), and its
        loop allocates no page (``_pool_stale``)."""
        if self._in_pool_reset:
            return
        loop = self._loop
        if loop is not None and self._task is not None \
                and not loop.is_closed():
            loop.call_soon_threadsafe(self._pool_reset_host)
        else:
            self._pool_reset_host()

    def _pool_reset_host(self) -> None:
        """Fail outstanding work, re-sentinel the table (the next tick
        uploads it and the mask again), reset the prefix store and take
        the pool's new epoch."""
        self._fail_outstanding(RuntimeError(
            "shared kv page pool was reset by a co-resident engine"))
        self._table = np.full((self.max_slots, self.pages_per_slot),
                              self._pool.sentinel, np.int32)
        self._table_version += 1
        self._sent_mask, self._sent_table = None, -1
        for slot in self._slots:
            slot.pages, slot.nodes = [], []
        if self._prefix is not None:
            self._prefix.reset()
        self._pool_epoch = self._pool.epoch

    def _pool_stale(self) -> bool:
        """Paged: the shared pool was reset and this engine's loop has not
        taken the news yet (its page ids are the old epoch's)."""
        return self.paged and self._pool_epoch != self._pool.epoch

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Fail every caller bound to an active slot. Queued requests were
        never dispatched and are retried against the rebuilt state."""
        for slot_idx, slot in enumerate(self._slots):
            if slot.active:
                self._fail_slot(slot_idx, slot, exc)

    def _attribute_device_time(self, entry: _Fetch) -> None:
        """Charge the step's dispatch-to-publish seconds to its
        participants' (model, SLO class), split evenly, and to its
        executable family, through one helper so the two totals agree
        (JAX ``_attribute_device_time``). Pipelined steps overlap, so
        the shares can sum past wall time: attribution, not
        utilisation."""
        elapsed = time.monotonic() - entry.dispatched_at
        if elapsed <= 0:
            return
        if entry.kind == "spec":
            participants = [s for s, _ in entry.payload[0]]
        elif entry.kind == "prefill":
            participants = [s for s, _, _ in entry.payload]
        else:
            participants = [s for s, _ in entry.payload]
        if not participants:
            return
        charge_device_time(
            elapsed, self.model_name,
            classes=[self._slots[s].cls or "standard" for s in participants],
            family=entry.family or entry.kind,
            device_seconds=self._device_seconds, metrics=self.metrics,
            ledger=self.exec_ledger)

    async def _loop_body(self, loop) -> None:
        q = self._publishq
        # the sampled tick anatomy: whether the next dispatched tick is
        # the Nth is decided up front, and only then do the clocks run
        ts = self.telemetry
        sampled = (ts is not None
                   and (self._tick_seq + 1) % self._tick_every == 0)
        t_admit = time.monotonic() if sampled else 0.0
        # 1. batched admission; each prefill's first-token fetch is queued
        self._admit_pending(loop)
        # 2. dispatch the next tick up to the pipeline depth; its fetch
        #    follows it
        dispatched = False
        if self.active_slots > 0 \
                and self._ticks_inflight < self.max_inflight_ticks:
            t_dispatch = time.monotonic() if sampled else 0.0
            entry = self._dispatch_tick(loop)
            if entry is not None:
                self._ticks_inflight += 1
                self._ticks_inflight_peak = max(self._ticks_inflight_peak,
                                                self._ticks_inflight)
                if ts is not None:
                    self._tick_seq += 1
                    if sampled:
                        entry.anatomy = {
                            "admission_s": t_dispatch - t_admit,
                            "host_dispatch_s": time.monotonic() - t_dispatch,
                        }
                q.append(entry)
                dispatched = True
        if not q:
            if self.active_slots == 0 and self._pending.empty() \
                    and not self._overflow:
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

    def _on_device(self, loop, kind: str, payload, fn, *args,
                   span: Optional[Span] = None,
                   family: Optional[str] = None) -> _Fetch:
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
        return _Fetch(loop.create_task(land()), kind, payload, span=span,
                      family=family)

    @staticmethod
    def _annotated(name: str, step: int, fn, *args):
        """``fn(*args)`` on the device thread, inside a ``torch.profiler``
        step annotation (JAX ``_profile_step``) while a profiler is
        active; otherwise just the call."""
        if not torch.autograd._profiler_enabled():
            return fn(*args)
        with torch.profiler.record_function(name, f"step_num={step}"):
            return fn(*args)

    def _step_span(self, name: str, participants,
                   **attributes) -> Optional[Span]:
        """Open an engine-step span (JAX ``_step_span``): the root of its
        own trace, with a link to every participating request's span;
        ``participants`` are tuples whose first element is a slot index.
        Finished at publish, so it covers dispatch, the device and the
        fetch."""
        if self.tracer is None:
            return None
        span = Span(self.tracer, name)
        span.set_attribute("batch_size", len(participants))
        for key, value in attributes.items():
            span.set_attribute(key, value)
        for entry in participants:
            slot = self._slots[entry[0]]
            if slot.req_span is not None:
                span.add_link(slot.req_span)
        return span

    def _prefix_plan(self, prompt: List[int], bucket: int):
        """Plan prefix reuse for one request (JAX ``_prefix_plan``): the
        longest cached page chain, rounded down to a prefix-pages rung
        (the rest rides the suffix), and the suffix's bucket; a rung whose
        suffix bucket would overrun ``max_len`` drops to the one below.
        Returns (rung, bucket, pinned nodes); rung 0 is a full prefill.
        Pins the nodes it returns."""
        store = self._prefix
        chain = store.lookup(prompt)
        store.classify(len(chain), store.max_lookup_pages(len(prompt)))
        p = max((rung for rung in self._p_ladder if rung <= len(chain)),
                default=0)
        while p:
            plen = p * store.page
            fit = next((b for b in self.prompt_buckets
                        if b >= len(prompt) - plen
                        and plen + b <= self.max_len), None)
            if fit is not None:
                bucket = fit
                break
            p = max((rung for rung in self._p_ladder if rung < p),
                    default=0)
        if p == 0:
            return 0, bucket, []
        nodes = chain[:p]
        store.acquire(nodes)
        store.record_saved(p * store.page)
        return p, bucket, nodes

    def _admit_pending(self, loop) -> None:
        """Drain the overflow, then the class queues in weighted-fair
        order, into free slots; one batched prefill per (prefix rung,
        bucket, biased) group, each with its first-token fetch queued for
        publishing (JAX ``_admit_pending``)."""
        requests: List[_Request] = []
        # page-deferred requests re-enter first: they were admitted in
        # order before the pool ran short
        while self._overflow and self._admit_room(len(requests)):
            requests.append(self._overflow.popleft())
        while self._admit_room(len(requests)) and not self._pending.empty():
            requests.append(self._pending.get_nowait())
        if not requests:
            return
        groups: Dict[Tuple[int, int, bool],
                     List[Tuple[_Request, List]]] = {}
        leases: List[Any] = []     # dense: pins held through this pass
        committed = 0    # pages promised to requests admitted this pass
        for ri, req in enumerate(requests):
            if req.queue is not None and req.queue in self._cancelled_queues:
                self._cancelled_queues.discard(req.queue)
                if not req.future.done():
                    req.future.cancel()
                self._close_flight(req.flight, "cancelled", "CANCELLED")
                continue
            if req.deadline is not None and time.monotonic() > req.deadline:
                # the deadline ate the whole budget in the queue: shed
                # before prefill, a late answer is wasted device work
                self._reject(req, DeadlineExceeded())
                self._close_flight(req.flight, "expired", "EXPIRED")
                if self.slo is not None:
                    self.slo.record_outcome("expired", cls=req.cls,
                                            model=self.model_name)
                if self.logger is not None:
                    self.logger.warning(
                        "engine: shed expired request before prefill "
                        "(%.1fms past deadline)",
                        (time.monotonic() - req.deadline) * 1000.0)
                continue
            if self.paged:
                # page-gated before the prefix lookup, so a deferred
                # request counts no lookup twice; worst case, the whole
                # prompt needs fresh pages
                need = -(-len(req.prompt) // self.kv_page)
                if need + self._kv_reserve > self._pool.num_pages:
                    self._reject(req, RuntimeError(
                        f"prompt needs {need} KV pages but the pool holds "
                        f"{self._pool.num_pages} (reserve "
                        f"{self._kv_reserve}); it can never be admitted"))
                    self._close_flight(req.flight, "error", "ERROR")
                    continue
                while (not self._pool_stale()
                       and self._pool.free_pages - committed
                       < need + self._kv_reserve
                       and self._prefix is not None
                       and self._prefix.evict_one()):
                    pass
                if self._pool_stale() or self._pool.free_pages - committed \
                        < need + self._kv_reserve:
                    # head-of-line FIFO: this request and every later one
                    # of the pass wait in the overflow, ahead of newer
                    # arrivals; past its cap the deepest class sheds
                    self._overflow.extend(requests[ri:])
                    self._shed_overflow()
                    break
                committed += need
            # a constrained request always takes a full prefill: the
            # suffix route never meets a grammar
            p_rung, bucket, nodes = (
                self._prefix_plan(req.prompt, req.bucket)
                if self._prefix is not None and req.grammar is None
                else (0, req.bucket, []))
            self.prefix_admissions[p_rung] = \
                self.prefix_admissions.get(p_rung, 0) + 1
            if not self.paged:
                # the dense insert copies the pages: pinned until this
                # pass's dispatches are queued; paged slots keep theirs
                leases.extend(nodes)
            groups.setdefault((p_rung, bucket, req.grammar is not None),
                              []).append((req, nodes))
        if self._pending.empty() and not self._overflow:
            self._cancelled_queues.clear()
        # claim slots for every group before dispatching any, so a failed
        # dispatch reaches every admitted caller through its slot
        staged = [self._claim_group(p_rung, bucket, group, biased)
                  for (p_rung, bucket, biased), group
                  in sorted(groups.items())]
        for claimed, args, pages in staged:
            nb, bucket, p_rung = args[0], args[1], args[3]
            self._note_prefill(_prefill_key(nb, bucket, p_rung, args[7],
                                            args[5]))
            span = self._step_span("tpu.engine.prefill", claimed,
                                   bucket=bucket, padded_batch=nb,
                                   prefix_pages=p_rung)
            family = (f"suffix_prefill[nb={nb},p={p_rung},b={bucket}]"
                      if p_rung else f"prefill[nb={nb},b={bucket}]")
            self._publishq.append(self._on_device(
                loop, "prefill", claimed, self._annotated,
                "tpu.engine.prefill", self.prefill_dispatches,
                self._prefill_insert, *args, span=span, family=family))
            if self.paged:
                self._pool.note_writes(pages)
            self.prefill_dispatches += 1
            self.prefill_bucket_tokens += nb * bucket
            self.suffix_prefill_dispatches += bool(p_rung)
        if leases:
            # the queued gathers read the pages in dispatch order, ahead
            # of any later publish into an evicted one
            self._prefix.release(leases)
        self._set_queue_gauges()

    def _shed_overflow(self) -> None:
        """Bound the page-deferred deque (JAX ``_shed_overflow``): past
        the cap, the class with the deepest backlog sheds its own newest
        entry — strictly within class before any cross-class impact, and
        LIFO within the class (the newest arrival has the least sunk
        queue time)."""
        while len(self._overflow) > self._overflow_cap:
            depths: Dict[str, int] = {}
            for req in self._overflow:
                depths[req.cls] = depths.get(req.cls, 0) + 1
            victim = max(depths.items(), key=lambda item: item[1])[0]
            at = max(i for i, req in enumerate(self._overflow)
                     if req.cls == victim)
            req = self._overflow[at]
            del self._overflow[at]
            self._count_shed(req.cls)
            if self.logger is not None:
                self.logger.warning(
                    "engine: shed overflowed %s request (backlog %d > cap "
                    "%d)", req.cls, len(self._overflow) + 1,
                    self._overflow_cap)
            self._reject(req, RuntimeError(
                f"admission overflow: more than {self._overflow_cap} "
                f"page-deferred requests; shedding the newest {req.cls!r} "
                f"entry (deepest class)"))
            self._close_flight(req.flight, "expired", "ERROR")

    def _prefill_count(self, n: int, bucket: int) -> int:
        """Rows of a prefill of ``n`` prompts of ``bucket``: the count
        ladder's rung, raised on the card to ``CUDA_MIN_PREFILL_ROWS``
        rows (padding rows, which no slot takes) for llama, where the
        prefix store's bit identity needs them. Another model module (no
        prefix store) keeps JAX's rung: an MoE's capacity is taken over
        every row, so more rows would be another function."""
        need = n
        if self.device.type == "cuda" and self._model is llama:
            need = max(n, -(-CUDA_MIN_PREFILL_ROWS // bucket))
        return next((x for x in self._n_ladder if x >= need), need)

    def _n_publish(self, bucket: int, p_rung: int) -> int:
        """Pages a row of a prefill group publishes into the dense store:
        a full prefill's full pages, up to the store's prefix cap; 0 on
        the paged engine (its pages are adopted), without a store, or for
        a suffix group."""
        store = self._prefix
        if p_rung or store is None or self.paged:
            return 0
        return min(bucket // store.page, store.max_pages)

    def _group_arrays(self, nb: int, bucket: int, p_rung: int,
                      db: int = 0) -> Dict[str, np.ndarray]:
        """The int arrays of a prefill group of ``nb`` rows (draft bucket
        ``db``), every row padding (length 1, no slot claimed, sentinel
        pages, nothing published), keyed as :meth:`_prefill_body` reads
        them. The rung fixes every shape."""
        arrays = {"tokens": np.zeros((nb, bucket), np.int64),
                  "lengths": np.ones((nb,), np.int64),
                  "row_of_slot": np.full((self.max_slots,), -1, np.int64),
                  "top_ks": np.zeros((nb,), np.int64),
                  "seeds": np.zeros((nb,), np.int64)}
        if self.paged:
            arrays["page_ids"] = np.full((nb * (bucket // self.kv_page),),
                                         self._pool.sentinel, np.int64)
        if p_rung:
            arrays["prefix_ids"] = np.zeros((nb, p_rung), np.int64)
        if db:
            arrays["draft_tokens"] = np.zeros((nb, db), np.int64)
            arrays["draft_lengths"] = np.ones((nb,), np.int64)
        n_pub = self._n_publish(bucket, p_rung)
        if n_pub:
            arrays["publish_ids"] = np.full((nb * n_pub,),
                                            self._prefix.num_pages, np.int64)
        return arrays

    def _group_floats(self, nb: int, biased: bool) -> np.ndarray:
        """The floats of a prefill group of ``nb`` padding rows, flat:
        temps 0 (nb,), top_ps 1 (nb,) and, ``biased``, (nb, vocab) zero
        bias rows."""
        width = 2 + (self.cfg.vocab_size if biased else 0)
        floats = np.zeros((nb * width,), np.float32)
        floats[nb:2 * nb] = 1.0
        return floats

    def _claim_group(self, p_rung: int, bucket: int, group: List[Tuple],
                     biased: bool = False):
        """Bind each request of one (prefix rung, bucket, biased) group to
        a slot (paged: its table row: the cached pages, then fresh pages
        for the suffix), rows 0.. in order (padding rows follow); a dense
        full prefill inserts its full pages into the store for
        publishing, a paged one has them adopted. A constrained request's
        slot gets its grammar walker, and a biased group's row its
        start-state bias row (padding rows 0). Returns ([(slot, gen,
        row)], prefill args, pages written)."""
        nb = self._prefill_count(len(group), bucket)
        store = self._prefix
        plen = p_rung * store.page if p_rung else 0
        npg = bucket // self.kv_page if self.paged else 0
        db = 0
        if self.spec and p_rung:
            # the draft prefills the whole prompts: the bucket of the
            # longest, which its own bucket always covers
            db = next(b for b in self.prompt_buckets
                      if b >= max(len(req.prompt) for req, _ in group))
        arrays = self._group_arrays(nb, bucket, p_rung, db)
        floats = self._group_floats(nb, biased)
        sampling = floats[:2 * nb].reshape(2, nb)       # temps, top_ps
        bias = floats[2 * nb:].reshape(nb, -1) if biased else None
        # dense with the store on, a full prefill always passes its publish
        # ids (the store's sentinel where a page is cached already), so one
        # rung is one graph
        n_pub = self._n_publish(bucket, p_rung)
        publish = arrays.get("publish_ids")
        claimed = []
        pages = 0
        for row, (req, nodes) in enumerate(group):
            slot_idx = self._free.pop()
            slot = self._slots[slot_idx]
            slot.future = req.future
            slot.queue = req.queue
            slot.submitted_at = req.submitted_at
            slot.remaining = req.budget
            slot.eos_id = req.eos_id
            slot.tokens = []
            slot.migrating = False
            slot.active = True
            slot.gen += 1
            slot.inflight = 1          # the prefill's first token
            slot.temperature = req.sampling.temperature
            slot.fill = len(req.prompt)
            slot.cls = req.cls
            slot.deadline = req.deadline
            slot.spec_proposed = slot.spec_accepted = 0
            slot.grammar = None
            if req.grammar is not None:
                # a cursor over the shared compiled grammar; its
                # start-state row steers the prefill's token
                slot.grammar = GrammarWalker(req.grammar)
                bias[row] = slot.grammar.bias_row()
            # queue.wait ends here; the prefill phase span opens, both in
            # the request's trace
            flight = req.flight
            if flight.qspan is not None:
                flight.qspan.set_attribute("slot", slot_idx)
                flight.qspan.finish()
            flight.record.admitted()
            flight.record.cached_prefix_len = plen
            slot.record = flight.record
            slot.req_span = flight.link_span
            slot.phase_span = None
            if self.tracer is not None:
                slot.phase_span = self.tracer.start_span(
                    "prefill", parent=flight.link_span)
                slot.phase_span.set_attribute("slot", slot_idx)
                slot.phase_span.set_attribute("prompt_len", len(req.prompt))
                slot.phase_span.set_attribute("cached_prefix_len", plen)
            # only the suffix past the reused prefix is prefilled
            suffix = req.prompt[plen:]
            self.prefill_real_tokens += len(suffix)
            if self.paged:
                # a prefix hit is table entries: the pinned nodes' pages
                # in columns [0, p_rung), fresh pages for the suffix
                slot.nodes = list(nodes)
                for j, node in enumerate(nodes):
                    self._table[slot_idx, j] = node.page_id
                n_fresh = -(-len(suffix) // self.kv_page)
                ids = self._pool.alloc(
                    n_fresh,
                    reclaim=store.evict_one if store is not None else None)
                if ids is None:
                    raise RuntimeError(
                        f"kv page pool exhausted at admission: {n_fresh} "
                        f"pages wanted, {self._pool.free_pages} free")
                slot.pages = list(ids)
                self._table[slot_idx, p_rung:p_rung + n_fresh] = ids
                self._table_version += 1
                flight.record.pages_held = p_rung + n_fresh
                arrays["page_ids"][row * npg:row * npg + n_fresh] = ids
                pages += n_fresh
                if p_rung == 0 and store is not None:
                    # the full prompt pages are adopted with no copy; the
                    # page decode writes into stays the slot's
                    want = min(len(req.prompt) // self.kv_page,
                               store.max_pages)
                    if want > 0:
                        store.register(req.prompt, ids[:want])
            if p_rung:
                arrays["prefix_ids"][row] = [n.page_id for n in nodes]
                if db:
                    arrays["draft_tokens"][row, :len(req.prompt)] = req.prompt
                    arrays["draft_lengths"][row] = len(req.prompt)
            if publish is not None:
                want = min(len(req.prompt) // store.page, n_pub)
                for j, (pid, new) in enumerate(
                        store.insert(req.prompt, want) if want > 0 else []):
                    if new:
                        publish[row * n_pub + j] = pid
            arrays["tokens"][row, :len(suffix)] = suffix
            arrays["lengths"][row] = len(suffix)
            arrays["row_of_slot"][slot_idx] = row
            arrays["top_ks"][row] = req.sampling.top_k
            arrays["seeds"][row] = req.sampling.seed & 0xFFFFFFFF
            sampling[:, row] = (max(req.sampling.temperature, 0.0),
                                req.sampling.top_p)
            claimed.append((slot_idx, slot.gen, row))
        if publish is not None and (publish != store.num_pages).any():
            # a page the store evicted and handed out again within this
            # group is written by its last owner only
            seen = set()
            for at in range(publish.size - 1, -1, -1):
                if publish[at] in seen:
                    publish[at] = store.num_pages
                seen.add(int(publish[at]))
            store.publishes += 1
        ints, layout = _pack(arrays)
        args = (nb, bucket, len(group), p_rung, ints, layout, floats, biased,
                self._pool_epoch if self.paged else None)
        return claimed, args, pages

    def _dispatch_tick(self, loop) -> Optional[_Fetch]:
        """Choose K, charge the eligible slots and dispatch one decode
        tick; returns its fetch, or None when no slot could run. Slots
        whose budget is covered by in-flight tokens sit the tick out, and
        so does a constrained slot with a token in flight: its grammar
        row is valid for exactly the next position. A constrained
        participant pins the tick to k = 1 with no spec tick (the draft
        cannot propose through a grammar) and makes it a "bias" tick.
        Brownout level 2 caps γ at rung 1; level 3 dispatches no spec
        tick. The ``tick_exception`` fault site raises first, where the
        loop's catch-all takes it."""
        faults.active().raise_if("tick_exception")
        eligible = [(slot_idx, slot)
                    for slot_idx, slot in enumerate(self._slots)
                    if slot.active and slot.remaining > slot.inflight
                    and not slot.migrating
                    and (slot.grammar is None or slot.inflight == 0)]
        if not eligible:
            return None
        biased = any(slot.grammar is not None for _, slot in eligible)
        min_wanted = min(slot.remaining - slot.inflight
                         for _, slot in eligible)
        k = 1
        if not biased and (self._pending.empty() or not self._free):
            k = max(rung for rung in self._k_ladder if rung <= min_wanted)
            if self._brownout < 3:
                # rung g commits up to g + 1 tokens per slot, so it needs
                # g + 1 <= min_wanted: no budget is ever overshot
                cap = 1 if self._brownout >= 2 else self._gamma_cap
                g = max((rung for rung in self._g_ladder
                         if rung + 1 <= min_wanted and rung <= cap),
                        default=0)
                if g > 0:
                    return self._dispatch_spec(loop, eligible, g)
        covered = self._cover_pages(eligible, k)
        if not covered:
            self._shed_if_wedged(eligible)
            return None
        eligible = covered
        window = self._tick_window(eligible, k)
        mask, sampled, snapshot = self._charge(eligible, k)
        bias = None
        if biased:
            # each constrained participant's current row; 0 for the
            # others, which decode unbiased
            bias = np.zeros((self.max_slots, self.cfg.vocab_size),
                            np.float32)
            for slot_idx, slot in eligible:
                if slot.grammar is not None:
                    bias[slot_idx] = slot.grammar.bias_row()
            self._constrained_ticks += 1
        self.decode_steps += k
        self.ticks += 1
        span = self._step_span("tpu.engine.step", snapshot, k=k,
                               window=window or self.max_len,
                               sampled=sampled, step=self._steps)
        tag = "_bias" if biased else ""
        family = (f"decode_paged{tag}[k={k},pw={self._pick_page_width(window)}]"
                  if self.paged
                  else f"decode{tag}[k={k},w={window or self.max_len}]")
        entry = self._dispatch(loop, ("bias" if biased else "plain", k,
                                      sampled, window),
                               mask, "tick", snapshot, bias, span, family)
        self._steps += 1
        if self.metrics is not None:
            exemplar = next(
                ({"trace_id": slot.record.trace_id}
                 for _, slot in eligible
                 if slot.record is not None and slot.record.trace_id),
                None)
            self.metrics.record_histogram(
                "app_tpu_batch_size", float(len(snapshot)),
                exemplar=exemplar, model=self.model_name)
            self.metrics.set_gauge(
                "app_tpu_attention_window",
                float(window or self.max_len), model=self.model_name)
            self.metrics.increment_counter(
                "app_tpu_attn_kernel_total", model=self.model_name,
                path=self.attn_path)
            if self.paged:
                held = sum(len(s.nodes) + len(s.pages) for _, s in eligible)
                filled = sum(s.fill for _, s in eligible)
                if held:
                    self.metrics.set_gauge(
                        "app_tpu_kv_ragged_fill_ratio",
                        min(1.0, filled / (held * self.kv_page)),
                        model=self.model_name)
        return entry

    def _dispatch_spec(self, loop, eligible, g: int) -> Optional[_Fetch]:
        """Dispatch one speculative tick at rung ``g``: charge every slot
        g + 1 in-flight tokens and g + 1 of fill (the worst case; the
        publish refunds the rejected tail), cover pages for it."""
        covered = self._cover_pages(eligible, g + 1)
        if not covered:
            self._shed_if_wedged(eligible)
            return None
        eligible = covered
        window = self._tick_window(eligible, g + 1)
        mask, sampled, snapshot = self._charge(eligible, g + 1)
        self.spec_rungs[g] = self.spec_rungs.get(g, 0) + 1
        self.draft_steps += g + 1
        span = self._step_span("tpu.engine.spec", snapshot, gamma=g,
                               window=window or self.max_len,
                               step=self._steps)
        family = (f"spec_paged[g={g},pw={self._pick_page_width(window)}]"
                  if self.paged
                  else f"spec[g={g},w={window or self.max_len}]")
        entry = self._dispatch(loop, ("spec", g, sampled, window), mask,
                               "spec", (snapshot, g), None, span, family)
        self._steps += 1
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_tpu_batch_size", float(len(snapshot)),
                model=self.model_name)
            self.metrics.set_gauge("app_tpu_spec_gamma", float(g),
                                   model=self.model_name)
            self.metrics.increment_counter(
                "app_tpu_attn_kernel_total", model=self.model_name,
                path=self.attn_path)
        return entry

    def _tick_window(self, eligible, n: int) -> Optional[int]:
        """The window rung of a tick that writes ``n`` tokens a slot, from
        the fills before it is charged (JAX ``_pick_window``); the paged
        engine's ticks read the whole table (None) on the ragged route,
        and under ``ragged_attn="off"`` the rung's gather width."""
        if self._ragged:
            return None
        return self._pick_window([slot.fill for _, slot in eligible], n)

    def _dispatch(self, loop, key, mask: np.ndarray, kind: str,
                  payload, bias: Optional[np.ndarray] = None,
                  span: Optional[Span] = None,
                  family: Optional[str] = None) -> _Fetch:
        """Queue tick ``key`` with the mask and (paged) the page table,
        each only if it changed since the last upload (a snapshot taken
        here, in dispatch order), and a "bias" tick's bias; a rung not
        captured yet is noted as a serving compile. Returns its fetch,
        which carries the step span and executable family."""
        self.window_ticks[key[3]] = self.window_ticks.get(key[3], 0) + 1
        sent_mask = mask.tobytes()
        mask_up = None if sent_mask == self._sent_mask else mask
        table_up = None
        if self.paged and self._sent_table != self._table_version:
            table_up = self._table.copy()
        self._sent_mask, self._sent_table = sent_mask, self._table_version
        self._note_capture(key)
        name = "tpu.engine.spec" if kind == "spec" else "tpu.engine.step"
        return self._on_device(loop, kind, payload, self._annotated, name,
                               self._steps, self._run_tick, key, mask_up,
                               table_up, bias,
                               self._pool_epoch if self.paged else None,
                               span=span, family=family)

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
        if self.metrics is not None and proposed > 0:
            self.metrics.delta_updown_counter(
                "app_tpu_spec_proposed_total", float(proposed),
                model=self.model_name)
            self.metrics.delta_updown_counter(
                "app_tpu_spec_accepted_total", float(accepted),
                model=self.model_name)
        if self._spec_noted % _SPEC_WINDOW_TICKS \
                or not self._spec_window_proposed:
            return
        rate = self._spec_window_accepted / self._spec_window_proposed
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_spec_acceptance_rate", rate,
                                   model=self.model_name)
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
            if slot.record is not None:
                slot.record.rode_batch(len(eligible))
        return mask, sampled, snapshot

    def _cover_pages(self, eligible, k: int):
        """Grow each slot's pages (after its cached prefix pages) to cover
        its fill + k tokens, evicting cold prefixes when the free list is
        short. Slots the pool cannot cover sit this tick out. A dense
        slot's cache row covers max_len."""
        if not self.paged:
            return eligible
        if self._pool_stale():
            return []
        reclaim = self._prefix.evict_one if self._prefix is not None \
            else None
        covered = []
        for slot_idx, slot in eligible:
            need = -(-(slot.fill + k) // self.kv_page)
            held = len(slot.nodes) + len(slot.pages)
            short = need - held
            if short > 0:
                # a co-resident's reset since the stale check above
                # ends the epoch: the slot sits this tick out
                ids = self._pool.alloc(short, reclaim=reclaim,
                                       epoch=self._pool_epoch)
                if ids is None:
                    self._page_stalls += 1
                    continue
                self._table[slot_idx, held:held + short] = ids
                slot.pages.extend(ids)
                self._table_version += 1
                if slot.record is not None:
                    slot.record.pages_held = need
            covered.append((slot_idx, slot))
        return covered

    def _shed_if_wedged(self, eligible) -> None:
        """Pool-wedge breaker (JAX ``_shed_newest``): every eligible slot
        is short of pages and nothing was reclaimable. With a tick in
        flight (dispatched, queued on the device thread or not yet
        published) its slots' completions will free pages; with none,
        and the pool not reset under this engine (a stale epoch empties
        the list for another reason), the pool is wedged: fail the NEWEST
        request, whose pages let the others finish."""
        if not self.paged or self._ticks_inflight or self._pool_stale():
            return
        slot_idx, slot = max(eligible, key=lambda e: e[1].submitted_at)
        exc = RuntimeError(
            "kv page pool wedged: no slot can grow and nothing is "
            "reclaimable; shedding the newest request")
        if self.logger is not None:
            self.logger.error(
                "engine: %s (slot %d, %d pages back to the pool)",
                exc, slot_idx, len(slot.pages) + len(slot.nodes))
        self._fail_slot(slot_idx, slot, exc)

    # -- publishing --------------------------------------------------------------
    def _publish(self, entry: _Fetch, host: np.ndarray) -> None:
        """Hand a fetched step's tokens to its slots, in dispatch order. A
        spec tick refunds what it charged beyond ``accepts + 1``. The
        step's device seconds are charged, a sampled tick's anatomy
        completed with its device wait, and its span finished here, and
        the uploads metered since the last publish are emitted."""
        self._attribute_device_time(entry)
        self._emit_h2d()
        if entry.anatomy is not None and self.telemetry is not None:
            anatomy = entry.anatomy
            anatomy["device_wait_s"] = time.monotonic() - entry.dispatched_at
            anatomy["kind"] = entry.kind
            anatomy["batch"] = len(entry.payload[0] if entry.kind == "spec"
                                   else entry.payload)
            anatomy["step"] = self._steps
            anatomy["at"] = time.time()
            self.telemetry.note_tick(anatomy)
        if entry.kind == "prefill":
            for slot_idx, gen, row in entry.payload:
                self._push_tokens(slot_idx, gen, [int(host[row])])
        elif entry.kind == "tick":
            self._ticks_inflight -= 1
            plan = faults.active()
            if plan.enabled and entry.payload \
                    and plan.should("nan_logits"):
                # NaN/inf logits argmax to out-of-range ids: model it on
                # the host by poisoning the first participant's fetched
                # tokens, which quarantines exactly that slot
                host = host.copy()
                host[:, entry.payload[0][0]] = -1
            for slot_idx, gen in entry.payload:
                self._push_tokens(slot_idx, gen,
                                  [int(t) for t in host[:, slot_idx]])
        else:
            self._ticks_inflight -= 1
            snapshot, g = entry.payload
            toks, accepts = host[:g + 1], host[g + 1]
            proposed = accepted = 0
            for slot_idx, gen in snapshot:
                a = int(accepts[slot_idx])
                slot = self._slots[slot_idx]
                if slot.gen == gen:
                    slot.inflight -= g - a
                    slot.fill -= g - a
                    slot.spec_proposed += g
                    slot.spec_accepted += a
                    proposed += g
                    accepted += a
                self._push_tokens(slot_idx, gen,
                                  [int(t) for t in toks[:a + 1, slot_idx]])
            self._note_spec(proposed, accepted)
        if entry.span is not None:
            entry.span.finish()

    def _emit_h2d(self) -> None:
        """Emit the uploads the device thread metered (JAX's
        ``app_tpu_h2d_bytes_total`` / ``app_tpu_h2d_seconds`` by path),
        here on the loop thread."""
        metered = self._staging.drain_meter()
        if self.metrics is None:
            return
        for path, nbytes, seconds in metered:
            self.metrics.delta_updown_counter("app_tpu_h2d_bytes_total",
                                              float(nbytes), path=path)
            self.metrics.record_histogram("app_tpu_h2d_seconds", seconds,
                                          path=path)

    def _push_tokens(self, slot_idx: int, gen: int,
                     tokens: List[int]) -> None:
        """Append generated tokens to a slot, handling eos and budget;
        tokens of a stale generation (slot reclaimed since) are dropped.
        The first token closes the prefill span and records the TTFT;
        each token counts toward the SLO tracker's raw tokens; a
        finished slot's outcome is classified by its deadline. Under
        ``coalesce_stream`` a stream's tokens of this call go on its
        queue as one list, before its end or error."""
        slot = self._slots[slot_idx]
        if slot.gen != gen:
            return
        slot.inflight -= len(tokens)
        if not slot.active:
            return
        if not slot.tokens:
            self._first_token(slot_idx, slot)
        pushed = 0
        chunk: Optional[List[int]] = [] if self.coalesce_stream else None
        for token in tokens:
            if token < 0 or token >= self.cfg.vocab_size:
                if chunk and slot.queue is not None:
                    slot.queue.put_nowait(chunk)
                # NaN/inf logits argmax to implementation-defined ids: fail
                # this request, not the tick
                exc = RuntimeError(
                    f"slot {slot_idx} produced out-of-range token {token} "
                    f"(vocab {self.cfg.vocab_size}); NaN/inf logits "
                    f"upstream — request quarantined")
                self._quarantine_slot(slot_idx, slot, "nan_logits", exc)
                return
            slot.tokens.append(token)
            slot.remaining -= 1
            pushed += 1
            if slot.record is not None:
                slot.record.tokens += 1
            if self.slo is not None:
                self.slo.record_tokens(1)   # raw throughput, as produced
            if slot.queue is not None:
                if chunk is not None:
                    chunk.append(token)
                else:
                    slot.queue.put_nowait(token)
            done = slot.remaining <= 0 or (slot.eos_id is not None
                                           and token == slot.eos_id)
            if slot.grammar is not None and not done:
                # a complete match (no grammar-valid continuation left)
                # finishes the slot as eos does, and so does a violation;
                # a walker that raises poisons this request only
                try:
                    slot.grammar.advance(token)
                    done = slot.grammar.must_stop
                except Exception as exc:  # noqa: BLE001 — this request's
                    if chunk and slot.queue is not None:
                        slot.queue.put_nowait(chunk)
                    self._quarantine_slot(slot_idx, slot, "grammar", exc)
                    return
            if done:
                self._record_outcome(slot)
                if slot.future is not None and not slot.future.done():
                    slot.future.set_result(list(slot.tokens))
                if slot.queue is not None:
                    if chunk:
                        slot.queue.put_nowait(chunk)
                        chunk = None
                    slot.queue.put_nowait(_DONE)
                    slot.queue = None
                self._finish_slot(slot_idx, slot, "done")
                break
        if chunk and slot.queue is not None:
            slot.queue.put_nowait(chunk)
        if pushed and self.metrics is not None:
            # the class's share of the tokens delivered: what the WFQ
            # weights shape
            self.metrics.delta_updown_counter(
                "app_tpu_sched_tokens_total", float(pushed),
                model=self.model_name, cls=slot.cls)

    def _first_token(self, slot_idx: int, slot: _Slot) -> None:
        """A request's first published token: submit to now is its TTFT
        (queue wait, prefill, fetch); its prefill span ends and its
        decode span opens."""
        ttft = time.monotonic() - slot.submitted_at
        self.ttfts.append(ttft)
        record = slot.record
        if record is not None:
            record.first_token()
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_tpu_ttft", ttft,
                exemplar=({"trace_id": record.trace_id}
                          if record is not None and record.trace_id
                          else None),
                model=self.model_name)
        if self.slo is not None:
            self.slo.record_ttft(ttft)
        if slot.phase_span is not None:
            slot.phase_span.finish()
            slot.phase_span = None
        if self.tracer is not None:
            slot.phase_span = self.tracer.start_span("decode",
                                                     parent=slot.req_span)
            slot.phase_span.set_attribute("slot", slot_idx)

    def _record_outcome(self, slot: _Slot) -> None:
        """A finished request's terminal SLO outcome: ``ok`` within its
        deadline (or with none; its tokens count as goodput), else
        ``violated``, with how late and its trace id."""
        if self.slo is None:
            return
        finished_at = time.monotonic()
        outcome = self.slo.classify(slot.deadline, finished_at)
        late_by_s = (finished_at - slot.deadline
                     if slot.deadline is not None
                     and finished_at > slot.deadline else None)
        self.slo.record_outcome(
            outcome, tokens=float(len(slot.tokens)), cls=slot.cls,
            model=self.model_name,
            trace_id=(slot.record.trace_id if slot.record is not None
                      else None),
            late_by_s=late_by_s)

    def _reject(self, req: _Request, exc: BaseException) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        if req.queue is not None:
            req.queue.put_nowait(exc)

    def _quarantine_slot(self, slot_idx: int, slot: _Slot, reason: str,
                         exc: BaseException) -> None:
        """Poison-request quarantine (JAX ``_quarantine_slot``): a slot
        whose step output is unusable (its grammar walker raised, or an
        out-of-range token showed NaN/inf logits) is failed alone and
        counted by ``reason``, with an ``error`` SLO outcome; the tick's
        other slots keep their tokens and the loop keeps serving, where
        the loop's catch-all would fail every outstanding request and
        rebuild the device state."""
        self._quarantined[reason] = self._quarantined.get(reason, 0) + 1
        if self.logger is not None:
            self.logger.error("engine: quarantined slot %d (%s): %r",
                              slot_idx, reason, exc)
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_slot_quarantine_total", model=self.model_name,
                reason=reason)
        if self.slo is not None:
            self.slo.record_outcome("error", cls=slot.cls,
                                    model=self.model_name)
        self._fail_slot(slot_idx, slot, exc)

    def _fail_slot(self, slot_idx: int, slot: _Slot,
                   exc: BaseException) -> None:
        if slot.future is not None and not slot.future.done():
            slot.future.set_exception(exc)
        if slot.queue is not None:
            slot.queue.put_nowait(exc)
            slot.queue = None
        self._finish_slot(slot_idx, slot, "error")

    def _release_slot_kv(self, slot_idx: int, slot: _Slot) -> None:
        """Return a finished slot's pages to the pool (a page the prefix
        trie adopted keeps the trie's reference), unpin its prefix nodes,
        and reset its table row to the sentinel, so a recycled slot never
        reads a stale page. A dense slot's row is overwritten by its next
        insert."""
        if not self.paged:
            return
        if slot.nodes:
            if self._prefix is not None:
                self._prefix.release(slot.nodes)
            slot.nodes = []
        if slot.pages:
            # ids of an epoch a reset ended went back with it
            self._pool.release(slot.pages, epoch=self._pool_epoch)
            slot.pages = []
        row = self._table[slot_idx]
        if (row != self._pool.sentinel).any():
            row.fill(self._pool.sentinel)
            self._table_version += 1

    def _finish_slot(self, slot_idx: int, slot: _Slot, status: str) -> None:
        """Retire a slot: inactive, a new generation (in-flight tokens
        are dropped), KV released, back on the free list; its open phase
        span finishes (tagged unless ``status`` is ``done``) and its
        record closes with ``status``."""
        slot.active = False
        slot.gen += 1
        slot.inflight = 0
        slot.grammar = None
        self._release_slot_kv(slot_idx, slot)
        if slot_idx not in self._free:
            self._free.append(slot_idx)
        if slot.phase_span is not None:
            if status != "done":
                slot.phase_span.set_status(
                    "ERROR" if status == "error" else "CANCELLED")
                slot.phase_span.set_attribute("outcome", status)
            slot.phase_span.finish()
            slot.phase_span = None
        if slot.record is not None:
            if slot.record.tokens:
                slot.record.first_token()   # idempotent backstop
            self.recorder.finish(slot.record, status)
            slot.record = None
        slot.req_span = None

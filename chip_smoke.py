#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gofr_tpu_torch``).

Drives the port's serving paths on one NVIDIA GPU at the full
``llama3-8b`` geometry (random weights from ``--seed``): the paged Llama
``/generate`` engine, with prefill through the hand-written
flash-attention kernel and every decode step through the hand-written
ragged paged attention kernel; the same engine with speculative decode,
whose 4-layer draft decodes through the hand-written flash-decode kernel
and whose target verifies G tokens at once through the ragged kernel's
G > 1 launch; and both again with ``kv_int8`` (int8 KV pool with float32
scale planes), whose decode and verify go through the ragged kernel's
int8 instantiation; then the example app's default preset, ``small``
(head_dim 64), at the example's engine settings, and prefix KV reuse
on shared-prefix traffic, then grammar-constrained decoding and
admission (SLO classes, deadlines, brownout), then the engine's
telemetry hooks, fault sites and SLO control loop, then every engine
argument the example app passes (the MoE model module, a shared page
pool, ``ragged_attn``, upload coalescing) and int8 weights, then the
telemetry plane the app wires beside an engine and the engine's
operating points (a move prewarmed while serving), then disaggregated
serving (KV export and adoption through the KV wire codec, the router
and its in-process transport, session migration) and the model
registry, then the fleet control plane and the auto-tuner, then the
executor path (ResNet-50 and BERT-base through the ``Executor``, one
CUDA graph a bucket, and the ``DynamicBatcher``) and the batch lane,
then training on one card (the train and eval steps, optax's AdamW,
checkpoint and resume in the JAX package's format).
Phases, each of which raises (exit code != 0) on failure:

1. card identity (``nvidia-smi`` name and power limit, torch/CUDA);
2. kernel build (one ``nvcc`` per source, all at once) and its time,
   and how many clusters of each of the ragged kernel's 32
   instantiations (head_dim 128 and 64) the card keeps resident (verify
   at G 5): 8 blocks a cluster at head_dim 128, and at 64 for group x G
   over 8; the head_dim-64 body's ``ceil(P * page / 512)`` (at most 8,
   one a sweep of 512 positions) otherwise, with its launch's blocks
   against those resident at B 8, Hkv 16 and tables of 4-32 pages of 32
   (``small``'s rungs);
3. flash kernel (bf16: both products on the tensor cores through wgmma)
   vs its plain version, bf16, Hq 32 / Hkv 8 / D 128, causal, S in
   {32, 128, 512, 2048}, B in {1, 4}; timed beside the plain version and
   ``scaled_dot_product_attention`` (a yardstick only), with its ratio to
   that call and its TFLOP/s;
4. ragged kernel (each slot's pages split across a cluster of 8
   blocks at head_dim 128, of one block per sweep of the table at 64,
   which serves all of the slot's queries), decode (G = 1), vs its plain
   version, 8 slots, page 32, 64
   table columns, fills {0, 1, 31, 32, 33, 700, 2047, 512}, then the
   full-card shape (every fill 2047): over bf16 pools with every
   position no live entry references NaN, then over int8 pools (the same
   rows quantised) whose scale planes are NaN at every such position;
   each timed with its bound and GB/s;
5. ragged kernel, verify, vs its plain version on the same layouts, G in
   {2, 3, 5} with fills {0, 1, 31, 32, 33, 700, 2047 - G, 512}, then the
   full-card shape at G 5 (every fill 2042), bf16 then int8, and for each
   pool type the kernel's verify instantiation at G = 1 bit-identical to
   its decode instantiation;
6. flash-decode kernel (positions split across blocks in chunks of 256,
   then a combine) vs its plain version, bf16, 8 slots, T 2048, Hq 32 /
   Hkv 8, fills {0, 1, 127, 128, 129, 700, 1500, 2047}, every row past a
   fill NaN; timed beside ``scaled_dot_product_attention`` with a per-row
   mask (a yardstick only), with its ratio to that call and its GB/s;
7. a 2-layer full-width model: prefill + 4 paged decode steps through the
   kernels on the card (bf16) against the plain path on the CPU (f32),
   with a bf16 pool, then with ``kv_int8``;
8. perfect draft: the 2-layer model as its own draft (the draft through
   flash decode), then the ``kv_int8`` model with the same weights as its
   bf16 draft; each acceptance rate must be at least 0.5;
9. the ``llama3-8b`` engine at full width, 8 of its 32 layers
   (``--layers``; every ``llama3-8b`` engine of phases 9-18, 24, 26,
   28, 31d, 32a-c and 33a-d), answering 8 concurrent requests (prompts over
   every bucket, 32 new tokens each, one sampled), with the kernels'
   launch counts checked against the engine's prefill dispatches and
   decode steps, then one streamed request. Every engine of phases 9-12
   first captures its ticks and its full prefills at every prompt count
   as CUDA graphs (``warmup()``, its seconds, graph counts and the
   allocator's reserved bytes added by the tick and the prefill captures
   printed), runs 2 ticks in flight (``max_inflight_ticks``), and must
   replay a graph for every tick and every prefill of the burst, with 2
   ticks in flight at some point of it; phase 9 then serves the burst again at
   ``max_inflight_ticks=1`` and its 7 greedy completions must be the
   same tokens;
10. the same engine with speculative decode (γ 4, a draft made of views of
    the target's first 4 layers, embedding and head) on the same 8
    requests, launch counts checked against its prefill dispatches, spec
    ticks, Σ(g + 1) draft steps and plain decode steps;
11. phase 9 with ``kv_int8`` (the same weights): launch counts, and the
    pool's bytes against phase 9's for the same page count;
12. phase 10 with a ``kv_int8`` target and the same bf16 draft;
13. the ragged kernel over identity page tables of a dense cache (the
    dense engine's target route): 8 slots, T 2048, page 32, every window
    rung 128 ... 2048, fills {0, 1, 31, 127, 128, 700, 1500} cut to the
    rung and one inactive row past it (2047), every position past a
    row's reach NaN; decode and verify at G 5, bf16 then int8, held to
    phases 4-5's gates and timed with the bound from the bytes, bf16
    decode and verify beside one ``scaled_dot_product_attention`` call
    over the dense cache with a per-row length mask, causal among the G
    new tokens (a yardstick only, its largest difference from the kernel
    and the kernel's time over its time reported at each rung; phase 19
    too, at D 64);
14. the flash-decode kernel over window views of a T 2048 cache (the
    full cache's slot stride), rungs 128 ... 1024, against its plain
    version within phase 6's gate, timed;
15-18. the dense-cache engine (``paged_kv=False``, the default; the
    attention-window ladder 128 ... 1024 and the whole cache) in the
    four configurations of phases 9-12, on the same weights and the same
    burst: each captures its startup rungs (``warmup()``), every burst
    tick and prefill must replay a graph, the graphs and the burst's ticks are
    counted by rung, the launch counts are checked against its counters,
    one streamed request of 60 new tokens on a 100-token prompt must cross
    rung 128 to 256, and its 7 greedy completions must be the paged
    engine's tokens of the same configuration;
19. every kernel at head_dim 64, the ``small`` preset's shapes (Hq =
    Hkv = 16, B 8, max_len 1024), under phases 3-6's gates: flash
    prefill (B 4, S 512, with its ratio to SDPA), the ragged kernel's
    decode and verify G 5 over bf16 and int8 pools (page 32, 32 table
    columns, fills 0/1/31/32/33/500/512 and the last position) and over
    identity tables at each rung of a 1024-position cache, its verify
    instantiation at G = 1 bit-identical to its decode one, and flash
    decode over T 1024 and its window views 128/256/512;
20-23. the ``small`` preset at full width (vocab 32000, 2 of its 8
    layers, dim 1024, 16/16 heads, ffn 2816, random weights) at the
    example app's engine settings (dense, max_len 1024, 8 slots, 16
    steps a tick, 4 ticks in flight) serving phase 9's burst: dense bf16
    (20), paged (21; its greedy tokens must be 20's), dense ``kv_int8``
    (22; the cache exactly 0.53125x 20's bytes), speculative with a
    2-layer draft of views, bf16 then int8 target (23); every tick and
    prefill a graph replay, launch counts as the counters predict; on
    20's engine the burst again with its prefills replayed and then run
    eagerly (each prefill call's host seconds on the device thread,
    tok/s, TTFT; the greedy completions must be equal);
24. prefix KV reuse: two waves of 8 requests, each a 256-token system
    prompt (8 pages of 32) and its own suffix of 5-200 tokens, 32 new
    tokens, one sampled; wave 1 fills the store, wave 2 must admit all 8
    at prefix rung 8, and with a bf16 cache its greedy tokens must equal
    the store-off engine's (a difference prints its position and the
    top-2 logit margin there); two rounds, each with its own system
    prompt, the first capturing the suffix prefill rungs (the second's
    prefills must all replay graphs, none captured); TTFT and
    the prefill stream's time of the second round's wave 2 with the
    store on and off, reported; on ``small`` dense bf16,
    paged bf16 and dense ``kv_int8`` (after phase 23), and on
    ``llama3-8b`` dense bf16 (after phase 18);
25. one ``{"kernels": [...]}`` line (every instantiation, head_dim 128
    and 64, each with its launches on the main paths), then the card
    line, then the last line ``{"ok": true, "device": {...}}`` (printed
    after phases 26-27, which run after phase 24's ``small`` cells and,
    at ``llama3-8b`` width, after phase 18);
26. grammar-constrained decoding on the example app's own model
    (``small`` over its byte tokenizer's 256 ids, random weights, the
    example's engine): a burst of 8 requests over phase 9's prompt
    lengths, 32-48 new tokens, four constrained (regex ``(yes|no)!``,
    the schema ``{"ok": boolean}``, an object schema with an integer
    and a string, the regex sampled with a seed), four not (one
    sampled); served once (the biased rungs are captured at first use,
    their seconds printed), then counted: every constrained output walks
    its grammar (a complete one fullmatches), the unconstrained outputs
    equal the all-unconstrained burst's, every tick replays a graph,
    every ``bias`` graph is k = 1, launches as the counters predict; the
    paged engine (page 32) must give the greedy constrained outputs;
    mixed and all-unconstrained tok/s, TTFT p50, biased ticks and bias
    bytes a tick printed; then at ``llama3-8b`` width (2 of the 8
    constrained, the dense bf16 engine, a 4.1 MB bias slab a tick);
27. admission on the ``small`` spec engine (2-layer draft of views, γ
    4): brownout level 1 refuses a batch request (``BrownoutShed``) and
    serves one with a 500 ms deadline, level 2 dispatches spec rung 1
    only, level 3 no spec tick, level 0 admits batch again, a
    constrained request walks its grammar; a request whose deadline has
    passed raises ``DeadlineExceeded`` with no prefill; a 2-slot engine
    admits a mixed-class backlog in ``ClassQueues``' order;
28. telemetry and the SLO control loop on ``small`` at the example's
    engine (random weights from ``--seed`` + 4): phase 9's burst on an
    engine with no hook and on one with every hook (the port's metrics
    sink with the catalog registered and an ``error`` that raises, a
    tracer into a list, an SLO tracker, a flight recorder, the anatomy
    of every tick), 3 pairs in turns: equal tokens; one ``queue.wait``,
    ``prefill`` and ``decode`` span a request under its request span,
    every engine-step span linking a request; one TTFT a request and the
    tracker's tokens the tokens emitted; device seconds by class = by
    family within 1e-6 s; one anatomy entry a tick, no negative phase;
    parameter bytes, allocated >= attributed bytes; serving compiles =
    lazy captures, 0 after ``warmup()``; the views serialise; tok/s and
    TTFT p50 on and off, the anatomy's medians, device seconds / wall
    printed. Then ``nan_logits`` once (exactly one request quarantined,
    the others' tokens unchanged) and ``tick_exception`` with ticks in
    flight (every caller gets ``FaultError``, the next burst's tokens
    unchanged, no graph captured again); then on the spec engine a
    ``Watchdog`` (hysteresis 2, attainment 0.9, a 0.8 s window) feeding
    a ``BrownoutLadder`` (escalate after 1, recover after 2) that sets
    the engine's level: a burst of 1 ms deadlines ends violated, two
    evaluations take the level to 2 and the watchdog to DEGRADED, a
    batch request is refused, a calm burst and 4 evaluations bring the
    level back to 0, each level change an event on the active span.
    At ``llama3-8b`` width (after phase 18), one burst without and one
    with every hook on the dense bf16 engine: equal tokens, tok/s ratio;
29. the ``small`` spec engine at the example's engine with a 2-layer
    ``kv_int8`` draft of views (after phase 24), dense and paged: the
    draft decodes through the ragged kernel's int8 instantiation over its
    identity tables; every tick and prefill a replay, launches as
    counted; the same engine with its prefills run eagerly gives the
    same greedy completions, and so does the paged engine;
30. the example app's engine arguments (after phase 29, on phase 20's
    weights): (a) ``moe-small`` (``moe.config(base=llama.config("small",
    vocab_size=256, n_layers=4))``: dim 1024, 4 of 8 layers, 16/16
    heads, ffn 2816, 4 experts, full width, random weights from
    ``--seed`` + 5)
    at the example's engine with the app's ``warmup(prompt_counts=(1,
    8))``: every prefill graph at JAX's rows (no padding to
    ``CUDA_MIN_PREFILL_ROWS``), a tick and an 8 x 512 prefill replayed
    = run eagerly bit for bit on random live state, phase 9's burst
    served twice (the second counted: every tick and prefill a replay,
    ragged launches = layers x decode steps, no flash launch: JAX's MoE
    prefill is dense), then profiled (idle share); tok/s, TTFT, capture
    seconds and reserved bytes, and the dispatch/combine einsums' share
    of the 8 x 512 prefill and of a decode step (the two einsums timed
    alone at the path's shapes, times the layers); (b) two ``small``
    paged engines sharing one ``PagePool`` of ``budget_bytes`` 512 MiB
    (the app's MODELS path): each one's burst alone, then both at once
    (each engine's tokens equal its own alone, every page back, launches
    as counted), then a reset by one while the other streams (its
    request fails, its next burst equals its tokens alone); an engine
    sized by ``kv_pool_bytes`` has that many pages; (c) ``ragged_attn=
    "off"`` on the small paged engine: no ragged launch in its burst,
    tok/s beside phase 21's (``auto``), one decode step's logits on a
    fixed prompt within the ragged row gate of the ragged route's; (d)
    ``coalesce_uploads`` and ``coalesce_stream`` on against off on the
    small dense engine: the same greedy and streamed tokens, H2D copies
    a tick, tok/s, idle share, a coalesced engine's tick replayed = run
    eagerly; (e) the same engine over ``llama.quantize_params`` weights:
    tok/s beside bf16's, the weight bytes;
31. the telemetry plane and the operating point (after phase 30, on
    phase 20's weights and the example's engine, with metrics, an SLO
    tracker and a flight recorder): (a) the planes ``App.start`` wires
    (a ``TrafficRecorder``, a ``TimeSeriesStore`` sampled every 0.1 s
    over the default signals with every tick's anatomy, an
    ``ErrorBudgetPlane`` feeding a ``Watchdog``'s ``budget_fn`` and its
    ``BrownoutLadder``'s escalation gate, ``WorstOffenders`` on the
    flight recorder), off and on in two pairs of phase 9's burst, the
    last counted: equal tokens, the recorder's 8 admitted and finished
    and its prompt-length histogram, every signal sampled, queue_depth 8
    read while the burst is queued, one anatomy entry a tick, at most k
    diagnosed offenders with a dominant phase of ``PHASES``, the xlaz
    ladder from the workload trace, every tick and prefill a replay,
    launches as counted, no brownout, no budget burning; tok/s and TTFT
    p50 on and off printed; (b) the recorded trace exported, loaded and
    replayed twice on a ``shadow_clone`` at k 8: equal digests, the
    clone's weight tensors the engine's storage, no hooks, its reserved
    bytes; (c) buckets (32, 128, 256, 512) at k 32: refused before its
    prewarm, prewarmed while the burst is served again and again (every
    burst's tokens the burst's without a prewarm, a thread reading the
    allocator meanwhile without an error; the graphs, seconds, reserved
    bytes and the longest gap between two ticks printed), applied
    (``xlaz()`` generation 1, source ``autotune``), a burst of 9 with a
    256-bucket prompt at 64 tokens (ticks at k 32, every tick and
    prefill a replay, no serving compile, launches as counted), the
    seed point back (nothing captured, the burst's tokens), then
    ``slots_cap`` 2 (at most 2 slots active at any publish, the burst's
    tokens); (d) at ``llama3-8b`` width (after phase 28's), phase 15's
    dense bf16 engine prewarms k 8 while its burst is served (phase 15's
    greedy tokens), applies it and serves the burst (no capture,
    launches as counted); tok/s at k 4 and k 8;
32. disaggregated serving: (a) at ``llama3-8b`` (after the other
    ``llama3-8b`` phases, on their weights) a dense prefill replica (phase
    15's settings, warmed with count 1, which captures each bucket's
    export rung) and a paged decode replica (phase 9's) behind a
    ``ClusterRegistry`` and a ``DisaggRouter`` over ``InProcTransport``
    serve phase 9's burst, each request streamed through the router: the
    7 greedy completions must be phase 9's, the decode replica must run
    no prefill (``prefill_bucket_tokens`` 0, 8 adoptions), the prefill
    replica must export 8, every tick and export must be a replay, and
    the launches are counted (flash on the prefill replica, ragged on the
    decode replica); then the same over the ``kv_int8`` engines (the int8
    codec), against phase 11's tokens; tok/s and TTFT p50/max through the
    router beside the monolithic engine's, each request's wire bytes and
    prefill and transfer legs, the host's pack/frames/assemble/unpack of
    a 512-token payload with their GB/s, the reserved bytes of the export
    captures; (b) on the bf16 decode replica, a live session of a
    300-token prompt exported with ``export_session`` after 8 of 32
    tokens (ticks in flight) and resumed with ``adopt_session`` on a
    second paged engine on the same weights, greedy and sampled (seeded):
    each whole stream equals the unmigrated one and the source pool's
    free pages return to their baseline; (c) ``kv_chunk_corrupt:@1``
    costs exactly one fresh prefill round with the tokens unchanged, and
    a replayed adopt with the same dedupe id returns the first stream and
    claims no second slot or page set; (d) (after phase 31, on phase 20's
    ``small`` weights) a ``ModelRegistry`` over two paged engines sharing
    one 512 MiB ``PagePool``, warmed through the registry: both routes'
    greedy tokens equal, the watchdog's ``DEGRADED`` and a drain route
    the first model to its fallback, health UP, launches as counted, and
    ``hbm_attribution`` counts the shared pool once.
33. the fleet and the tuner: (a-d, after phase 32a-c on the
    ``llama3-8b`` weights) two paged replicas behind a ``FleetRouter``:
    the ``Autoscaler`` scales up under a backlog and drains down,
    affinity waves, a migration and a drain, two crashes healed by
    resume; (e, after phase 32d on ``small``) the ``AutoTuner``
    applying, rejecting and rolling back by shadow replay;
34. the executor path (after phase 33e), bf16 at full width: (a)
    ResNet-50 (224^2, 1000 classes) and (b) BERT-base (max_len 64, its
    ``mean`` embedding), each registered at the examples' buckets (1, 4,
    16, 32): ``warmup()`` captures 4 graphs (seconds, reserved bytes);
    each bucket's replay bit for bit its eager run, both timed (CUDA
    events, images or sequences a second); B 4 on the card against the
    CPU's float32 path (ResNet max|d|/max|ref| <= 2e-2; BERT the same
    and every row's cosine >= 0.999); 256 single requests through the
    ``DynamicBatcher`` (max_batch 32, 2 ms) at 64 in flight (BERT 5-64
    tokens): latency p50 / p99, flush causes, batch fill, duty cycle and
    MFU against 989 TFLOP/s, every execute one replay and no capture;
35. (a) on phase 20's ``small`` weights at the example's dense engine,
    a ``BatchLane`` over the port's ``InMemoryBroker``: phase 20's burst
    under an interactive deadline with the lane off, on, on, off (32
    jobs of 64-256 prompt tokens x 64 new each on-turn): interactive
    TTFT p50 and tok/s, the lane's tok/s; every lane result equal to a
    direct ``generate`` of its job, the jobs served in the ``batch``
    class, every tick and prefill a replay, launches as counted; a
    malformed job dead-lettered with the next job served; a lane gated
    at ``pause_depth`` 4 pauses (``admission_depth``) behind a backlog
    and resumes; (b) the pool wedge on a paged engine of 8 pages of 4,
    2 slots, 1 tick in flight, plain and speculative: the first of two
    requests returns its 20 tokens, the second fails with the wedge's
    ``RuntimeError`` within 10 s, the free pages come back;
36. training (after phase 35), each model random from ``--seed`` and
    trained on one fixed batch: (a) ``small`` (8 layers, dim 1024, D 64,
    vocab 32000) bf16 at B 8 x S 1024, 20 steps of ``make_train_step``:
    the loss falls from about ln 32000; a float32 step from the same
    state within 2e-2 relative of the bf16 loss, its gradients' cosines
    >= 0.99 leaf by leaf; remat's loss and gradients within the plain
    step's run-to-run spread (the step twice from one state); step ms
    (CUDA events, median of the last 10), tokens/s, ``FlopCounterMode``
    FLOPs and MFU against 989 TFLOP/s, peak bytes with and without
    remat, the device's idle share of a step; (b) the whole
    ``TrainState`` saved at step 2, restored into a fresh state (bits
    equal, and from ``step_2.old``), step 3 resumed within the spread of
    the uninterrupted run; (c) ``make_eval_step`` through the flash
    kernel (``n_layers`` launches a call) within 1e-2 relative of the
    plain eval; (d) refusals: ``make_train_step`` with ``use_flash``, and
    each kernel wrapper under autograd, with no launch; (e)
    ``moe-small`` (8 experts) bf16, 5 AdamW steps of ``moe.loss_fn`` at B
    4 x S 512: the loss falls, the router's gradients finite and nonzero,
    dropped tokens a layer; (f) ``llama3-8b``'s width at depth 2 (the
    cut logged), 3 remat steps at B 2 x S 512: the loss falls, step ms,
    peak bytes.
37. the app framework (after phase 28's ``small`` half): the port's
    ``examples/llama_generate`` app at its defaults (``small``, vocab 256,
    8 slots, max_len 1024, k 16, 4 ticks in flight, dense, ports 0),
    started (warm-up captures every graph before the bind): alive and
    health; 8 concurrent ``POST /generate/stream`` over HTTP (prompts of
    5-512 bytes from a seeded corpus, 32 new tokens, one sampled), whose
    greedy tokens must equal the engine's direct streams of the
    tokenizer's ids and whose sampled stream must equal the unary
    ``/generate``; ``app_tpu_ttft`` and ``app_http_response`` count the
    burst; a 1 ms deadline behind 8 busy slots is shed with 503 and
    counted ``expired``; one flight record a request's trace id; gRPC
    ``/gofr.Llama/generate`` where ``grpc`` imports (the log says which);
    every tick and prefill a replay, launches as counted; then turns
    direct, HTTP, HTTP, direct (tok/s, client TTFT p50 at the first
    token or SSE frame, the engine's TTFT p50, the idle share under the
    profiler); after ``stop()`` every slot free, no tick in flight, the
    device thread ended, the pinned slab bytes as after the turns.
38. the debug pages and a remote replica (after phase 37): the example
    at its defaults in two processes on the card, a prefill replica
    (``python -m gofr_tpu_torch.examples.llama_generate`` as a child,
    ``CLUSTER_ROLE=prefill``, its own ports, its log under
    ``build/phase38/``) and a decode replica here (``CLUSTER_ROLE=decode``,
    ``GENERATE_PAGED_KV=1``, ``CLUSTER_PEERS`` naming the child with its
    gRPC target), warmed up side by side; 8 × 32 greedy requests of
    5-512 bytes through ``/disagg/generate`` equal the decode replica's
    ``/generate``, with no prefill on the decode replica and every
    handoff over ``gofr.Disagg/fetch``; an ``HTTPTransport`` without a
    gRPC target carries one handoff over HTTP whose adoption gives the
    same tokens; every ``/debug/*`` page and ``/debug/`` answer 200 on
    both replicas with their sections filled (statusz's engine, devices
    and compiles; hbmz's attributed bytes and the allocator's occupancy;
    timez's samples; clusterz with both replicas, the peer fresh,
    goodput), tracez stitches one request with its phases summing to
    the end-to-end time, whyz gives a verdict; a profile of a burst
    through ``/debug/profiler`` names ``flash_wgmma_kernel`` and
    ``ragged_kernel`` with as many events as launches counted, and a
    graph captured under a profile replays its tokens; after the child
    is stopped, the circuit opens, clusterz marks the peer stale for it
    and ``/disagg/generate`` answers 503. Printed: tok/s and TTFT p50 in
    turns monolithic, disaggregated, disaggregated, monolithic; KV bytes
    a request and one handoff's fetch seconds over gRPC and HTTP; each
    page's render ms during a burst; tok/s with the pages polled every
    100 ms against not, in turns; tok/s under the profiler and the
    trace's bytes; the phase's seconds.
39. serving over a device mesh, every shard on the one card (a mesh's
    device may repeat; the distinct-card route runs only with several
    cards, 39-multicard, else a ``{"phase": "39-multicard", "skipped":
    "1 card"}`` line): (a) the llama3-8b engine over ``{dp: 1, tp: 1}``,
    dense and paged, whose greedy tokens must be phases 15's and 9's bit
    for bit; (b) at tp 2 (Hq 16 / Hkv 4 a rank), dense, paged and paged
    ``kv_int8``: teacher-forced logits of a prefill and 4 decode steps
    against the unsharded model's within ``MESH_REL_TOL``, phase 9's
    burst (every tick and prefill a replay, each rank's kernels in the
    launch counts), a tick's replay against its eager run bit for bit,
    and the count of greedy tokens equal to the unsharded engine's; tok/s,
    idle share and capture cost at tp 2 beside tp 1; (c) ``small`` at tp
    2 and at dp 2 x tp 1, dense, the same gates on phase 20's burst; (d)
    the kernels at a tp rank's shapes against their plain versions,
    timed; (e) ring attention at sp 4, S 8192, against the plain causal
    attention; (f) the pp 2 forward of ``small`` against the unsharded
    forward; (g) ResNet-50 through the executor at dp 2 against dp 1;
    (h) the example's ``MESH=1`` serving ``/generate`` and ``MESH=tp:2``
    refused at build; (i) ``initialize_distributed`` at world size 1 over
    NCCL and ``dcn_check``'s two processes on the card.
40. training over a device mesh (after phase 39), every shard on the one
    card, phase 36's weights and batches (40-multicard: dp 2 over two
    cards, else a ``{"phase": "40-multicard", "skipped": "1 card"}``
    line): (a) ``small`` whole at B 8 x S 1024 over dp 2 x tp 2 x sp 2
    with ``use_sp``: one float32 step from the unsharded float32 step's
    state, its loss within 1e-5 relative, every gradient and moment leaf
    within 1e-4 of its largest element, the params as ``past_step_gate``
    says; three bf16 steps whose loss falls, the first within 2e-2 of the
    unsharded step's, gradient cosines >= 0.99 leaf by leaf; step ms,
    peak bytes, idle share; (b) ``llama3-8b``'s width at 2 layers, remat,
    B 2 x S 512: tp 2 three steps (the first loss within 2e-2 of tp 1's),
    tp 4 one step (finite, within 10% of ln V), the eval over tp 2 through
    the flash kernel at Hq 16 / Hkv 4 (one launch a layer and rank,
    within 1e-2 of tp 1's flash eval); (c) ``moe-small`` at B 4 x S 512:
    ep 2 at float32 (drops layer by layer equal to the unsharded model's,
    loss and gradients within (a)'s float32 gates), ep 2 x tp 2 bf16
    three steps (the loss falls, router gradients finite and nonzero);
    (d) (a)'s bf16 state saved at step 2 and restored with ``sharding=``
    (bits, specs and mesh kept; step 3 equal to the straight run's
    wherever two straight runs agree bit for bit, within their spread
    elsewhere) and with ``device=`` (the gathered shards' bits).
41. the datasources on the card (after phase 38): the example app at its
    defaults with ``PUBSUB_BACKEND=KAFKA``, sqlite on a file and Redis
    over RESP2, against ``scripts/wire_brokers.py``'s in-process Kafka
    log, MQTT broker and RESP server. Two migrations (one SQL, one Redis)
    before ``start()``, applied once; ``/.well-known/health`` reports
    ``sql``, ``redis``, ``pubsub`` and ``tpu`` UP; another service's
    Kafka client publishes 16 jobs (64-256 prompt tokens, 64 new, greedy)
    while phase 37's burst comes over HTTP, so the lane's gate pauses the
    Kafka consumer; every job's tokens, read back over Kafka, equal
    ``engine.generate`` of its prompt; a malformed job is dead-lettered;
    the group's committed offset is 17 and a lane restarted in the group
    consumes nothing; the flash and D 64 ragged kernels launched in the
    window. Then a lane over the MQTT client runs 8 jobs on the same
    engine with the same gate and no new graph. Printed: the lane's tok/s
    over Kafka and MQTT beside phase 35a's in memory, wire bytes a job,
    the app's start seconds and the phase's seconds.
42. the examples on the card at their own defaults (after phase 41),
    one app at a time on ports 0, each closed (its websockets too)
    before the next: ``http_server`` (ResNet-50 at 224 x 224, buckets
    1/4/16/32) answers its routes as JAX's example does and 64
    ``/classify`` requests at 16 in flight, each label the eager forward's
    wherever that forward's top-two margin exceeds 2e-2 of its largest
    |logit| and each score within that, in turns against the app's own
    batcher (direct, HTTP, HTTP, direct); ``grpc_server`` (BERT-base at
    64 tokens) serves 32 embeddings over gRPC at 8 in flight, each within
    2e-2 (cosine 0.999) of the eager forward; ``using_subscriber``
    (ResNet-50, buckets 8/32/64) labels 32 images published over
    ``scripts/wire_brokers.py``'s Kafka and leaves the group's offset at
    32; the ``cmd`` example in processes of its own (``classify`` on the
    card exits 0 with its label, ``hello -name=H100`` greets, ``nosuch``
    exits 2); ``websocket_chat`` greets two clients, broadcasts, answers
    ping, closes with 1000 and with 1002 on an unmasked frame; and the
    framework examples (CRUD and migrations on sqlite files, a zip upload
    and a declared bomb, Redis over RESP2, the publisher over Kafka, the
    outbound service up and degraded, the custom series, both cron jobs,
    the OpenAPI routes) answer as JAX's. Printed: ``/classify``
    requests/s and p50 / p99 over HTTP against the batcher, the gRPC embed
    p50, the websocket round trip p50, each model example's capture and
    start seconds and the phase's seconds (at most 90).

Depth is cut, width never: the ``llama3-8b`` engines run 8 of 32
layers (``--layers``), and every ``small`` phase but the app's (20-23,
24's ``small`` half, 26-31, 32d, 33e, 35, 39c, 39f) 2 of its 8
(``CUT_SMALL_LAYERS``); phases 37, 38 and 41 run the example app at
its defaults, ``small`` whole.

Every engine burst (phases 9-12, 15-18, 20-23, 30a) is served twice:
counted, then under ``torch.profiler`` for the device's idle share. Every
engine's ``warmup()`` takes every prompt count (1 .. max_slots), so a
burst's full prefills are all replays.

Run from the root of a checkout: ``python3 chip_smoke.py``. Details go to
``chiprun_out/chip_smoke.json``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
FLASH_TOL = 3e-2                 # bf16: see phase 3
# ragged kernel (phases 4, 5), which keeps the plain version's bf16
# roundings: each element within 1.6e-2 (one ulp at |x| <= 2), and each
# output row (every head of one query of one slot) within relative L2
# 2^-8. A flipped rounding of a score or a partial sum is sparse (rows
# measured <= 1.3e-3 on an H100); a walk that drops even one position
# moves a row by >= 1.1e-2 at fills up to 2047.
RAGGED_TOL = 1.6e-2
RAGGED_ROW_TOL = 2.0 ** -8
# flash decode (phase 6) rounds once, at the output, after float32 sums in
# another order: at most one flipped rounding, one bf16 ulp of each
# element (of max(|x|, 2^-8)); one dropped position costs >= 90 ulps
FLASH_DECODE_ULPS = 1.0
MODEL_REL_TOL = 5e-2             # relative L2 logits error, see phase 7
MIN_PERFECT_ACCEPT = 0.5         # a broken verify accepts near 0, phase 8
SPEC_GAMMA, DRAFT_LAYERS = 4, 4
# int8 / bf16 pool bytes for one page (phase 11): (128 + 4) / 256 per
# K or V row and head
INT8_POOL_RATIO = 2_162_688 / 4_194_304
# the same at head_dim 64 (phase 22): (64 + 4) / 128
INT8_RATIO_D64 = 0.53125


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The attention shapes a kernel case runs at: heads, head dim, the
    paged table's width (columns of 32 positions), the dense cache's
    positions and the fills its cases take."""
    q_heads: int
    kv_heads: int
    head_dim: int
    width: int
    dense_t: int
    dense_fills: tuple


# llama3-8b (phases 3-6, 13, 14) and the example app's default preset,
# `small` (phase 19: dim 1024, 16/16 heads, max_len 1024)
LLAMA3 = Geometry(32, 8, 128, 64, 2048, (0, 1, 31, 127, 128, 700, 1500, 2047))
SMALL = Geometry(16, 16, 64, 32, 1024, (0, 1, 31, 127, 128, 500, 900, 1023))


T0 = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's log, after its seconds since the start."""
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each launch
    (a decode layer or a prefill finds its operands cold in the 50 MB L2).
    A spin of about 0.5 ms queued after the flush keeps the card busy while
    the host enqueues the timed call, so the host's launch latency (tens of
    microseconds of Python, more on a loaded host) is not counted as the
    call's time."""

    PAD_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.scratch = torch.empty(256 << 20, dtype=torch.uint8,
                                   device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.scratch.zero_()
            torch.cuda._sleep(self.PAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def flash_case(torch, flash_mod, timer, gen, batch, seq, geom=LLAMA3):
    """One causal bf16 flash launch at ``geom``'s heads: held to its plain
    version, timed beside it and ``scaled_dot_product_attention``, with
    its bound and TFLOP/s. Returns the row."""
    import torch.nn.functional as F

    hq, hkv, d = geom.q_heads, geom.kv_heads, geom.head_dim
    q = torch.randn((batch, seq, hq, d), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((batch, seq, hkv, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    out = flash_mod.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_mod.flash_attention_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out).all() or err > FLASH_TOL:
        raise AssertionError(
            f"flash D={d} B={batch} S={seq}: max|kernel-plain| {err} > "
            f"{FLASH_TOL}")
    ms = timer(lambda: flash_mod.flash_attention(q, k, v))
    plain_ms = timer(lambda: flash_mod.flash_attention_plain(q, k, v),
                     iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    flops = 2.0 * batch * hq * seq * seq * d
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
    row = dict(B=batch, S=seq, head_dim=d, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               sdpa_ratio=ms / lib_ms, bound_ms=bound * 1e3,
               bound_by=("operations" if flops / BF16_FLOP_PER_S
                         >= nbytes / HBM_BYTES_PER_S else "bytes"),
               tflops=flops / (ms * 1e-3) / 1e12,
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    log(f"flash D={d} B={batch} S={seq:5d} err={err:.3e} "
        f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
        f"sdpa={lib_ms:.4f}ms ({row['sdpa_ratio']:.3f}x sdpa) "
        f"bound={row['bound_ms']:.4f}ms ({row['bound_by']}; "
        f"{row['tflops']:.1f} TFLOP/s, {row['gb_per_s']:.1f} GB/s)")
    return row


def d64_waves(ragged_mod):
    """The head_dim-64 body's launch at ``small``'s shapes (B 8, Hkv 16,
    group 1) over tables of 4-32 pages of 32 (the dense engine's rungs
    128-1024, and the paged table), decode and verify G 5: its blocks
    a (KV head, slot), the grid's blocks, the blocks the card keeps
    resident (``cluster_occupancy`` times the cluster size) and the
    waves that makes. Returns the rows."""
    rows = []
    batch, hkv = 8, SMALL.kv_heads
    for width in (4, 8, 16, 32):
        for g_len in (1, SPEC_GAMMA + 1):
            ranks = ragged_mod.cluster_size(1, g_len, width, 32, 64)
            if ranks != ragged_mod.d64_ranks(width, 32):
                raise AssertionError(
                    f"the kernel's cluster size {ranks} at {width} pages "
                    f"is not d64_ranks' {ragged_mod.d64_ranks(width, 32)}")
            resident = ranks * ragged_mod.cluster_occupancy(
                1, g_len > 1, False, g_len, width, 32, 64)
            grid = batch * hkv * ranks
            rows.append(dict(table_width=width, G=g_len, ranks=ranks,
                             grid_blocks=grid, resident_blocks=resident,
                             waves=grid / resident))
            log(f"ragged D=64 launch, {width} pages of 32, G={g_len}: "
                f"{ranks} blocks a (KV head, slot), grid {grid} blocks, "
                f"{resident} resident: {grid / resident:.2f} waves")
    return rows


def phase_flash(torch, flash_mod, timer, results):
    log("== phase 3: flash_attention kernel vs plain (bf16, causal)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [flash_case(torch, flash_mod, timer, gen, batch, seq)
            for batch in (1, 4) for seq in (32, 128, 512, 2048)]
    results["flash"] = rows
    return max(row["max_abs_err"] for row in rows)


def paged_scenario(torch, fills, g_len, seed, geom=LLAMA3):
    """bf16 pools at ``geom``'s heads and head dim, page 32, its table
    width, pages of the slots scattered over the pool, every position no
    live entry references NaN; q (B,G,Hq,D) and k/v_new (B,G,Hkv,D)."""
    import numpy as np

    batch, page, width = len(fills), 32, geom.width
    num_pages = batch * width
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_pages)          # pages scattered in the pool
    table = np.full((batch, width), num_pages, np.int32)
    live = np.zeros((num_pages, page), bool)
    nxt = 0
    for row, n in enumerate(fills):
        for col in range(-(-n // page)):
            pid = int(order[nxt])
            nxt += 1
            table[row, col] = pid
            live[pid, :min(page, n - col * page)] = True
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (num_pages, page, geom.kv_heads, geom.head_dim)
    poison = torch.from_numpy(~live).cuda()[..., None, None]
    k_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    v_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    q = torch.randn((batch, g_len, geom.q_heads, geom.head_dim),
                    generator=gen, device="cuda").bfloat16()
    k_new, v_new = (torch.randn((batch, g_len, geom.kv_heads, geom.head_dim),
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    return (q, k_pages, v_pages, torch.from_numpy(table).cuda(), k_new,
            v_new, torch.tensor(fills, dtype=torch.int32, device="cuda"))


def paged_scenario_int8(torch, fills, g_len, seed, geom=LLAMA3):
    """:func:`paged_scenario`'s layout with int8 pools: its rows
    quantised (``quantize_kv``) and every scale of a position no live
    entry references NaN (the int8 rows there are 0). Returns the
    wrapper's arguments, the two scale planes last."""
    from gofr_tpu_torch.ops.quant import quantize_kv

    q, k_pages, v_pages, table, k_new, v_new, lens = paged_scenario(
        torch, fills, g_len, seed, geom)
    dead = k_pages[..., 0, 0].isnan()[..., None]        # (N, page, 1)
    (k8, ks), (v8, vs) = (quantize_kv(pages.nan_to_num())
                          for pages in (k_pages, v_pages))
    return (q, k8, v8, table, k_new, v_new, lens,
            ks.masked_fill(dead, float("nan")),
            vs.masked_fill(dead, float("nan")))


def paged_cost(fills, g_len, table_size, int8=False, geom=LLAMA3):
    """Bytes (each input read once, the output written once) and FLOPs of
    one ragged launch over these fills, G queries per slot; int8 pools
    read one byte an element plus a float32 scale per row and head."""
    d, hkv = geom.head_dim, geom.kv_heads
    batch, row = len(fills), geom.q_heads * d
    row_bytes = d + 4 if int8 else d * 2
    kv_bytes = 2 * sum(fills) * hkv * row_bytes
    small_bytes = 2 * (2 * batch * g_len * row
                       + 2 * batch * g_len * hkv * d) \
        + 4 * (table_size + batch)
    # query g attends the fill plus the new tokens u <= g
    pairs = sum(n + g + 1 for n in fills for g in range(g_len))
    return kv_bytes + small_bytes, 4.0 * pairs * row


def check_ragged(torch, out, ref, what):
    """Hold a ragged kernel output to its plain version (RAGGED_TOL per
    element, RAGGED_ROW_TOL per row). Returns both errors."""
    from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2

    err = (out.float() - ref.float()).abs().max().item()
    row_err = row_rel_l2(out, ref)
    if not torch.isfinite(ref).all() or not err <= RAGGED_TOL \
            or not row_err <= RAGGED_ROW_TOL:
        raise AssertionError(f"{what}: max|kernel-plain| {err} (bound "
                             f"{RAGGED_TOL}), row relative L2 {row_err} "
                             f"(bound {RAGGED_ROW_TOL})")
    return err, row_err


def _scenario(torch, int8, fills, g_len, seed, geom=LLAMA3):
    """The wrapper's arguments over bf16 or int8 pools."""
    if int8:
        return paged_scenario_int8(torch, fills, g_len, seed, geom)
    return paged_scenario(torch, fills, g_len, seed, geom)


def ragged_call(torch, ragged_mod, int8, fills, g_len, seed, geom=LLAMA3):
    """The wrapper's arguments over these fills, and the kernel and plain
    entry points that take them: decode at G = 1, verify above."""
    call = list(_scenario(torch, int8, fills, g_len, seed, geom))
    if g_len == 1:
        call[4], call[5] = call[4][:, 0], call[5][:, 0]
        return (call, ragged_mod.ragged_paged_decode_attention,
                ragged_mod.ragged_paged_decode_attention_plain)
    return (call, ragged_mod.ragged_paged_verify_attention,
            ragged_mod.ragged_paged_verify_attention_plain)


def ragged_case(torch, ragged_mod, timer, int8, fills, g_len, seed, what,
                geom=LLAMA3):
    """One ragged launch over these fills: held to its plain version,
    output finite despite the NaN planted wherever no live entry points,
    timed beside the plain version, with its bound and GB/s. Returns the
    row."""
    call, kernel, plain = ragged_call(torch, ragged_mod, int8, fills, g_len,
                                      seed, geom)
    out = kernel(*call)
    torch.cuda.synchronize()
    ref = plain(*call)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite: it read a "
                             "poisoned page")
    err, row_err = check_ragged(torch, out, ref, what)
    ms = timer(lambda: kernel(*call), iters=20)
    plain_ms = timer(lambda: plain(*call), iters=5)
    nbytes, flops = paged_cost(fills, g_len, call[3].numel(), int8, geom)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(G=g_len, B=len(fills), fills=fills, page=32,
               table_width=geom.width, head_dim=geom.head_dim,
               pools="int8" if int8 else "bf16", max_abs_err=err,
               row_rel_l2=row_err, ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound * 1e3,
               bound_by=("operations" if flops / BF16_FLOP_PER_S
                         >= nbytes / HBM_BYTES_PER_S else "bytes"),
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    log(f"{what} err={err:.3e} row={row_err:.3e} kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms bound={row['bound_ms']:.4f}ms "
        f"({row['gb_per_s']:.1f} GB/s) library=none")
    return row


# every slot at the engine's longest fill (decode; verify G 5 keeps room
# for its new tokens): the cluster's 8 blocks all busy on every slot
FULL_CARD_FILL = 2047


def phase_ragged(torch, ragged_mod, timer, results, int8=False):
    what = "ragged int8" if int8 else "ragged"
    log(f"== phase 4: ragged_paged_decode_attention kernel vs plain "
        f"({'int8 pools' if int8 else 'bf16'})")
    row = ragged_case(torch, ragged_mod, timer, int8,
                      [0, 1, 31, 32, 33, 700, 2047, 512], 1, 2,
                      f"{what} B=8")
    full = ragged_case(torch, ragged_mod, timer, int8,
                       [FULL_CARD_FILL] * 8, 1, 3, f"{what} full card B=8")
    results["ragged_int8" if int8 else "ragged"] = dict(row,
                                                        full_card=full)
    return row


def phase_verify(torch, ragged_mod, timer, results, int8=False):
    what = "verify int8" if int8 else "verify"
    log(f"== phase 5: ragged_paged_verify_attention kernel vs plain "
        f"({'int8 pools' if int8 else 'bf16'})")
    rows = [ragged_case(torch, ragged_mod, timer, int8,
                        [0, 1, 31, 32, 33, 700, 2047 - g_len, 512], g_len,
                        10 + g_len, f"{what} G={g_len}")
            for g_len in (2, 3, 5)]
    g_full = SPEC_GAMMA + 1
    full = ragged_case(torch, ragged_mod, timer, int8,
                       [FULL_CARD_FILL - g_full] * 8, g_full, 20,
                       f"{what} full card G={g_full}")
    g1_bit_check(torch, ragged_mod, int8, [0, 1, 31, 32, 33, 700, 2047, 512],
                 what)
    results["verify_int8" if int8 else "verify"] = dict(
        rows=rows, full_card=full, g1_bit_identical=True)
    return rows


def g1_bit_check(torch, ragged_mod, int8, fills, what, geom=LLAMA3):
    """At G = 1 the verify instantiation (new-token bound MAX_NEW, the
    causal fold's loops) must give the decode instantiation's bits."""
    q, k_pages, v_pages, table, k_new, v_new, lens, *scales = _scenario(
        torch, int8, fills, 1, 2, geom)
    verify = ragged_mod.ragged_paged_verify_form_attention(
        q, k_pages, v_pages, table, k_new, v_new, lens, *scales)
    decode = ragged_mod.ragged_paged_decode_attention(
        q, k_pages, v_pages, table, k_new[:, 0].contiguous(),
        v_new[:, 0].contiguous(), lens, *scales)
    torch.cuda.synchronize()
    if not torch.equal(verify.view(torch.int16), decode.view(torch.int16)):
        raise AssertionError(f"{what}: the verify instantiation at G=1 is "
                             "not bit-identical to the decode "
                             "instantiation")
    log(f"{what}: verify instantiation at G=1 is bit-identical to the "
        f"decode instantiation")


def flash_decode_case(torch, decode_mod, timer, fills, t_max, seed,
                      geom=LLAMA3, window=None, sdpa=True):
    """One flash-decode launch over a (B, t_max) bf16 cache at ``geom``'s
    heads, every row past a fill NaN, or with ``window`` over the cache's
    first ``window`` positions (the full cache's slot stride): held to
    its plain version within FLASH_DECODE_ULPS, timed, with its bound and
    GB/s; with ``sdpa`` timed beside ``scaled_dot_product_attention``
    with a per-row mask (a yardstick only). Returns the row."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.cuda.tolerance import ulp_error

    hq, hkv, d = geom.q_heads, geom.kv_heads, geom.head_dim
    batch = len(fills)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, t_max, hkv, d)
    lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
    reach = torch.clamp(lens, max=window or t_max)
    dead = (torch.arange(t_max, device="cuda")[None, :]
            >= reach[:, None])[..., None, None]
    k_cache, v_cache = (torch.randn(shape, generator=gen, device="cuda")
                        .bfloat16().masked_fill(dead, float("nan"))
                        for _ in range(2))
    q = torch.randn((batch, 1, hq, d), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((batch, hkv, d), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
    w = window or t_max
    args = (q, k_cache[:, :w], v_cache[:, :w], k_new, v_new, lens)
    out = decode_mod.flash_decode_attention(*args)
    torch.cuda.synchronize()
    ref = decode_mod.flash_decode_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    ulps = ulp_error(out, ref)
    what = f"flash decode D={d} T={t_max}" + (f" window {window}"
                                               if window else "")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite: it read a row "
                             "past the fill")
    if not torch.isfinite(ref).all() or not ulps <= FLASH_DECODE_ULPS:
        raise AssertionError(f"{what}: kernel-plain {ulps} bf16 ulps > "
                             f"{FLASH_DECODE_ULPS} (max abs {err})")
    ms = timer(lambda: decode_mod.flash_decode_attention(*args), iters=20)
    plain_ms = timer(lambda: decode_mod.flash_decode_attention_plain(*args),
                     iters=3)
    lib_ms = lib_err = None
    if sdpa:
        # the cache plus the new token, GQA, a per-row mask (inputs laid
        # out for it outside the timing)
        k_all = torch.cat([k_cache.nan_to_num(), k_new[:, None]], 1) \
            .transpose(1, 2).contiguous()
        v_all = torch.cat([v_cache.nan_to_num(), v_new[:, None]], 1) \
            .transpose(1, 2).contiguous()
        q_t = q.transpose(1, 2).contiguous()
        pos = torch.arange(t_max + 1, device="cuda")[None, :]
        mask = ((pos < lens[:, None]) | (pos == t_max))[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(
            q_t, k_all, v_all, attn_mask=mask, enable_gqa=True)
        lib_err = (lib_out.transpose(1, 2).float()
                   - ref.float()).abs().max().item()
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q_t, k_all, v_all, attn_mask=mask, enable_gqa=True), iters=20)
    live = int(reach.sum())
    nbytes = 2 * live * hkv * d * 2 \
        + 2 * (2 * q.numel() + k_new.numel() + v_new.numel()) + 4 * batch
    flops = 4.0 * (live + batch) * hq * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(B=batch, T=t_max, head_dim=d, window=window,
               fills=reach.tolist(), max_abs_err=err, max_ulps=ulps, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               sdpa_ratio=ms / lib_ms if lib_ms else None,
               library_max_abs_err=lib_err, bound_ms=bound * 1e3,
               bound_by="bytes", gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    log(f"{what} err={err:.3e} ({ulps} ulps) kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms "
        + (f"sdpa={lib_ms:.4f}ms ({row['sdpa_ratio']:.3f}x sdpa; sdpa vs "
           f"plain {lib_err:.3e}) " if sdpa else "")
        + f"bound={row['bound_ms']:.4f}ms (bytes; "
        f"{row['gb_per_s']:.1f} GB/s)")
    return row


def phase_flash_decode(torch, decode_mod, timer, results):
    log("== phase 6: flash_decode_attention kernel vs plain (bf16)")
    row = flash_decode_case(torch, decode_mod, timer,
                            [0, 1, 127, 128, 129, 700, 1500, 2047], 2048, 4)
    results["flash_decode"] = row
    return row


def dense_scenario(torch, llama, int8, rung, g_len, seed, geom=LLAMA3):
    """The ragged wrappers' arguments over a dense cache (8 slots,
    ``geom``'s positions and heads) viewed as pages of 32 in slot order
    and the identity table of ``rung``: ``geom``'s dense fills cut to the
    rung with room for G new tokens, the last row (the cache's last
    position) an inactive one past the rung; every position past a row's
    reach (its fill, within the rung) NaN, in the int8 scale planes too.
    Returns (args, the fills the kernel reads)."""
    from gofr_tpu_torch.ops.quant import quantize_kv

    dense_fills, t_max = geom.dense_fills, geom.dense_t
    b, page, top = len(dense_fills), 32, rung or t_max
    fills = [min(n, top - g_len) for n in dense_fills[:-1]] \
        + [dense_fills[-1]]
    reach = [min(n, top) for n in fills]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, t_max, geom.kv_heads, geom.head_dim)
    k, v = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    q = torch.randn((b, g_len, geom.q_heads, geom.head_dim), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((b, g_len, geom.kv_heads, geom.head_dim),
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    dead = (torch.arange(t_max, device="cuda")[None, :]
            >= torch.tensor(reach, device="cuda")[:, None])
    if int8:
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        pools = [k8, v8, ks.masked_fill(dead[..., None], float("nan")),
                 vs.masked_fill(dead[..., None], float("nan"))]
    else:
        pools = [x.bfloat16().masked_fill(dead[..., None, None], float("nan"))
                 for x in (k, v)]
    pools = [x.view(-1, page, *x.shape[2:]) for x in pools]
    table = llama.identity_table(b, t_max, rung, device="cuda")
    lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
    if g_len == 1:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    return [q, pools[0], pools[1], table, k_new, v_new, lens] + pools[2:], \
        reach


def identity_cases(torch, ragged_mod, timer, geom):
    """The ragged kernel over identity tables of a dense cache at
    ``geom``: every window rung, decode and verify G 5, bf16 then int8,
    held to phases 4-5's gates and timed. Returns the rows."""
    from gofr_tpu_torch.models import llama

    rows = []
    t_max = geom.dense_t
    rungs = [w for w in (128, 256, 512, 1024) if w < t_max] + [None]
    for int8 in (False, True):
        for g_len in (1, SPEC_GAMMA + 1):
            kernel, plain = (
                (ragged_mod.ragged_paged_decode_attention,
                 ragged_mod.ragged_paged_decode_attention_plain)
                if g_len == 1 else
                (ragged_mod.ragged_paged_verify_attention,
                 ragged_mod.ragged_paged_verify_attention_plain))
            for rung in rungs:
                what = (f"identity D={geom.head_dim} "
                        f"{'int8' if int8 else 'bf16'} "
                        f"{'decode' if g_len == 1 else f'verify G={g_len}'} "
                        f"rung {rung or t_max}")
                args, reach = dense_scenario(torch, llama, int8, rung, g_len,
                                             30 + g_len, geom)
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{what}: output is not finite: it "
                                         f"read past a row's reach")
                err, row_err = check_ragged(torch, out, ref, what)
                ms = timer(lambda: kernel(*args), iters=20)
                plain_ms = timer(lambda: plain(*args), iters=3)
                lib_ms = lib_diff = None
                if not int8:
                    lib_ms, lib_diff = identity_sdpa_ms(
                        torch, timer, args, reach, geom, rung,
                        out.float())
                nbytes, flops = paged_cost(reach, g_len, args[3].numel(),
                                           int8, geom)
                bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
                row = dict(rung=rung or t_max, G=g_len, fills=reach,
                           head_dim=geom.head_dim,
                           pools="int8" if int8 else "bf16",
                           max_abs_err=err, row_rel_l2=row_err, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           library_max_abs_diff=lib_diff,
                           sdpa_ratio=ms / lib_ms if lib_ms else None,
                           bound_ms=bound * 1e3,
                           bound_by=("operations" if flops / BF16_FLOP_PER_S
                                     >= nbytes / HBM_BYTES_PER_S
                                     else "bytes"),
                           gb_per_s=nbytes / (ms * 1e-3) / 1e9)
                rows.append(row)
                log(f"{what} err={err:.3e} row={row_err:.3e} "
                    f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                    + (f"sdpa={lib_ms:.4f}ms ({ms / lib_ms:.3f}x sdpa; "
                       f"|sdpa-kernel| {lib_diff:.3e}) " if lib_ms else "")
                    + f"bound={row['bound_ms']:.4f}ms "
                    f"({row['gb_per_s']:.1f} GB/s)")
    return rows


def identity_sdpa_ms(torch, timer, args, reach, geom, rung, kernel_out):
    """One ``scaled_dot_product_attention`` call computing what the ragged
    kernel computes over an identity table (a yardstick only): the dense
    cache's first ``rung`` positions plus the G new tokens, a mask of
    each row's length over the cache and causal among the new tokens
    (decode: G 1), GQA; inputs laid out for it outside the timing.
    Returns its time and its largest difference from ``kernel_out``."""
    import torch.nn.functional as F

    q, k_pages, v_pages, _, k_new, v_new, _ = args[:7]
    if k_new.dim() == 3:                       # decode: one new token
        k_new, v_new = k_new[:, None], v_new[:, None]
    b, g, t_max = len(reach), k_new.shape[1], geom.dense_t
    w = rung or t_max
    k, v = (x.view(b, t_max, geom.kv_heads, geom.head_dim)[:, :w]
            for x in (k_pages, v_pages))
    k_all, v_all = (torch.cat([x.nan_to_num(), new], 1)
                    .transpose(1, 2).contiguous()
                    for x, new in ((k, k_new), (v, v_new)))
    q_t = q.view(b, g, geom.q_heads, geom.head_dim).transpose(1, 2) \
        .contiguous()
    pos = torch.arange(w, device="cuda")[None, :]
    lens = torch.tensor(reach, device="cuda")
    cache = (pos < lens[:, None])[:, None, None, :].expand(b, 1, g, w)
    causal = torch.ones((g, g), dtype=torch.bool, device="cuda").tril()
    mask = torch.cat([cache, causal.expand(b, 1, g, g)], -1)

    def call():
        return F.scaled_dot_product_attention(q_t, k_all, v_all,
                                              attn_mask=mask,
                                              enable_gqa=True)
    diff = (call().transpose(1, 2).float()
            - kernel_out.view(b, g, geom.q_heads, geom.head_dim)).abs().max()
    return timer(call, iters=20), float(diff)


def phase_identity_ragged(torch, ragged_mod, timer, results):
    log("== phase 13: ragged kernel over identity tables of a dense cache "
        "(8 slots, T 2048, page 32), every window rung, decode and verify "
        "G 5, bf16 then int8")
    results["identity_ragged"] = identity_cases(torch, ragged_mod, timer,
                                                LLAMA3)


def phase_window_flash_decode(torch, decode_mod, timer, results):
    log("== phase 14: flash_decode_attention kernel over window views of a "
        "T 2048 cache vs plain")
    fills = LLAMA3.dense_fills
    results["window_flash_decode"] = [
        flash_decode_case(torch, decode_mod, timer,
                          [min(n, rung - 1) for n in fills[:-1]]
                          + [fills[-1]], LLAMA3.dense_t, 14, window=rung,
                          sdpa=False)
        for rung in (128, 256, 512, 1024)]


def phase_model(torch, llama, seed, results):
    import numpy as np

    from gofr_tpu_torch.tpu.page_pool import PagePool

    log("== phase 7: 2-layer llama3-8b width, kernels (card, bf16) vs "
        "plain (CPU, f32), bf16 pool then kv_int8")
    cfg = llama.config("llama3-8b", n_layers=2, use_flash=True)
    params = llama.init(cfg, seed, device="cuda")
    ref_cfg = llama.config("llama3-8b", n_layers=2, dtype=torch.float32)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {key: to_cpu(val) for key, val in tree.items()}
        return tree.float().cpu()

    ref_params = to_cpu(params)
    rng = np.random.default_rng(seed)
    lengths = np.array([19, 32], np.int64)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32))
    page, num_pages, width, steps = 32, 8, 4, 4
    table = np.full((2, width), num_pages, np.int32)
    table[0, 0] = 5
    table[1, :2] = [2, 6]

    def run(c, p, dev, feed):
        """Prefill, place the prompt KV in pool pages, then ``steps``
        paged decode steps. ``feed`` holds each step's (2,) tokens; when
        empty, this run's own greedy tokens are appended to it."""
        record = not feed
        small = llama.init_cache(c, 2, 32, device=dev)
        logits, small, cache_len = llama.prefill(
            p, c, torch.as_tensor(tokens, device=dev), small,
            lengths=torch.as_tensor(lengths, device=dev))
        pool = PagePool(c, page=page, num_pages=num_pages,
                        device=dev).leaves
        for name in pool:
            pool[name][:, 5] = small[name][:, 0]
            pool[name][:, 2] = small[name][:, 1]
        table_t = torch.as_tensor(table, device=dev)
        active = torch.ones(2, dtype=torch.bool, device=dev)
        out = [logits.float().cpu()]
        for step in range(steps):
            if record:
                feed.append(logits.argmax(-1).cpu())
            logits, pool, cache_len = llama.decode_step_paged(
                p, c, feed[step].to(dev), pool, table_t, cache_len, active)
            out.append(logits.float().cpu())
        return out

    for int8 in (False, True):
        c, rc = (dataclasses.replace(x, kv_int8=int8)
                 for x in (cfg, ref_cfg))
        # the CPU reference picks the greedy tokens; the card is fed the
        # same
        feed = []
        ref_out = run(rc, ref_params, "cpu", feed)
        card_out = run(c, params, "cuda", feed)
        rel, agree, total = [], 0, 0
        for ref, got in zip(ref_out, card_out):
            if not torch.isfinite(got).all():
                raise AssertionError("model check: non-finite card logits")
            rel.append(((got - ref).norm() / ref.norm()).item())
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            total += ref.shape[0]
        worst = max(rel)
        what = "model kv_int8" if int8 else "model"
        log(f"{what}: relative L2 logits error per step "
            f"{[round(r, 5) for r in rel]} (bound {MODEL_REL_TOL}); "
            f"top-1 agreement {agree}/{total}")
        results["model_check_int8" if int8 else "model_check"] = dict(
            rel_l2=rel, top1_agree=agree, top1_total=total,
            bound=MODEL_REL_TOL)
        if worst > MODEL_REL_TOL:
            raise AssertionError(f"{what} check: relative error {worst} > "
                                 f"{MODEL_REL_TOL}")
    del params, ref_params
    torch.cuda.empty_cache()


def device_times(torch, prof):
    """Device seconds and counts by name of every device event (kernels,
    copies, fills) of a profiled run, from the raw trace events (the
    aggregated ``key_averages()`` takes tens of seconds over the ~10^5
    events of an eager burst)."""
    by_kernel, calls = {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == cuda and evt.duration_ns() > 0:
            name = evt.name()
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + evt.duration_ns() / 1e9
            calls[name] = calls.get(name, 0) + 1
    return by_kernel, calls


# the kernels each served path must launch at least once
PATH_KERNELS = {"engine": ("flash", "ragged"),
                "spec": ("flash", "verify", "flash_decode"),
                "perfect_draft": ("flash", "verify", "flash_decode"),
                "int8_engine": ("flash", "int8"),
                "int8_spec": ("flash", "int8_verify", "flash_decode"),
                "int8_perfect_draft": ("flash", "int8_verify",
                                       "flash_decode"),
                "dense": ("flash", "ragged"),
                "dense_spec": ("flash", "verify", "flash_decode"),
                "dense_int8": ("flash", "int8"),
                "dense_int8_spec": ("flash", "int8_verify", "flash_decode"),
                "small": ("flash", "ragged"),
                "small_paged": ("flash", "ragged"),
                "small_int8": ("flash", "int8"),
                "small_spec": ("flash", "verify", "flash_decode"),
                "small_int8_spec": ("flash", "int8_verify", "flash_decode"),
                "prefix_small": ("flash", "ragged"),
                "prefix_small_paged": ("flash", "ragged"),
                "prefix_small_int8": ("flash", "int8"),
                "prefix_llama3": ("flash", "ragged"),
                "planes_small": ("flash", "ragged"),
                "op_small": ("flash", "ragged"),
                "op_llama3": ("flash", "ragged"),
                "train_eval_small": ("flash",),
                "app_small": ("flash", "ragged"),
                "disagg_app": ("flash", "ragged"),
                "mesh_tp1_dense": ("flash", "ragged"),
                "mesh_tp1_paged": ("flash", "ragged"),
                "mesh_tp2_dense": ("flash", "ragged"),
                "mesh_tp2_paged": ("flash", "ragged"),
                "mesh_tp2_paged_int8": ("flash", "int8"),
                "mesh_small_tp2": ("flash", "ragged"),
                "mesh_small_dp2": ("flash", "ragged"),
                "train_eval_mesh_llama3": ("flash",)}


def warm(engine):
    """``engine.warmup()`` at every prompt count (the example app warms
    counts 1 and max_slots): every full prefill a burst can group is
    captured before it."""
    counts = tuple(range(1, engine.max_slots + 1))
    return engine.warmup(prompt_counts=counts)


def probe_warmup_memory(torch, engine, into):
    """Record the allocator's reserved bytes (its cache emptied first:
    what stays reserved is tensors and the captured graphs' private
    pool) before and after the tick captures and the prefill captures of
    ``engine``'s next ``warmup()``, into ``into``."""
    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_stats()["reserved_bytes.all.current"]

    def probed(name):
        call = getattr(engine, name)

        def run(keys):
            into[name + "_before"] = reserved()
            call(keys)
            into[name + "_after"] = reserved()
        setattr(engine, name, run)
    probed("_warm")
    probed("_warm_prefills")


def eager_prefill(engine):
    """From now on run ``engine``'s prefills eagerly, as the tree before
    the compiled prefill did: the host part's two uploads into the rung's
    buffers, then its body, with no graph."""
    from gofr_tpu_torch.tpu.generate import _prefill_key

    def run(nb, bucket, n_claimed, p_rung, ints, layout, floats,
            biased=False, epoch=None):
        rung = engine._prefill_rung(
            _prefill_key(nb, bucket, p_rung, biased, layout), layout,
            floats.size)
        engine._upload_prefill(rung, ints, floats)
        return engine._staging.fetch(engine._prefill_body(rung))
    engine._prefill_insert = run


def time_prefills(engine, calls):
    """Append each prefill call's host seconds on the device thread (the
    call of ``_prefill_insert``: uploads, replay or eager body, the
    fetch queued), with its rows and bucket, to ``calls``."""
    call = engine._prefill_insert

    def timed(*args):
        t0 = time.perf_counter()
        fetch = call(*args)
        calls.append((args[0], args[1], time.perf_counter() - t0))
        return fetch
    engine._prefill_insert = timed


async def replay_against_eager(engine, prompts, budget, samplings, turns=2):
    """The burst with the engine's prefills as graph replays, then run
    eagerly, each ``turns`` times (the last measured): each prefill
    call's host seconds on the device thread, tok/s, TTFT p50 and max,
    and the outputs of each."""
    out = {}
    for mode in ("replay", "eager"):
        if mode == "eager":
            eager_prefill(engine)
        calls = []
        time_prefills(engine, calls)
        for _ in range(turns):
            calls.clear()
            engine.ttfts.clear()
            gc.collect()
            t0 = time.monotonic()
            outs = await asyncio.wait_for(asyncio.gather(*[
                engine.generate(p, budget, sampling=s)
                for p, s in zip(prompts, samplings)]), 600)
            wall = time.monotonic() - t0
        ttfts = sorted(engine.ttfts)
        out[mode] = dict(
            outs=outs, wall_s=wall,
            tokens_per_s=budget * len(prompts) / wall,
            ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
            prefill_calls=[dict(rows=nb, bucket=b, host_s=sec)
                           for nb, b, sec in calls],
            prefill_host_s=sum(sec for _, _, sec in calls))
    return out


def serve_burst(torch, engine, prompts, budget, samplings, mods, timeout,
                stream_tokens=8, profile=False, extra=None):
    """Capture the engine's ticks and its full prefills at every count
    (``warmup()``), warm it up with one request, set every kernel's count
    to 0, serve the burst concurrently and read the counts; with
    ``profile`` serve it again under ``torch.profiler`` for the device's
    idle share; then stream ``stream_tokens`` of ``prompts[3]`` alone, and
    run ``extra(engine)`` last if given. Fails unless every tick and
    every prefill of the burst was a graph replay and 2 ticks were in
    flight at some point. Returns (outputs, wall seconds, launches by
    kernel, the burst's run counters, sorted TTFTs, figures: graphs,
    prefill graphs, the allocator's bytes around the captures, idle
    share, the stream's ticks by window rung, what ``extra`` returned)."""
    from torch.profiler import ProfilerActivity

    # an earlier profiled burst leaves cyclic garbage that is slow to
    # collect: collect it now, not inside this engine's burst
    gc.collect()
    memory = {}
    probe_warmup_memory(torch, engine, memory)
    probe_export_memory(torch, engine, memory)

    async def serve():
        t0 = time.monotonic()
        await warm(engine)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        await engine.start()
        try:
            # warm-up (cuBLAS handles, allocator; a spec engine's spec
            # tick too): not part of the run
            await engine.generate(prompts[0], 8)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            rungs = dict(engine.spec_rungs)
            windows0 = dict(engine.window_ticks)
            engine.ttfts.clear()
            torch.cuda.reset_peak_memory_stats()
            inflight = []

            async def watch():
                while True:
                    inflight.append(engine.stats()["ticks_inflight"])
                    await asyncio.sleep(0.0005)

            watcher = asyncio.get_running_loop().create_task(watch())
            start = time.monotonic()
            try:
                outs = await asyncio.wait_for(asyncio.gather(*[
                    engine.generate(p, budget, sampling=s)
                    for p, s in zip(prompts, samplings)]), timeout)
            finally:
                watcher.cancel()
            wall = time.monotonic() - start
            launches = read_launches(mods)
            after = run_counters(engine)
            counters = {key: after[key] - before[key] for key in after}
            counters["ticks_by_gamma"] = {
                g: n - rungs.get(g, 0) for g, n in engine.spec_rungs.items()
                if n > rungs.get(g, 0)}
            counters["ticks_by_window"] = {
                w or engine.max_len: n - windows0.get(w, 0)
                for w, n in engine.window_ticks.items()
                if n > windows0.get(w, 0)}
            ttfts = sorted(engine.ttfts)
            idle = None
            if profile:
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                with prof:
                    t1 = time.monotonic()
                    await asyncio.wait_for(asyncio.gather(*[
                        engine.generate(p, budget, sampling=s)
                        for p, s in zip(prompts, samplings)]), timeout)
                    torch.cuda.synchronize()
                    prof_wall = time.monotonic() - t1
                by_kernel, calls = device_times(torch, prof)
                busy = sum(by_kernel.values())
                top = sorted(by_kernel, key=lambda k: -by_kernel[k])[:12]
                idle = dict(device_busy_s=busy, profiled_wall_s=prof_wall,
                            device_idle_share=1.0 - busy / prof_wall,
                            device_s_by_kernel={
                                name: [by_kernel[name], calls[name]]
                                for name in top})
            windows = dict(engine.window_ticks)
            stream = await engine.generate_stream(prompts[3], stream_tokens)
            streamed = [tok async for tok in stream]
            stream_windows = {w or engine.max_len: n - windows.get(w, 0)
                              for w, n in engine.window_ticks.items()
                              if n > windows.get(w, 0)}
            more = await extra(engine) if extra is not None else None
            return (outs, wall, launches, counters, ttfts, streamed,
                    max(inflight), warm_s, idle, stream_windows, more)
        finally:
            await engine.stop()

    (outs, wall, launches, counters, ttfts, streamed, peak,
     warm_s, idle, stream_windows, more) = asyncio.run(serve())
    for out in outs:
        if len(out) != budget or not all(0 <= t < engine.cfg.vocab_size
                                         for t in out):
            raise AssertionError(f"bad completion {out}")
    if len(streamed) != stream_tokens:
        raise AssertionError(f"stream returned {len(streamed)} tokens")
    ticks = counters["ticks"] + counters["spec_ticks"]
    if counters["replays"] != ticks or counters["lazy_captures"]:
        raise AssertionError(
            f"{counters['replays']} graph replays for {ticks} ticks, "
            f"{counters['lazy_captures']} captures in the burst: every "
            f"tick must replay a graph warmup() captured")
    if counters["prefill_replays"] != counters["prefills"] \
            or counters["prefill_lazy"]:
        raise AssertionError(
            f"{counters['prefill_replays']} prefill replays for "
            f"{counters['prefills']} prefills, {counters['prefill_lazy']} "
            f"prefill captures in the burst: every prefill must replay a "
            f"graph warmup() captured")
    want = min(2, engine.max_inflight_ticks)
    if peak < want:
        raise AssertionError(f"at most {peak} ticks were in flight during "
                             f"the burst, expected {want}")
    graphs = engine.stats()["graphs"]
    pgraphs = graphs["prefill"]
    tick_bytes = memory["_warm_after"] - memory["_warm_before"]
    prefill_bytes = (memory["_warm_prefills_after"]
                     - memory["_warm_prefills_before"])
    figures = dict(warmup_s=warm_s, graphs=graphs["captured"],
                   graphs_by_window=graphs["by_window"],
                   capture_s=graphs["capture_s"],
                   prefill_graphs=pgraphs["captured"],
                   prefill_graph_keys=pgraphs["keys"],
                   prefill_capture_s=pgraphs["capture_s"],
                   tick_capture_bytes=tick_bytes,
                   prefill_capture_bytes=prefill_bytes,
                   export_capture_bytes=memory.get("_warm_export"),
                   reserved_after_warmup=memory["_warm_prefills_after"],
                   ticks_inflight_peak=peak,
                   max_inflight_ticks=engine.max_inflight_ticks,
                   stream_ticks_by_window=stream_windows, **(idle or {}))
    if more is not None:
        figures["extra"] = more
    log(f"graphs: {graphs['captured']} ticks captured in "
        f"{graphs['capture_s']:.2f}s, {pgraphs['captured']} prefills in "
        f"{pgraphs['capture_s']:.2f}s (warmup {warm_s:.2f}s; ticks by "
        f"window {graphs['by_window']}); reserved bytes +{tick_bytes} by "
        f"the tick captures, +{prefill_bytes} by the prefill captures "
        f"({memory['_warm_prefills_after']} after warmup); "
        f"{counters['replays']} replays for {ticks} ticks (by window "
        f"{counters['ticks_by_window']}), {counters['prefill_replays']} "
        f"prefill replays for {counters['prefills']} prefills, "
        f"{peak} ticks in flight at most (max_inflight_ticks "
        f"{engine.max_inflight_ticks})"
        + (f"; device idle share {idle['device_idle_share']:.4f} "
           f"(busy {idle['device_busy_s']:.4f}s of "
           f"{idle['profiled_wall_s']:.4f}s profiled)" if idle else ""))
    return outs, wall, launches, counters, ttfts, figures


def read_launches(mods):
    """Every kernel's launch count, by kernel."""
    flash_mod, ragged_mod, decode_mod = mods
    return dict(flash=flash_mod.launches, ragged=ragged_mod.launches,
                verify=ragged_mod.verify_launches,
                int8=ragged_mod.int8_launches,
                int8_verify=ragged_mod.int8_verify_launches,
                flash_decode=decode_mod.launches)


def run_counters(engine):
    stats = engine.stats()
    spec = stats.get("speculative", {})
    return dict(prefills=engine.prefill_dispatches,
                suffix_prefills=engine.suffix_prefill_dispatches,
                steps=engine.decode_steps,
                ticks=engine.ticks,
                spec_ticks=engine.spec_dispatches,
                draft_steps=engine.draft_steps,
                replays=stats["graphs"]["replays"],
                lazy_captures=stats["graphs"]["lazy_captures"],
                prefill_replays=stats["graphs"]["prefill"]["replays"],
                prefill_lazy=stats["graphs"]["prefill"]["lazy_captures"],
                proposed=spec.get("proposed", 0),
                accepted=spec.get("accepted", 0))


def acceptance(counters):
    return counters["accepted"] / max(counters["proposed"], 1)


def expected_launches(cfg, counters, draft_layers=0, draft_int8=False):
    """What each kernel must have launched over a burst of this engine:
    the target's layers per prefill (a suffix prefill over cached pages
    too; a prefill rung captured in the burst once more, for the eager
    run before its capture), decode step and spec tick through the bf16
    or int8 ragged instantiations, the draft's per prefill and draft
    step (flash decode, or with a ``kv_int8`` draft the ragged kernel's
    int8 decode instantiation)."""
    n = cfg.n_layers
    int8 = cfg.kv_int8
    decode = n * counters["steps"]
    verify = n * counters["spec_ticks"]
    draft = draft_layers * counters["draft_steps"]
    prefills = counters["prefills"] + counters["prefill_lazy"]
    return dict(flash=(n + draft_layers) * prefills,
                ragged=0 if int8 else decode,
                verify=0 if int8 else verify,
                int8=(decode if int8 else 0) + (draft if draft_int8 else 0),
                int8_verify=verify if int8 else 0,
                flash_decode=0 if draft_int8 else draft)


def check_launches(launches, want, path):
    if launches != want:
        raise AssertionError(f"{path}: launch counts {launches}, expected "
                             f"{want}")
    idle = [name for name in PATH_KERNELS[path] if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path}: kernels {idle} never launched")


def engine_prompts(cfg, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [5, 30, 64, 100, 128, 300, 480, 512]
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def draft_view(llama, cfg, params, n_layers):
    """A bf16 draft made of the target's first ``n_layers`` layers
    (views, no copy) with its embedding, final norm and head; its dense
    cache is bf16 whatever the target's pool."""
    dcfg = dataclasses.replace(cfg, n_layers=n_layers, kv_int8=False,
                               use_flash=True)
    dparams = dict(params, layers={name: w[:n_layers]
                                   for name, w in params["layers"].items()})
    return dcfg, dparams


def phase_perfect_draft(torch, llama, generate, mods, seed, results):
    log("== phase 8: perfect draft (2-layer full-width model as its own "
        "draft), bf16 pool then kv_int8 target")
    cfg = llama.config("llama3-8b", n_layers=2, use_flash=True)
    params = llama.init(cfg, seed + 1, device="cuda")
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    for int8 in (False, True):
        tcfg = dataclasses.replace(cfg, kv_int8=int8)
        path = "int8_perfect_draft" if int8 else "perfect_draft"
        engine = generate.GenerationEngine(
            tcfg, params, max_slots=8, max_len=2048,
            prompt_buckets=(32, 128, 512), paged_kv=True, kv_page=32,
            draft_cfg=dcfg, draft_params=dparams, spec_gamma=SPEC_GAMMA,
            device="cuda")
        prompts = engine_prompts(cfg, seed)[:4]
        budget = 32
        _, _, launches, counters, _, _ = serve_burst(
            torch, engine, prompts, budget, [generate.Sampling()] * 4, mods,
            300)
        spec = engine.stats()["speculative"]
        rate = acceptance(counters)
        check_launches(launches, expected_launches(tcfg, counters, 2), path)
        results[path] = dict(acceptance_rate=rate, spec=spec,
                             launches=launches, counters=counters,
                             bound=MIN_PERFECT_ACCEPT)
        log(f"{path}: acceptance {counters['accepted']}/"
            f"{counters['proposed']} = "
            f"{rate:.4f} (bound >= {MIN_PERFECT_ACCEPT}); ticks by gamma "
            f"{counters['ticks_by_gamma']}; launches {launches}")
        if rate < MIN_PERFECT_ACCEPT:
            raise AssertionError(f"{path} accepted {rate} < "
                                 f"{MIN_PERFECT_ACCEPT}: verify is broken")
        del engine
    del params, dparams
    torch.cuda.empty_cache()


def engine_kind(cfg, paged, spec):
    """(path name, phase number) of an engine phase."""
    int8 = cfg.kv_int8
    if paged:
        return ("int8_" if int8 else "") + ("spec" if spec else "engine"), \
            9 + int(spec) + 2 * int8
    return "dense" + ("_int8" if int8 else "") + ("_spec" if spec else ""), \
        15 + int(spec) + 2 * int8


def check_dense(engine, outs, figures, path, paired, results):
    """A dense engine's checks beyond the paged ones: its 7 greedy
    completions are the paged engine's of the same configuration (the
    same kernel over the same K/V rows), and the streamed request crossed
    rung 128 to 256."""
    same = outs[:7] == results[paired]["greedy_outputs"]
    crossed = {128, 256} <= set(figures["stream_ticks_by_window"])
    log(f"{path}: 7 greedy completions identical to {paired}'s: {same}; "
        f"streamed request's ticks by window "
        f"{figures['stream_ticks_by_window']}")
    if not same:
        raise AssertionError(f"{path}: greedy completions differ from "
                             f"{paired}'s on the same weights")
    if not crossed:
        raise AssertionError(f"{path}: the streamed request did not cross "
                             f"window rung 128 to 256")
    return same


def kv_bytes(engine):
    stats = engine.stats()
    if engine.paged:
        return stats["kv_pool"]["pool_bytes"]
    return stats["kv_cache"]["cache_bytes"]


def phase_engine(torch, generate, mods, cfg, params, seed, results,
                 paged=True):
    int8 = cfg.kv_int8
    n_layers = cfg.n_layers
    path, number = engine_kind(cfg, paged, spec=False)
    log(f"== phase {number}: llama3-8b engine, {n_layers} layers, full "
        f"width, {'paged' if paged else 'dense cache'}"
        f"{', kv_int8' if int8 else ''}")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]

    def burst(inflight, profile=True):
        engine = generate.GenerationEngine(
            cfg, params, max_slots=8, max_len=2048,
            prompt_buckets=(32, 128, 512), steps_per_tick=4, paged_kv=paged,
            kv_page=32, max_inflight_ticks=inflight, device="cuda")
        got = serve_burst(torch, engine, prompts, budget, samplings, mods,
                          900, stream_tokens=8 if paged else 60,
                          profile=profile)
        check_launches(got[2], expected_launches(cfg, got[3]), path)
        return engine, got

    engine, (outs, wall, launches, counters, ttfts, figures) = burst(2)
    tokens = budget * len(outs)
    row = dict(n_layers=n_layers, kv_int8=int8, paged=paged,
               requests=len(outs), new_tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall,
               ttft_s=ttfts, ttft_p50_s=ttfts[len(ttfts) // 2],
               ttft_max_s=ttfts[-1], launches=launches, counters=counters,
               kv_bytes=kv_bytes(engine), greedy_outputs=outs[:7],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **figures)
    if paged:
        pool = engine.stats()["kv_pool"]
        row.update(num_pages=pool["num_pages"], page_bytes=pool["page_bytes"],
                   pool_bytes=pool["pool_bytes"])
    results[path] = row
    log(f"{path}: {len(outs)} requests x {budget} tokens in {wall:.3f}s = "
        f"{row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.3f}s max {row['ttft_max_s']:.3f}s; "
        f"{counters['prefills']} prefill dispatches, {counters['steps']} "
        f"decode steps; launches {launches}; "
        f"{'pool' if paged else 'cache'} {row['kv_bytes'] / 1e9:.4f} GB; "
        f"capture {row['capture_s']:.2f}s; peak memory "
        f"{row['peak_mem_gb']:.2f} GB")
    if not paged:
        check_dense(engine, outs, figures, path,
                    engine_kind(cfg, True, spec=False)[0], results)
    del engine
    torch.cuda.empty_cache()
    if paged and not int8:
        # the same burst one tick at a time: the greedy completions must
        # not depend on the pipeline's depth (the decode GEMMs always run
        # every slot's row, so each row's numbers are the same)
        engine, (outs_m1, wall_m1, *_rest) = burst(1, profile=False)
        same = outs_m1[:7] == outs[:7]
        row["m1"] = dict(wall_s=wall_m1, tokens_per_s=tokens / wall_m1,
                         greedy_identical=same)
        log(f"{path} at max_inflight_ticks=1: {tokens / wall_m1:.1f} tok/s; "
            f"7 greedy completions identical to max_inflight_ticks=2: "
            f"{same}")
        if not same:
            raise AssertionError("greedy completions differ between "
                                 "max_inflight_ticks 1 and 2")
        del engine
        torch.cuda.empty_cache()
    if int8:
        bf16 = results[engine_kind(dataclasses.replace(cfg, kv_int8=False),
                                   paged, spec=False)[0]]
        ratio = row["kv_bytes"] / bf16["kv_bytes"]
        row["kv_ratio_to_bf16"] = ratio
        log(f"kv_int8 vs bf16 engine: {row['tokens_per_s']:.1f} vs "
            f"{bf16['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{row['ttft_p50_s']:.3f} vs {bf16['ttft_p50_s']:.3f}s; peak "
            f"memory {row['peak_mem_gb']:.2f} vs {bf16['peak_mem_gb']:.2f} "
            f"GB; {'pool' if paged else 'cache'} {row['kv_bytes']} vs "
            f"{bf16['kv_bytes']} bytes = {ratio:.6f}x (expected "
            f"{INT8_POOL_RATIO:.6f})")
        if row.get("num_pages") != bf16.get("num_pages") \
                or abs(ratio - INT8_POOL_RATIO) > 1e-9:
            raise AssertionError(f"int8 KV is {ratio}x the bf16 KV's bytes, "
                                 f"expected {INT8_POOL_RATIO}")
    return launches


def phase_spec_engine(torch, llama, generate, mods, cfg, params, seed,
                      results, paged=True):
    int8 = cfg.kv_int8
    n_layers = cfg.n_layers
    path, number = engine_kind(cfg, paged, spec=True)
    log(f"== phase {number}: llama3-8b speculative engine, {n_layers} "
        f"layers, {'paged' if paged else 'dense cache'}"
        f"{', kv_int8' if int8 else ''}, bf16 draft {DRAFT_LAYERS} layers "
        f"(views of the target's), gamma {SPEC_GAMMA}")
    dcfg, dparams = draft_view(llama, cfg, params, DRAFT_LAYERS)
    engine = generate.GenerationEngine(
        cfg, params, max_slots=8, max_len=2048,
        prompt_buckets=(32, 128, 512), paged_kv=paged, kv_page=32,
        draft_cfg=dcfg, draft_params=dparams, spec_gamma=SPEC_GAMMA,
        max_inflight_ticks=2, device="cuda")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    outs, wall, launches, counters, ttfts, figures = serve_burst(
        torch, engine, prompts, budget, samplings, mods, 900,
        stream_tokens=8 if paged else 60, profile=True)
    check_launches(launches,
                   expected_launches(cfg, counters, DRAFT_LAYERS), path)
    spec = engine.stats()["speculative"]
    tokens = budget * len(outs)
    row = dict(n_layers=n_layers, kv_int8=int8, paged=paged,
               draft_layers=DRAFT_LAYERS, gamma=SPEC_GAMMA,
               requests=len(outs), new_tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall, ttft_s=ttfts,
               ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
               launches=launches, counters=counters, speculative=spec,
               kv_bytes=kv_bytes(engine), greedy_outputs=outs[:7],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **figures)
    results[path + "_engine" if paged else path] = row
    log(f"{path} engine: {len(outs)} requests x {budget} tokens in "
        f"{wall:.3f}s = {row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.3f}s max {row['ttft_max_s']:.3f}s; "
        f"{counters['spec_ticks']} spec ticks (by gamma "
        f"{counters['ticks_by_gamma']}), {counters['draft_steps']} draft "
        f"steps, "
        f"{counters['steps']} plain decode steps, {counters['prefills']} "
        f"prefill dispatches; proposed {counters['proposed']} accepted "
        f"{counters['accepted']} (rate {acceptance(counters):.4f}); final "
        f"gamma cap {spec['gamma_cap']}; launches {launches}; "
        f"{'pool' if paged else 'cache'} {row['kv_bytes'] / 1e9:.4f} GB; "
        f"capture {row['capture_s']:.2f}s; peak memory "
        f"{row['peak_mem_gb']:.2f} GB")
    if not paged:
        check_dense(engine, outs, figures, path,
                    engine_kind(cfg, True, spec=True)[0] + "_engine",
                    results)
    del engine, dparams
    torch.cuda.empty_cache()
    return launches


def phase_d64_kernels(torch, mods, timer, results):
    """Phase 19: every decode-shaped instantiation at head_dim 64, and
    flash prefill at 64, at the ``small`` preset's shapes (Hq = Hkv = 16,
    B 8, max_len 1024), each held to its plain version under the gates of
    phases 3-6 and timed with its bound."""
    flash_mod, ragged_mod, decode_mod = mods
    log("== phase 19: the kernels at head_dim 64 (small preset: Hq 16 / "
        "Hkv 16, B 8, max_len 1024)")
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(19)
    out["flash"] = flash_case(torch, flash_mod, timer, gen, 4, 512, SMALL)
    last = SMALL.width * 32 - 1
    for int8 in (False, True):
        pools = "int8" if int8 else "bf16"
        out["ragged_" + pools] = ragged_case(
            torch, ragged_mod, timer, int8, [0, 1, 31, 32, 33, 500, last, 512],
            1, 40, f"ragged D=64 {pools} B=8", SMALL)
        g_len = SPEC_GAMMA + 1
        out["verify_" + pools] = ragged_case(
            torch, ragged_mod, timer, int8,
            [0, 1, 31, 32, 33, 500, last - g_len, 512], g_len, 41,
            f"verify D=64 {pools} G={g_len}", SMALL)
        g1_bit_check(torch, ragged_mod, int8,
                     [0, 1, 31, 32, 33, 500, last, 512],
                     f"verify D=64 {pools}", SMALL)
    out["identity"] = identity_cases(torch, ragged_mod, timer, SMALL)
    fills = SMALL.dense_fills
    out["flash_decode"] = flash_decode_case(
        torch, decode_mod, timer, [0, 1, 127, 128, 129, 500, 900, 1023],
        SMALL.dense_t, 42, SMALL)
    out["window_flash_decode"] = [
        flash_decode_case(torch, decode_mod, timer,
                          [min(n, rung - 1) for n in fills[:-1]]
                          + [fills[-1]], SMALL.dense_t, 43, SMALL,
                          window=rung, sdpa=False)
        for rung in (128, 256, 512)]
    results["d64"] = out
    return out


# the example app's engine (examples/llama-generate/main.py:135-145):
# max_len min(max_seq_len, 1024), 8 slots, 16 steps a tick, 4 ticks in
# flight; dense unless GENERATE_PAGED_KV=1
SMALL_ENGINE = dict(max_slots=8, max_len=1024, steps_per_tick=16,
                    max_inflight_ticks=4)
# the smoke's length: every small phase but the app's (37, 38) runs
# ``small`` at full width cut to 2 of its 8 layers
CUT_SMALL_LAYERS = 2


def depth(params):
    """Layers of a llama params tree."""
    return params["layers"]["wq"].shape[0]


def phase_small_engines(torch, llama, generate, mods, seed, results):
    """Phases 20-23: the example's default preset (``small`` at full width,
    ``CUT_SMALL_LAYERS`` of its 8 layers) at the example's engine
    defaults, dense bf16; paged; dense ``kv_int8``; speculative (a
    2-layer draft of views, bf16 then int8 target). Returns the params
    and launches by path."""
    cfg = llama.config("small", use_flash=True, n_layers=CUT_SMALL_LAYERS)
    params = llama.init(cfg, seed + 2, device="cuda")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    int8_cfg = dataclasses.replace(cfg, kv_int8=True)
    spec = dict(draft_cfg=dcfg, draft_params=dparams, spec_gamma=SPEC_GAMMA)
    runs = (("small", 20, cfg, {}),
            ("small_paged", 21, cfg, dict(paged_kv=True, kv_page=32)),
            ("small_int8", 22, int8_cfg, {}),
            ("small_spec", 23, cfg, spec),
            ("small_int8_spec", 23, int8_cfg, spec))
    by_path = {}
    for path, number, c, kw in runs:
        log(f"== phase {number}: {path}: the small preset at full width "
            f"(dim {c.dim}, {c.n_layers} layers, {c.n_heads}/"
            f"{c.n_kv_heads} heads, head_dim {c.head_dim}), the example's "
            f"engine {SMALL_ENGINE}, "
            f"{'paged' if kw.get('paged_kv') else 'dense'}"
            f"{', kv_int8' if c.kv_int8 else ''}"
            f"{', draft 2 layers gamma 4' if 'draft_cfg' in kw else ''}")
        engine = generate.GenerationEngine(c, params, device="cuda",
                                           **SMALL_ENGINE, **kw)
        extra = None
        if path == "small":
            # the prefill's host seconds on the device thread, replayed
            # against run eagerly, on the same engine
            async def extra(engine):
                return await replay_against_eager(engine, prompts, budget,
                                                  samplings)
        outs, wall, launches, counters, ttfts, figures = serve_burst(
            torch, engine, prompts, budget, samplings, mods, 600,
            stream_tokens=8, profile=True, extra=extra)
        if extra is not None:
            figures["replay_against_eager"] = check_replay_against_eager(
                figures.pop("extra"), path)
        draft_layers = 2 if "draft_cfg" in kw else 0
        check_launches(launches,
                       expected_launches(c, counters, draft_layers), path)
        tokens = budget * len(outs)
        row = dict(requests=len(outs), new_tokens=tokens, wall_s=wall,
                   tokens_per_s=tokens / wall, ttft_s=ttfts,
                   ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
                   launches=launches, counters=counters,
                   kv_bytes=kv_bytes(engine), greedy_outputs=outs[:7],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **figures)
        if draft_layers:
            row["speculative"] = engine.stats()["speculative"]
        results[path] = row
        by_path[path] = launches
        log(f"{path}: {len(outs)} requests x {budget} tokens in {wall:.3f}s "
            f"= {row['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{row['ttft_p50_s']:.4f}s max {row['ttft_max_s']:.4f}s; "
            f"{counters['prefills']} prefills, {counters['steps']} decode "
            f"steps, {counters['spec_ticks']} spec ticks (acceptance "
            f"{acceptance(counters):.3f}); launches {launches}; KV "
            f"{row['kv_bytes']} bytes")
        del engine
        torch.cuda.empty_cache()
    same = results["small_paged"]["greedy_outputs"] \
        == results["small"]["greedy_outputs"]
    ratio = results["small_int8"]["kv_bytes"] / results["small"]["kv_bytes"]
    results["small"].update(paged_greedy_identical=same,
                            int8_kv_ratio=ratio)
    log(f"small: paged greedy completions identical to dense: {same}; "
        f"int8 cache {ratio:.6f}x the bf16 cache's bytes (expected "
        f"{INT8_RATIO_D64})")
    if not same:
        raise AssertionError("small: the paged engine's greedy completions "
                             "differ from the dense engine's")
    if ratio != INT8_RATIO_D64:
        raise AssertionError(f"small int8 cache is {ratio}x the bf16 "
                             f"cache's bytes, expected {INT8_RATIO_D64}")
    return params, by_path


def check_replay_against_eager(runs, path):
    """Log the prefill's host seconds replayed and eager; fail unless the
    two give the same greedy completions. Returns the figures without
    the outputs."""
    replay, eager = runs["replay"], runs["eager"]
    same = replay["outs"][:7] == eager["outs"][:7]
    for run in (replay, eager):
        run.pop("outs")
    log(f"{path}: prefill host seconds on the device thread, replayed "
        f"{[round(c['host_s'], 6) for c in replay['prefill_calls']]} "
        f"(sum {replay['prefill_host_s']:.6f}s) against eager "
        f"{[round(c['host_s'], 6) for c in eager['prefill_calls']]} "
        f"(sum {eager['prefill_host_s']:.6f}s), rungs "
        f"{[(c['rows'], c['bucket']) for c in replay['prefill_calls']]}; "
        f"tok/s {replay['tokens_per_s']:.1f} against "
        f"{eager['tokens_per_s']:.1f}, TTFT p50 "
        f"{replay['ttft_p50_s']:.4f}s against {eager['ttft_p50_s']:.4f}s, "
        f"max {replay['ttft_max_s']:.4f}s against "
        f"{eager['ttft_max_s']:.4f}s; 7 greedy completions equal: {same}")
    if not same:
        raise AssertionError(f"{path}: greedy completions differ between "
                             f"replayed and eager prefills")
    return dict(runs, greedy_identical=same)


# phase 29: a speculative engine whose draft keeps a kv_int8 cache
PATH_KERNELS.update({"small_int8_draft": ("flash", "verify", "int8"),
                     "small_int8_draft_paged": ("flash", "verify", "int8")})


def phase_int8_draft(torch, llama, generate, mods, params, seed, results):
    """Phase 29: the ``small`` spec engine at the example's engine with a
    2-layer ``kv_int8`` draft of views (JAX serves it as given), dense and
    paged: the draft decodes through the ragged kernel's int8
    instantiation over its identity tables; every tick and prefill a
    replay, launches as counted; then the same engine with its prefills
    run eagerly must give the same greedy tokens. Returns launches by
    path."""
    cfg = llama.config("small", use_flash=True, n_layers=depth(params))
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    dcfg = dataclasses.replace(dcfg, kv_int8=True)
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    by_path = {}
    for path, kw in (("small_int8_draft", {}),
                     ("small_int8_draft_paged",
                      dict(paged_kv=True, kv_page=32))):
        log(f"== phase 29: {path}: the small preset's spec engine with a "
            f"2-layer kv_int8 draft (views of the target's), gamma "
            f"{SPEC_GAMMA}, {'paged' if kw else 'dense'}")
        engine = generate.GenerationEngine(
            cfg, params, device="cuda", draft_cfg=dcfg, draft_params=dparams,
            spec_gamma=SPEC_GAMMA, **SMALL_ENGINE, **kw)

        async def extra(engine):
            return await replay_against_eager(engine, prompts, budget,
                                              samplings, turns=1)
        outs, wall, launches, counters, ttfts, figures = serve_burst(
            torch, engine, prompts, budget, samplings, mods, 600,
            stream_tokens=8, extra=extra)
        check_launches(launches, expected_launches(cfg, counters, 2, True),
                       path)
        if engine._draft_cache["k"].dtype != torch.int8 \
                or engine.draft_cfg.use_flash_decode:
            raise AssertionError(f"{path}: the draft is not int8 over the "
                                 f"ragged route")
        runs = check_replay_against_eager(figures.pop("extra"), path)
        tokens = budget * len(outs)
        results[path] = dict(
            tokens_per_s=tokens / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
            ttft_max_s=ttfts[-1], launches=launches, counters=counters,
            speculative=engine.stats()["speculative"],
            greedy_outputs=outs[:7], replay_against_eager=runs, **figures)
        log(f"{path}: {tokens / wall:.1f} tok/s, TTFT p50 "
            f"{ttfts[len(ttfts) // 2]:.4f}s; {counters['spec_ticks']} spec "
            f"ticks, acceptance {acceptance(counters):.3f}; launches "
            f"{launches}")
        by_path[path] = launches
        del engine
        torch.cuda.empty_cache()
    if results["small_int8_draft"]["greedy_outputs"] \
            != results["small_int8_draft_paged"]["greedy_outputs"]:
        raise AssertionError("small_int8_draft: the paged engine's greedy "
                             "completions differ from the dense engine's")
    return by_path


# -- phase 30: every engine argument the example app passes ---------------
PATH_KERNELS.update({"moe_small": ("ragged",),
                     "shared_pool": ("flash", "ragged"),
                     "ragged_off": ("flash",),
                     "coalesced": ("flash", "ragged"),
                     "uncoalesced": ("flash", "ragged"),
                     "int8_weights": ("flash", "ragged")})


async def timed_burst(torch, engine, prompts, budget, samplings, timeout,
                      profile=False):
    """One burst on a started engine: (outputs, wall seconds, sorted
    TTFTs, the device's idle share under ``torch.profiler`` or None)."""
    from torch.profiler import ProfilerActivity

    gc.collect()
    engine.ttfts.clear()
    prof = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.__enter__()
    t0 = time.monotonic()
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, budget, sampling=s)
            for p, s in zip(prompts, samplings)]), timeout)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    idle = None
    if prof is not None:
        idle = 1.0 - sum(device_times(torch, prof)[0].values()) / wall
    return outs, wall, sorted(engine.ttfts), idle


def state_bits(torch, engine):
    """The engine's device state, bf16 leaves as their int16 bits."""
    out = {"cache_len": engine.cache_len, "last_token": engine.last_token,
           "keys": engine.sample_keys}
    out.update({f"kv.{k}": (v[:, :-1] if engine.paged else v)
                for k, v in kv_shards(engine).items()})
    return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            .clone() for k, v in out.items()}


def replay_equals_eager(torch, engine, eager, replay, what):
    """Run ``eager()`` from a copy of the engine's state, restore it, run
    ``replay()``; fail unless the outputs and the state are the same
    bits. Returns the outputs."""
    live = dict(cache_len=engine.cache_len, last_token=engine.last_token,
                keys=engine.sample_keys, **kv_shards(engine))
    saved = {k: v.clone() for k, v in live.items()}
    want = eager()
    want = want.cpu().numpy() if hasattr(want, "cpu") else want
    torch.cuda.synchronize()
    after = state_bits(torch, engine)
    for k, v in live.items():
        v.copy_(saved[k])
    got = replay()
    torch.cuda.synchronize()
    import numpy as np

    same = np.array_equal(np.asarray(got), np.asarray(want)) and all(
        torch.equal(v, after[k]) for k, v in state_bits(torch,
                                                        engine).items())
    log(f"{what}: replay = eager bits (outputs and state): {same}")
    if not same:
        raise AssertionError(f"{what}: the replay differs from the eager "
                             f"run")
    return got


def random_state(torch, engine, seed, fills):
    """Random dense cache rows and live state on every slot (an MoE
    routes every row)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for leaf in engine.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda")
                   * 0.5)
    engine.cache_len.copy_(torch.tensor(fills, dtype=torch.int32))
    engine.last_token.copy_(torch.randint(
        0, engine.cfg.vocab_size, (engine.max_slots,), generator=gen,
        device="cuda"))
    engine.active.fill_(True)


def moe_step_shares(torch, moe, engine, prefill_key, step_ms, timer):
    """The dispatch and combine einsums' share of a prefill and of a
    decode step: the two einsums timed alone (CUDA events, L2 flushed)
    at the path's shapes, times the layers, over the prefill rung's
    replay and over a tick step's time."""
    cfg = engine.cfg
    d, e = cfg.dim, cfg.n_experts
    out = {}
    for name, tokens in (("prefill", prefill_key[0] * prefill_key[1]),
                         ("step", engine.max_slots)):
        cap = max(1, int(math.ceil(tokens / e * cfg.capacity_factor)))
        dispatch = torch.rand((tokens, e, cap), device="cuda")
        flat = torch.randn((tokens, d), device="cuda")
        expert_out = torch.randn((e, cap, d), device="cuda")
        ms = timer(lambda: (torch.einsum("tec,td->ecd", dispatch, flat),
                            torch.einsum("tec,ecd->td", dispatch,
                                         expert_out)))
        out[name] = dict(tokens=tokens, capacity=cap,
                         einsums_ms_per_layer=ms,
                         einsums_ms=ms * cfg.n_layers,
                         dispatch_mb=dispatch.numel() * 4 / 2**20)
        del dispatch, flat, expert_out
    rung = engine._prefills[prefill_key]
    prefill_ms = timer(lambda: rung.graph.replay(), iters=5)
    out["prefill"].update(graph_ms=prefill_ms,
                          share=out["prefill"]["einsums_ms"] / prefill_ms)
    out["step"].update(step_ms=step_ms,
                       share=out["step"]["einsums_ms"] / step_ms)
    log(f"moe einsums (dispatch + combine, {cfg.n_layers} layers): "
        f"prefill {prefill_key[:2]} {out['prefill']['einsums_ms']:.3f} of "
        f"{prefill_ms:.3f} ms = {out['prefill']['share']:.3f} (T "
        f"{out['prefill']['tokens']}, C {out['prefill']['capacity']}, the "
        f"(T, E, C) tensor {out['prefill']['dispatch_mb']:.1f} MiB); step "
        f"{out['step']['einsums_ms']:.4f} of {step_ms:.4f} ms = "
        f"{out['step']['share']:.3f}")
    return out


def phase_moe(torch, llama, moe, generate, mods, seed, results):
    """Phase 30a: ``moe-small`` at the example app's engine: the app's
    ``warmup(prompt_counts=(1, 8))``, prefill graphs at JAX's rows, replay
    = eager bits for a tick and a prefill, phase 9's burst. Returns its
    launches."""
    import numpy as np

    cfg = moe.config(base=llama.config("small", vocab_size=EXAMPLE_VOCAB,
                                       n_layers=CUT_SMALL_LAYERS))
    log(f"== phase 30a: moe-small (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"ffn {cfg.base.ffn_dim}, {cfg.n_experts} experts, capacity factor "
        f"{cfg.capacity_factor}) at the example's engine {SMALL_ENGINE}, "
        f"dense")
    params = moe.init(cfg, seed + 5, device="cuda")
    engine = generate.GenerationEngine(cfg, params, model_module=moe,
                                       device="cuda", **SMALL_ENGINE)
    memory = {}
    probe_warmup_memory(torch, engine, memory)
    t0 = time.monotonic()
    asyncio.run(engine.warmup(prompt_counts=(1, 8)))
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    keys = sorted(tuple(k) for k in
                  engine.stats()["graphs"]["prefill"]["keys"])
    want = sorted((n, b, 0, False, 0) for b in engine.prompt_buckets
                  for n in (1, 8))
    log(f"moe prefill graphs {keys} (JAX's rows: {want})")
    if keys != want:
        raise AssertionError(f"moe prefill graphs {keys}, expected JAX's "
                             f"rows {want} (no padding to "
                             f"{generate.CUDA_MIN_PREFILL_ROWS} rows)")
    # replay = eager bits, one tick and one prefill, on random live state
    tick = next(k for k in engine._graphs if k[0] == "plain"
                and k[1] == engine.steps_per_tick and not k[2])
    random_state(torch, engine, seed + 6, [5, 30, 64, 100, 8, 90, 17, 50])
    replay_equals_eager(torch, engine,
                        lambda: engine._tick_body(tick, engine.active),
                        lambda: engine._run_tick(tick, None, None)(),
                        f"moe tick {tick}")
    pkey = (8, 512, 0, False, 0)
    rng = np.random.default_rng(seed + 7)
    arrays = engine._group_arrays(8, 512, 0)
    lengths = [512, 480, 300, 128, 100, 64, 30, 5]
    for row, n in enumerate(lengths):
        arrays["tokens"][row, :n] = rng.integers(0, cfg.vocab_size, n)
        arrays["lengths"][row] = n
        arrays["row_of_slot"][row] = row
        arrays["seeds"][row] = row
    floats = engine._group_floats(8, False)
    ints, layout = generate._pack(arrays)
    rung = engine._prefills[pkey]

    def eager_prefill_once():
        engine._upload_prefill(rung, ints, floats)
        return engine._prefill_body(rung)
    replay_equals_eager(
        torch, engine, eager_prefill_once,
        lambda: engine._prefill_insert(8, 512, 8, 0, ints, layout, floats)(),
        f"moe prefill {pkey}")
    engine._reset_device_state()
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]

    async def serve():
        await engine.start()
        try:
            # the app warms counts 1 and 8 only: the first burst captures
            # its other rows' rungs; the second is counted
            first = await timed_burst(torch, engine, prompts, budget,
                                      samplings, 600)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            counted = await timed_burst(torch, engine, prompts, budget,
                                        samplings, 600)
            launches = read_launches(mods)
            after = run_counters(engine)
            profiled = await timed_burst(torch, engine, prompts, budget,
                                         samplings, 600, profile=True)
            return first, counted, launches, before, after, profiled
        finally:
            await engine.stop()

    first, counted, launches, before, after, profiled = asyncio.run(serve())
    counters = {k: after[k] - before[k] for k in after}
    outs, wall, ttfts, _ = counted
    if outs[:7] != first[0][:7]:
        raise AssertionError("moe: greedy completions differ between the "
                             "first and the counted burst")
    if counters["replays"] != counters["ticks"] or counters["lazy_captures"] \
            or counters["prefill_replays"] != counters["prefills"] \
            or counters["prefill_lazy"]:
        raise AssertionError(f"moe: every tick and prefill of the counted "
                             f"burst must replay a graph: {counters}")
    want_launches = dict.fromkeys(launches, 0)
    want_launches["ragged"] = cfg.n_layers * counters["steps"]
    check_launches(launches, want_launches, "moe_small")
    for out in outs:
        if len(out) != budget or not all(0 <= t < cfg.vocab_size
                                         for t in out):
            raise AssertionError(f"moe: bad completion {out}")
    step_ms = wall * 1e3 / max(counters["steps"], 1)
    timer = Timer(torch)
    shares = moe_step_shares(torch, moe, engine, pkey, step_ms, timer)
    del timer
    tokens = budget * len(outs)
    graphs = engine.stats()["graphs"]
    row = dict(tokens_per_s=tokens / wall, wall_s=wall, ttft_s=ttfts,
               ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
               device_idle_share=profiled[3], warmup_s=warm_s,
               capture_s=graphs["capture_s"],
               prefill_capture_s=graphs["prefill"]["capture_s"],
               prefill_graph_keys=keys, reserved_after_warmup=memory[
                   "_warm_prefills_after"],
               tick_capture_bytes=memory["_warm_after"]
               - memory["_warm_before"],
               prefill_capture_bytes=memory["_warm_prefills_after"]
               - memory["_warm_prefills_before"],
               launches=launches, counters=counters, einsums=shares,
               greedy_outputs=outs[:7])
    results["moe_small"] = row
    log(f"moe_small: {tokens / wall:.1f} tok/s, TTFT p50 "
        f"{row['ttft_p50_s']:.4f}s max {row['ttft_max_s']:.4f}s, device "
        f"idle share {profiled[3]:.4f}; warmup {warm_s:.2f}s (ticks "
        f"{row['capture_s']:.2f}s, prefills {row['prefill_capture_s']:.2f}s"
        f"), reserved {row['reserved_after_warmup']} bytes after warmup "
        f"(+{row['tick_capture_bytes']} ticks, "
        f"+{row['prefill_capture_bytes']} prefills); {counters['steps']} "
        f"decode steps, {counters['prefills']} prefills; ragged launches "
        f"{launches['ragged']}")
    del engine, params
    torch.cuda.empty_cache()
    return {"moe_small": launches}


def serve_alone(torch, engine, prompts, budget, samplings):
    """Warm ``engine`` as the app does and serve one burst on it."""
    async def run():
        await engine.warmup(prompt_counts=(1, engine.max_slots))
        await engine.start()
        try:
            return await timed_burst(torch, engine, prompts, budget,
                                     samplings, 600)
        finally:
            await engine.stop()
    return asyncio.run(run())


def phase_shared_pool(torch, generate, page_pool, mods, cfg, params, seed,
                      results):
    """Phase 30b: two ``small`` paged engines sharing one ``PagePool``
    sized by ``budget_bytes`` (the app's MODELS path), each alone, then
    concurrent; a reset by one fails the other's in-flight request; an
    engine sized by ``kv_pool_bytes``. Returns launches."""
    log("== phase 30b: two small paged engines sharing one page pool "
        "(budget_bytes 512 MiB), concurrent bursts, a co-resident's reset")
    budget_bytes = 512 << 20
    pool = page_pool.PagePool(cfg, page=32, budget_bytes=budget_bytes,
                              device="cuda")
    kw = dict(SMALL_ENGINE, paged_kv=True, kv_page=32, device="cuda")
    engines = [generate.GenerationEngine(cfg, params, page_pool=pool,
                                         model_name=f"m{i}", **kw)
               for i in range(2)]
    prompts = [engine_prompts(cfg, seed + i) for i in range(2)]
    budget = 32
    samplings = [generate.Sampling()] * 8
    alone = [serve_alone(torch, e, p, budget, samplings)[0]
             for e, p in zip(engines, prompts)]
    for mod in mods:
        mod.reset_launches()

    async def together():
        for e in engines:
            await e.start()
        try:
            before = [run_counters(e) for e in engines]
            bursts = await asyncio.gather(*[
                timed_burst(torch, e, p, budget, samplings, 600)
                for e, p in zip(engines, prompts)])
            launches = read_launches(mods)
            want = dict.fromkeys(launches, 0)
            for e, b in zip(engines, before):
                after = run_counters(e)
                for k, n in expected_launches(cfg, {
                        k: after[k] - b[k] for k in after}).items():
                    want[k] += n
            # a reset by engine 0 while engine 1 has a request in flight
            stream = await engines[1].generate_stream(prompts[1][2], 400)
            first = await stream.__anext__()
            await asyncio.get_running_loop().run_in_executor(
                engines[0]._device_exec, engines[0]._reset_device_state)
            try:
                rest = [tok async for tok in stream]
                failed = None
            except RuntimeError as exc:
                rest, failed = None, exc
            again = await timed_burst(torch, engines[1], prompts[1], budget,
                                      samplings, 600)
            return bursts, launches, want, rest, failed, again
        finally:
            for e in engines:
                await e.stop()

    bursts, launches, want, rest, failed, again = asyncio.run(together())
    same = [b[0] == a for b, a in zip(bursts, alone)]
    used = pool.used_pages
    log(f"shared pool ({pool.num_pages} pages of {pool.page_bytes} bytes): "
        f"concurrent tokens equal each engine's alone: {same}; pages in "
        f"use after the bursts: {used}; tok/s "
        f"{[round(budget * 8 / b[1], 1) for b in bursts]}; the reset "
        f"failed engine 1's in-flight request: {failed!r}; engine 1's next "
        f"burst equals its tokens alone: {again[0] == alone[1]}")
    if not all(same):
        raise AssertionError("shared pool: an engine's tokens differ from "
                             "its tokens alone")
    if failed is None or "co-resident" not in str(failed):
        raise AssertionError(f"shared pool: the reset did not fail the "
                             f"other engine's request (got {rest})")
    if again[0] != alone[1]:
        raise AssertionError("shared pool: engine 1 after the reset gives "
                             "other tokens")
    if pool.used_pages:
        raise AssertionError(f"shared pool: {pool.used_pages} pages still "
                             f"in use after every request finished")
    check_launches(launches, want, "shared_pool")
    sized = generate.GenerationEngine(cfg, params, kv_pool_bytes=256 << 20,
                                      **kw)
    want_pages = (256 << 20) // sized._pool.page_bytes
    log(f"kv_pool_bytes 256 MiB: {sized._pool.num_pages} pages (expected "
        f"{want_pages})")
    if sized._pool.num_pages != want_pages:
        raise AssertionError("kv_pool_bytes: wrong page count")
    results["shared_pool"] = dict(
        num_pages=pool.num_pages, budget_bytes=budget_bytes,
        tokens_per_s=[budget * 8 / b[1] for b in bursts],
        ttft_p50_s=[b[2][len(b[2]) // 2] for b in bursts],
        identical_to_alone=same, reset_failed=repr(failed),
        kv_pool_bytes_pages=sized._pool.num_pages, launches=launches)
    del engines, sized, pool
    torch.cuda.empty_cache()
    return {"shared_pool": launches}


def phase_ragged_off(torch, llama, generate, mods, cfg, params, seed,
                     results):
    """Phase 30c: ``ragged_attn="off"`` on the small paged engine against
    ``"auto"`` (phase 21's engine, the same weights and burst): no ragged
    launch in the burst; one step's logits on a fixed prompt within the
    ragged row gate. Returns launches."""
    log("== phase 30c: ragged_attn off (gather formulation) against auto "
        "(phase 21), small paged")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    auto = results["small_paged"]
    out = {"auto": dict(tokens_per_s=auto["tokens_per_s"],
                        ttft_p50_s=auto["ttft_p50_s"], attn_path="ragged",
                        launches=auto["launches"],
                        greedy_outputs=auto["greedy_outputs"])}
    by_path = {}
    for mode in ("off",):
        engine = generate.GenerationEngine(
            cfg, params, paged_kv=True, kv_page=32, ragged_attn=mode,
            device="cuda", **SMALL_ENGINE)

        async def run():
            await warm(engine)
            await engine.start()
            try:
                await timed_burst(torch, engine, prompts, budget,
                                  samplings, 600)
                for mod in mods:
                    mod.reset_launches()
                before = run_counters(engine)
                got = await timed_burst(torch, engine, prompts, budget,
                                        samplings, 600)
                after = run_counters(engine)
                return got, read_launches(mods), {
                    k: after[k] - before[k] for k in after}
            finally:
                await engine.stop()
        (outs, wall, ttfts, _), launches, counters = asyncio.run(run())
        want = dict(expected_launches(cfg, counters), ragged=0)
        check_launches(launches, want, "ragged_off")
        out[mode] = dict(tokens_per_s=budget * 8 / wall,
                         ttft_p50_s=ttfts[len(ttfts) // 2],
                         attn_path=engine.attn_path, launches=launches,
                         greedy_outputs=outs[:7])
        log(f"ragged_attn={mode}: {budget * 8 / wall:.1f} tok/s, TTFT p50 "
            f"{ttfts[len(ttfts) // 2]:.4f}s, path {engine.attn_path}, "
            f"launches {launches}")
        del engine
        torch.cuda.empty_cache()
    if out["off"]["launches"]["ragged"] or out["off"]["attn_path"] \
            != "gather":
        raise AssertionError(f"ragged_attn off: {out['off']['launches']}")
    by_path["ragged_off"] = out["off"]["launches"]
    # one decode step's logits on a fixed prompt, both formulations
    pool_cfg = cfg
    from gofr_tpu_torch.tpu.page_pool import PagePool

    pool = PagePool(pool_cfg, page=32, num_pages=40, device="cuda")
    b = 2
    rng = torch.Generator(device="cuda").manual_seed(seed + 9)
    prompt = torch.randint(0, cfg.vocab_size, (b, 300), generator=rng,
                           device="cuda")
    small = llama.init_cache(cfg, b, 320, device="cuda")
    logits, small, lens = llama.prefill(params, cfg, prompt, small)
    table = torch.arange(2 * 10, dtype=torch.int32,
                         device="cuda").view(b, 10)
    for name, leaf in pool.leaves.items():
        leaf[:, :20] = small[name].reshape(cfg.n_layers, 20, 32,
                                           *small[name].shape[3:])
    token = logits.argmax(-1)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    steps = {}
    for ragged in (True, False):
        leaves = {k: v.clone() for k, v in pool.leaves.items()}
        steps[ragged] = llama.decode_step_paged(
            params, cfg, token, leaves, table, lens, active,
            ragged=ragged)[0].float()
    diff = steps[False] - steps[True]
    row_rel = (diff.norm(dim=-1) / steps[True].norm(dim=-1)).max().item()
    log(f"one step's logits, gather against ragged: max abs "
        f"{diff.abs().max().item():.3e}, row relative L2 {row_rel:.3e} "
        f"(gate {RAGGED_ROW_TOL:.3e}); the burst's 7 greedy completions "
        f"equal auto's: "
        f"{out['off']['greedy_outputs'] == out['auto']['greedy_outputs']}")
    if not row_rel <= RAGGED_ROW_TOL:
        raise AssertionError(f"ragged_attn off: logits row relative L2 "
                             f"{row_rel} over {RAGGED_ROW_TOL}")
    out["step_logits_row_rel_l2"] = row_rel
    out["greedy_identical"] = (out["off"]["greedy_outputs"]
                               == out["auto"]["greedy_outputs"])
    results["ragged_off"] = out
    del pool
    torch.cuda.empty_cache()
    return by_path


def phase_coalesce(torch, llama, generate, mods, cfg, params, seed, results):
    """Phase 30d/e: ``coalesce_uploads`` and ``coalesce_stream`` on against
    off on the small dense engine (the same tokens; H2D copies a tick,
    tok/s, idle share), a coalesced tick's replay = eager bits; then the
    engine over ``llama.quantize_params`` weights. Returns launches."""
    log("== phase 30d: coalesce_uploads + coalesce_stream on against off, "
        "small dense; 30e: int8 weights (quantize_params)")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    qparams = llama.quantize_params(params)
    runs = {}
    by_path = {}
    for name, kw, weights in (
            ("uncoalesced", {}, params),
            ("coalesced", dict(coalesce_uploads=True, coalesce_stream=True),
             params),
            ("int8_weights", {}, qparams)):
        engine = generate.GenerationEngine(cfg, weights, device="cuda",
                                           **SMALL_ENGINE, **kw)

        async def run():
            await engine.warmup(prompt_counts=(1, engine.max_slots))
            await engine.start()
            try:
                await timed_burst(torch, engine, prompts, budget, samplings,
                                  600)
                for mod in mods:
                    mod.reset_launches()
                up0 = engine.data_plane()
                before = run_counters(engine)
                got = await timed_burst(torch, engine, prompts, budget,
                                        samplings, 600)
                launches = read_launches(mods)
                up1 = engine.data_plane()
                after = run_counters(engine)
                check_launches(launches, expected_launches(cfg, {
                    k: after[k] - before[k] for k in after}), name)
                ticks = after["ticks"] - before["ticks"]
                prof = await timed_burst(torch, engine, prompts, budget,
                                         samplings, 600, profile=True)
                stream = await engine.generate_stream(prompts[3], 40)
                streamed = [tok async for tok in stream]
                return got, launches, up0, up1, ticks, prof[3], streamed
            finally:
                await engine.stop()
        (outs, wall, ttfts, _), launches, up0, up1, ticks, idle, streamed = \
            asyncio.run(run())
        copies = up1["h2d_uploads"] - up0["h2d_uploads"]
        row = dict(tokens_per_s=budget * 8 / wall,
                   ttft_p50_s=ttfts[len(ttfts) // 2], device_idle_share=idle,
                   h2d_copies=copies, ticks=ticks,
                   h2d_copies_per_tick=copies / max(ticks, 1),
                   h2d_bytes=up1["h2d_bytes"] - up0["h2d_bytes"],
                   coalescer=up1["coalescer"], launches=launches,
                   greedy_outputs=outs[:7], streamed=streamed,
                   weight_bytes=sum(t.numel() * t.element_size()
                                    for t in _leaves(weights)))
        runs[name] = row
        by_path[name] = launches
        log(f"{name}: {row['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{row['ttft_p50_s']:.4f}s, idle share {idle:.4f}; {copies} "
            f"H2D copies over {ticks} ticks and the prefills "
            f"({row['h2d_copies_per_tick']:.3f} a tick), coalescer "
            f"{up1['coalescer']}; weights {row['weight_bytes']} bytes; "
            f"launches {launches}")
        if name == "coalesced":
            key = next(k for k in engine._graphs if k[0] == "plain")
            random_state(torch, engine, seed + 10,
                         [5, 30, 64, 100, 8, 90, 17, 50])
            replay_equals_eager(
                torch, engine, lambda: engine._tick_body(key, engine.active),
                lambda: engine._run_tick(key, None, None)(),
                f"coalesced tick {key}")
            if runs[name]["coalescer"]["transfers"] == 0:
                raise AssertionError("coalesce_uploads: no coalesced "
                                     "transfer")
        del engine
        torch.cuda.empty_cache()
    off = runs["uncoalesced"]
    same = runs["coalesced"]["greedy_outputs"] == off["greedy_outputs"]
    same_stream = runs["coalesced"]["streamed"] == off["streamed"]
    log(f"coalescing on = off: greedy tokens {same}, streamed tokens "
        f"{same_stream}; int8 weights {runs['int8_weights']['tokens_per_s']:.1f}"
        f" tok/s against bf16 {off['tokens_per_s']:.1f}, weights "
        f"{runs['int8_weights']['weight_bytes']} against "
        f"{off['weight_bytes']} bytes")
    if not (same and same_stream):
        raise AssertionError("coalescing changed the tokens")
    results["coalesce"] = runs
    del qparams
    torch.cuda.empty_cache()
    return by_path


def phase_engine_args(torch, llama, moe, generate, page_pool, mods, params,
                      seed, results):
    """Phase 30: every engine argument the example app passes."""
    t0 = time.monotonic()
    cfg = llama.config("small", use_flash=True, n_layers=depth(params))
    by_path = phase_moe(torch, llama, moe, generate, mods, seed, results)
    by_path.update(phase_shared_pool(torch, generate, page_pool, mods, cfg,
                                     params, seed, results))
    by_path.update(phase_ragged_off(torch, llama, generate, mods, cfg,
                                    params, seed, results))
    by_path.update(phase_coalesce(torch, llama, generate, mods, cfg, params,
                                  seed, results))
    results["phase30_s"] = time.monotonic() - t0
    log(f"phase 30: {results['phase30_s']:.1f}s")
    return by_path


# phase 31: the operating point and the telemetry plane App.start wires
OP_MOVE = dict(prompt_buckets=(32, 128, 256, 512), steps_per_tick=32)
OP_SEED = dict(prompt_buckets=(32, 128, 512), steps_per_tick=16)
# a prompt only the move's new bucket (256) admits, and a budget for rung 32
OP_NEW_BUCKET_LEN, OP_MOVED_BUDGET = 200, 64


def reserved_bytes(torch):
    """The allocator's reserved bytes, its cache emptied first (what stays
    is tensors and the captured graphs' pools)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_stats()["reserved_bytes.all.current"]


class TickClock:
    """Records each tick the device thread runs (``_run_tick``): when,
    and its key."""

    def __init__(self, engine):
        self.calls = []
        run_tick = engine._run_tick

        def timed(key, *args):
            self.calls.append((time.monotonic(), key))
            return run_tick(key, *args)
        engine._run_tick = timed

    def longest_gap(self, start, end):
        """The longest time between two ticks in [start, end], its edges
        counted as ticks."""
        times = [start] + [t for t, _ in self.calls if start <= t <= end] \
            + [end]
        return max(b - a for a, b in zip(times, times[1:]))

    def ks_since(self, at):
        return sorted({key[1] for _, key in self.calls[at:]})


class Planes:
    """What ``App.start`` attaches beside a generation engine
    (``gofr_tpu/app.py:481-627``), the port's objects: a traffic recorder
    (``attach_workload``), a telemetry store sampled every 0.1 s over the
    default signals with each tick's anatomy (``attach_telemetry``,
    ``tick_sample`` 1), an error-budget plane feeding a watchdog's
    ``budget_fn`` and its brownout ladder's escalation gate, and a
    worst-offender ring on the flight recorder diagnosed against the
    window context. ``attach`` / ``detach`` turn them on and off (the
    sampler and the watchdog's timer with them) on a started engine."""

    def __init__(self, engine, metrics, tracker):
        from types import SimpleNamespace

        from gofr_tpu_torch.hbmz import hbm_occupancy
        from gofr_tpu_torch.metrics.timeseries import (
            TimeSeriesStore, register_default_signals)
        from gofr_tpu_torch.slo import BrownoutLadder, Watchdog
        from gofr_tpu_torch.slo_budget import ErrorBudgetPlane
        from gofr_tpu_torch.tpu.diagnose import (WorstOffenders,
                                                 build_window_context)
        from gofr_tpu_torch.tpu.workload import TrafficRecorder

        self.engine = engine
        self.container = SimpleNamespace(tpu=engine)
        self.recorder = TrafficRecorder(metrics=metrics)
        self.store = TimeSeriesStore(metrics=metrics, interval_s=0.1,
                                     tick_sample=1, tick_capacity=4096)
        register_default_signals(self.store, slo=tracker, tpu=engine,
                                 container=self.container)
        self.budget = ErrorBudgetPlane(self.store, metrics)
        self.ladder = BrownoutLadder(engine.set_brownout, metrics=metrics)
        self.ladder.escalation_gate = self.budget.fast_burning
        self.watchdog = Watchdog(
            tracker, metrics=metrics, interval_s=0.2, brownout=self.ladder,
            anomaly_fn=self.store.watchdog_reasons,
            budget_fn=self.budget.watchdog_reasons,
            hbm_fn=lambda: hbm_occupancy(self.container))
        self.offenders = WorstOffenders(
            k=4, context_fn=lambda: build_window_context(
                engine=engine, store=self.store,
                xledger=engine.exec_ledger))

    def attach(self):
        engine = self.engine
        engine.attach_workload(self.recorder)
        engine.attach_telemetry(self.store, every=self.store.tick_sample)
        engine.recorder.offenders = self.offenders
        self.store.start()
        self.watchdog.start()

    async def detach(self):
        engine = self.engine
        engine.workload = engine.recorder.workload = None
        engine.telemetry = engine.recorder.offenders = None
        await self.store.stop()
        await self.watchdog.stop()


async def repeat_bursts(engine, prompts, budget, samplings, until):
    """Serve the burst again and again until ``until`` is set (at least
    once); returns each burst's outputs."""
    runs = []
    while not runs or not until.is_set():
        runs.append(await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, budget, sampling=s)
            for p, s in zip(prompts, samplings)]), 600))
    return runs


class SyncProbe:
    """A thread reading, as fast as it can, what the telemetry plane reads
    off the device thread (``hbm_occupancy``, the allocator's
    statistics): a capture's eager run sets the process-wide
    ``set_sync_debug_mode("error")``, under which a synchronizing read
    here would raise."""

    def __init__(self, torch, container):
        import threading

        from gofr_tpu_torch.hbmz import hbm_occupancy

        self.reads, self.errors = 0, []
        self._stop = threading.Event()

        def run():
            while not self._stop.is_set():
                try:
                    hbm_occupancy(container)
                    torch.cuda.memory_stats()
                    self.reads += 1
                except Exception as exc:  # noqa: BLE001 — reported
                    self.errors.append(repr(exc))
                time.sleep(0.0005)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()


async def prewarm_while_serving(torch, engine, point, prompts, budget,
                                samplings, clock, container):
    """Prewarm ``point`` on a started engine while its burst is served
    again and again: the bursts' outputs, the prewarm's answer, its
    seconds, the longest time between two ticks meanwhile, the ticks run
    meanwhile, the reserved bytes it added, the graphs it added (ticks,
    prefills) and the sync probe's reads and errors."""
    reserved0 = reserved_bytes(torch)
    graphs0 = engine.stats()["graphs"]
    until = asyncio.Event()
    serving = asyncio.ensure_future(repeat_bursts(engine, prompts, budget,
                                                  samplings, until))
    while not engine.active_slots:
        await asyncio.sleep(0.001)
    probe = SyncProbe(torch, container)
    t0 = time.monotonic()
    try:
        warm_out = await engine.prewarm_operating_point(point)
    finally:
        t1 = time.monotonic()
        until.set()
        probe.stop()
    bursts = await serving
    graphs1 = engine.stats()["graphs"]
    return dict(bursts=bursts, prewarm=warm_out, prewarm_s=t1 - t0,
                longest_tick_gap_s=clock.longest_gap(t0, t1),
                ticks_during=sum(1 for t, _ in clock.calls if t0 <= t <= t1),
                reserved_added=reserved_bytes(torch) - reserved0,
                graphs_added=(graphs1["captured"] - graphs0["captured"],
                              graphs1["prefill"]["captured"]
                              - graphs0["prefill"]["captured"]),
                probe_reads=probe.reads, probe_errors=probe.errors)


def check_prewarm(got, want, path):
    """A prewarm while serving: every burst's outputs are ``want``, the
    graphs it says it captured are the ones added, nothing synced."""
    if any(outs != want for outs in got["bursts"]):
        raise AssertionError(f"{path}: a burst served during the prewarm "
                             f"differs from the burst without one")
    if sum(got["graphs_added"]) != got["prewarm"]["compiled"] \
            or not got["prewarm"]["compiled"]:
        raise AssertionError(f"{path}: prewarm says {got['prewarm']}, the "
                             f"engine added {got['graphs_added']} graphs")
    if got["probe_errors"] or not got["probe_reads"]:
        raise AssertionError(f"{path}: reads beside the captures: "
                             f"{got['probe_reads']}, errors "
                             f"{got['probe_errors'][:2]}")


def check_moved(counters, launches, cfg, engine, ks, k, path):
    """A burst after an applied move: every tick and prefill a replay, no
    capture, rung ``k`` among the ticks, launches as counted."""
    ticks = counters["ticks"] + counters["spec_ticks"]
    if counters["replays"] != ticks or counters["lazy_captures"] \
            or counters["prefill_replays"] != counters["prefills"] \
            or counters["prefill_lazy"]:
        raise AssertionError(f"{path}: a tick or prefill after the move "
                             f"was not a replay: {counters}")
    if engine.serving_compiles(60.0):
        raise AssertionError(f"{path}: {engine.serving_compiles(60.0)} "
                             f"serving compiles")
    if k not in ks:
        raise AssertionError(f"{path}: no tick at rung {k} ({ks})")
    check_launches(launches, expected_launches(cfg, counters), path)


def phase_op_planes(torch, llama, generate, mods, params, seed, results):
    """Phase 31 on ``small`` (phase 20's weights) at the example's engine:
    (a) the app's planes, on against off; (b) the recorded trace replayed
    on a shadow clone; (c) an operating-point move prewarmed while the
    burst is served, applied, moved back, then ``slots_cap``. Returns
    launches by path."""
    from collections import Counter
    from types import SimpleNamespace

    from gofr_tpu_torch.metrics import Manager, register_engine_metrics
    from gofr_tpu_torch.slo import SLOTracker
    from gofr_tpu_torch.tpu import workload
    from gofr_tpu_torch.tpu.diagnose import PHASES
    from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder

    t_phase = time.monotonic()
    log("== phase 31a: the app's planes (traffic recorder, telemetry store "
        "at 0.1 s, error budget -> watchdog and brownout ladder, worst "
        "offenders) on the small preset at the example's engine, off and "
        "on in turns")
    cfg = llama.config("small", use_flash=True, n_layers=depth(params))
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    burst = list(zip(prompts, samplings))
    metrics = register_engine_metrics(Manager(logger=StrictLog()))
    tracker = SLOTracker(metrics)
    engine = generate.GenerationEngine(
        cfg, params, device="cuda", metrics=metrics, slo=tracker,
        recorder=FlightRecorder(), model_name="small", **SMALL_ENGINE)
    planes = Planes(engine, metrics, tracker)
    clock = TickClock(engine)
    recorded = Counter()          # prompt lengths the recorder was given

    async def serve(reqs, n_budget):
        if engine.workload is not None:
            recorded.update(len(p) for p, _ in reqs)
        return await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, n_budget, sampling=s) for p, s in reqs]), 600)

    async def counted():
        """The burst with the planes on, counted; one sample of the store
        taken while it is queued, before the loop admits it."""
        await asyncio.sleep(0.05)         # the loop idles on its wake event
        for mod in mods:
            mod.reset_launches()
        before = run_counters(engine)
        snap0 = planes.recorder.snapshot()
        anatomy0 = planes.store.tick_anatomy()["recorded"]
        dispatched0 = engine.ticks + engine.spec_dispatches
        engine.ttfts.clear()
        recorded.update(len(p) for p in prompts)
        t0 = time.monotonic()
        tasks = [asyncio.ensure_future(engine.generate(p, budget,
                                                       sampling=s))
                 for p, s in burst]
        await asyncio.sleep(0)
        queued = planes.store.sample()
        outs = await asyncio.wait_for(asyncio.gather(*tasks), 600)
        wall = time.monotonic() - t0
        launches = read_launches(mods)
        after = run_counters(engine)
        await asyncio.sleep(0.25)         # the sampler reads the idle engine
        snap1 = planes.recorder.snapshot()
        return dict(
            outs=outs, wall=wall, ttfts=sorted(engine.ttfts),
            launches=launches, queued=queued,
            counters={k: after[k] - before[k] for k in after},
            admitted=snap1["admitted_total"] - snap0["admitted_total"],
            finished=snap1["finished_total"] - snap0["finished_total"],
            prompt_len=snap1["prompt_len"]["histogram"],
            anatomy=planes.store.tick_anatomy()["recorded"] - anatomy0,
            dispatched=engine.ticks + engine.spec_dispatches - dispatched0)

    async def main():
        out = {}
        await warm(engine)
        torch.cuda.synchronize()
        await engine.start()
        try:
            planes.attach()
            await serve(burst[:1], 8)
            # (a) two pairs in turns, planes off then on; the second pair's
            # "on" burst is counted
            out["pairs"] = []
            for turn in range(2):
                await planes.detach()
                off = await timed_burst(torch, engine, prompts, budget,
                                        samplings, 600)
                planes.attach()
                if turn == 0:
                    recorded.update(len(p) for p in prompts)
                    on = await timed_burst(torch, engine, prompts, budget,
                                           samplings, 600)
                    on = dict(outs=on[0], wall=on[1], ttfts=on[2])
                else:
                    on = await counted()
                out["pairs"].append((dict(outs=off[0], wall=off[1],
                                          ttfts=off[2]), on))
            out["distribution"] = \
                planes.recorder.prompt_length_distribution("small")
            out["recorded"] = Counter(recorded)
            out["watchdog"] = (planes.watchdog.evaluate(),
                               list(planes.watchdog._last_reasons))
            out["budgets"] = planes.budget.statusz()["budgets"]
            out["offenders"] = planes.offenders.snapshot()
            out["xlaz"] = engine.xlaz()["models"]["prompt"]
            out["signals_a"] = planes.store.series("1s")["series"]
            # (b) the recorded trace, twice through a shadow clone at a
            # candidate point
            trace = workload.load_trace(json.dumps(
                planes.recorder.export_trace()))
            reserved0 = reserved_bytes(torch)
            shadow = engine.shadow_clone(SimpleNamespace(
                prompt_buckets=(32, 128, 512), steps_per_tick=8))
            out["shared"] = [a.data_ptr() == b.data_ptr() for a, b in zip(
                _leaves(shadow.params), _leaves(engine.params))]
            out["hookless"] = [getattr(shadow, name) is None for name in (
                "metrics", "tracer", "slo", "telemetry", "workload")]
            await shadow.start()
            try:
                out["replays"] = [await asyncio.wait_for(
                    workload.replay_trace(shadow, trace, time_scale=0.0),
                    600) for _ in range(2)]
            finally:
                await shadow.stop()
            out["trace_events"] = len(trace.events)
            out["shadow_graphs"] = shadow.stats()["graphs"]["captured"]
            out["shadow_bytes"] = reserved_bytes(torch) - reserved0
            del shadow
            # the loop's pending callbacks of the clone's tasks hold it
            # until the loop runs them
            await asyncio.sleep(0.05)
            out["shadow_bytes_left"] = reserved_bytes(torch) - reserved0
            # (c) the move: refused before its prewarm, prewarmed while
            # the burst is served, applied, served, moved back; slots_cap
            point = SimpleNamespace(**OP_MOVE)
            try:
                engine.apply_operating_point(point)
                out["refused"] = None
            except RuntimeError as exc:
                out["refused"] = str(exc)
            out["prewarm"] = await prewarm_while_serving(
                torch, engine, point, prompts, budget, samplings, clock,
                planes.container)
            out["applied"] = engine.apply_operating_point(point)
            out["xlaz_point"] = engine.xlaz()["operating_point"]
            reqs = burst + [(prompts[-1][:OP_NEW_BUCKET_LEN],
                             generate.Sampling())]
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            calls0 = len(clock.calls)
            t0 = time.monotonic()
            out["moved"] = await serve(reqs, OP_MOVED_BUDGET)
            out["moved_wall"] = time.monotonic() - t0
            out["moved_launches"] = read_launches(mods)
            after = run_counters(engine)
            out["moved_counters"] = {k: after[k] - before[k] for k in after}
            out["moved_ks"] = clock.ks_since(calls0)
            graphs0 = engine.stats()["graphs"]
            out["seed_applied"] = engine.apply_operating_point(
                SimpleNamespace(**OP_SEED), source="rollback")
            out["seed_outs"] = await serve(burst, budget)
            graphs1 = engine.stats()["graphs"]
            out["seed_captures"] = (
                graphs1["captured"] - graphs0["captured"],
                graphs1["prefill"]["captured"]
                - graphs0["prefill"]["captured"],
                graphs1["lazy_captures"] - graphs0["lazy_captures"])
            engine.apply_operating_point(SimpleNamespace(slots_cap=2))
            active = []
            publish = engine._publish

            def watched(entry, host):
                publish(entry, host)
                active.append(engine.active_slots)
            engine._publish = watched
            try:
                out["capped"] = await serve(burst, budget)
            finally:
                engine._publish = publish
            out["capped_active_max"] = max(active)
            await asyncio.sleep(0.25)
            out["signals"] = planes.store.series("1s")["series"]
            out["signal_names"] = planes.store.signals()
            return out
        finally:
            await planes.detach()
            await engine.stop()

    out = asyncio.run(main())
    by_path = {}
    # (a)
    counted_run = out["pairs"][1][1]
    c = counted_run["counters"]
    ticks = c["ticks"] + c["spec_ticks"]
    if c["replays"] != ticks or c["lazy_captures"] \
            or c["prefill_replays"] != c["prefills"] or c["prefill_lazy"]:
        raise AssertionError(f"planes: a tick or prefill of the counted "
                             f"burst was not a replay: {c}")
    check_launches(counted_run["launches"], expected_launches(cfg, c),
                   "planes_small")
    by_path["planes_small"] = counted_run["launches"]
    want = out["pairs"][0][0]["outs"]
    if any(run["outs"] != want for pair in out["pairs"] for run in pair):
        raise AssertionError("planes: tokens differ with the planes on "
                             "and off")
    if (counted_run["admitted"], counted_run["finished"]) != (8, 8):
        raise AssertionError(f"planes: the recorder counted "
                             f"{counted_run['admitted']} admitted and "
                             f"{counted_run['finished']} finished of 8")
    admitted = out["recorded"]
    if out["distribution"] != dict(admitted) or counted_run["prompt_len"] \
            != workload._histogram(list(admitted.elements()),
                                   workload._LEN_EDGES):
        raise AssertionError(f"planes: prompt lengths recorded "
                             f"{out['distribution']}, admitted "
                             f"{dict(admitted)}")
    if counted_run["anatomy"] != counted_run["dispatched"]:
        raise AssertionError(f"planes: {counted_run['anatomy']} anatomy "
                             f"entries for {counted_run['dispatched']} ticks")
    if counted_run["queued"].get("queue_depth") != len(prompts):
        raise AssertionError(f"planes: queue_depth read "
                             f"{counted_run['queued'].get('queue_depth')} "
                             f"with the burst queued")
    # the dense engine has no pool: its kv_* signals never read
    silent = [name for name in out["signal_names"]
              if not name.startswith("kv_")
              and all(v is None for v in out["signals"][name])]
    if silent:
        raise AssertionError(f"planes: signals with no sample: {silent}")
    if not any(v for v in out["signals"]["queue_depth"] if v is not None):
        raise AssertionError("planes: the sampler never read a queue")
    entries = [e for w in out["offenders"]["windows"] for e in w["entries"]]
    if not entries or any(len(w["entries"]) > out["offenders"]["k"]
                          for w in out["offenders"]["windows"]) \
            or any(e["dominant_phase"] not in PHASES for e in entries):
        raise AssertionError(f"planes: offender ring {out['offenders']}")
    if out["xlaz"]["ladder_source"] != "workload_trace":
        raise AssertionError(f"planes: xlaz ladder from "
                             f"{out['xlaz']['ladder_source']}")
    if planes.ladder.level or not out["budgets"] \
            or any(b["burning"] for b in out["budgets"]):
        raise AssertionError(f"planes: brownout level "
                             f"{planes.ladder.level}, budgets "
                             f"{out['budgets']}")
    # (b)
    digests = [r["digest"] for r in out["replays"]]
    if digests[0] != digests[1] or out["replays"][0]["errors"]:
        raise AssertionError(f"shadow replay: digests {digests}, "
                             f"{out['replays'][0]['errors']} errors")
    if not all(out["shared"]) or not all(out["hookless"]):
        raise AssertionError(f"shadow clone: weights shared "
                             f"{out['shared']}, no hooks {out['hookless']}")
    # (c)
    if not out["refused"] or "was not prewarmed" not in out["refused"]:
        raise AssertionError(f"op move applied before its prewarm: "
                             f"{out['refused']}")
    check_prewarm(out["prewarm"], want, "op_small")
    point = out["xlaz_point"]
    if (point["generation"], point["source"]) != (1, "autotune") \
            or point["prompt_buckets"] != list(OP_MOVE["prompt_buckets"]):
        raise AssertionError(f"op move: xlaz operating point {point}")
    if any(len(o) != OP_MOVED_BUDGET for o in out["moved"]):
        raise AssertionError("op move: a request after the move was short")
    check_moved(out["moved_counters"], out["moved_launches"], cfg, engine,
                out["moved_ks"], OP_MOVE["steps_per_tick"], "op_small")
    by_path["op_small"] = out["moved_launches"]
    if any(out["seed_captures"]) or out["seed_outs"] != want:
        raise AssertionError(f"op move back: captures "
                             f"{out['seed_captures']}, tokens equal "
                             f"{out['seed_outs'] == want}")
    if out["capped_active_max"] > 2 or out["capped"] != want:
        raise AssertionError(f"slots_cap 2: {out['capped_active_max']} "
                             f"slots active at most, tokens equal "
                             f"{out['capped'] == want}")
    tokens = budget * len(prompts)
    pairs = [dict(tokens_per_s_off=tokens / off["wall"],
                  tokens_per_s_on=tokens / on["wall"],
                  ttft_p50_off=median(off["ttfts"]),
                  ttft_p50_on=median(on["ttfts"]))
             for off, on in out["pairs"]]
    pw = out["prewarm"]
    row = dict(
        pairs=pairs, queued_sample=counted_run["queued"],
        recorder_counted=(counted_run["admitted"], counted_run["finished"]),
        anatomy_entries=counted_run["anatomy"], watchdog=out["watchdog"],
        budgets=out["budgets"], offenders=out["offenders"],
        xlaz_prompt=out["xlaz"], trace_events=out["trace_events"],
        replay=out["replays"][0], shadow_graphs=out["shadow_graphs"],
        shadow_reserved_bytes=out["shadow_bytes"],
        shadow_reserved_left=out["shadow_bytes_left"], refused=out["refused"],
        prewarm={k: v for k, v in pw.items() if k != "bursts"},
        prewarm_bursts=len(pw["bursts"]), operating_point=point,
        moved_tokens_per_s=len(out["moved"]) * OP_MOVED_BUDGET
        / out["moved_wall"], moved_ks=out["moved_ks"],
        moved_counters=out["moved_counters"],
        capped_active_max=out["capped_active_max"],
        phase_s=time.monotonic() - t_phase)
    results["op_planes_small"] = row
    for i, p in enumerate(pairs):
        log(f"planes pair {i}: tok/s off {p['tokens_per_s_off']:.1f} on "
            f"{p['tokens_per_s_on']:.1f}; TTFT p50 off "
            f"{p['ttft_p50_off']:.4f}s on {p['ttft_p50_on']:.4f}s")
    log(f"planes: recorder 8/8, queue_depth {len(prompts)} queued, "
        f"{counted_run['anatomy']} anatomy entries for as many ticks, "
        f"watchdog {out['watchdog'][0]}, {len(entries)} offenders "
        f"(dominant {sorted({e['dominant_phase'] for e in entries})}), "
        f"ladder from {out['xlaz']['ladder_source']} "
        f"{out['xlaz']['suggested_ladder']}")
    log(f"== phase 31b: {out['trace_events']} recorded events replayed "
        f"twice on a shadow clone (k 8): digest {digests[0]} both times, "
        f"{out['replays'][0]['admitted_tokens']} tokens; weights shared; "
        f"clone {out['shadow_graphs']} tick graphs, +{out['shadow_bytes']} "
        f"reserved bytes ({out['shadow_bytes_left']} left once deleted)")
    log(f"== phase 31c: move to {OP_MOVE}: refused before its prewarm; "
        f"prewarm {pw['prewarm']['compiled']} graphs (ticks, prefills "
        f"{pw['graphs_added']}) in {pw['prewarm_s']:.2f}s while "
        f"{len(pw['bursts'])} bursts were served ({pw['ticks_during']} "
        f"ticks, longest gap {pw['longest_tick_gap_s']:.3f}s), "
        f"+{pw['reserved_added']} reserved bytes, {pw['probe_reads']} "
        f"reads beside it; after apply {row['moved_tokens_per_s']:.1f} "
        f"tok/s at {OP_MOVED_BUDGET} tokens, ticks at k {out['moved_ks']}, "
        f"no capture; back to the seed: nothing captured; slots_cap 2: "
        f"{out['capped_active_max']} active at most, tokens equal; "
        f"{row['phase_s']:.1f}s")
    del engine
    torch.cuda.empty_cache()
    return by_path


def phase_op_llama3(torch, generate, mods, cfg, params, seed, results):
    """Phase 31d: the dense bf16 ``llama3-8b`` engine of phase 15 prewarms
    ``steps_per_tick`` 8 while phase 15's burst is served (its greedy
    completions must be phase 15's), applies it and serves the burst
    again (no capture, launches as counted). Returns launches by path."""
    from types import SimpleNamespace

    t_phase = time.monotonic()
    log("== phase 31d: llama3-8b dense bf16: prewarm steps_per_tick 8 while "
        "serving, apply, serve")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine = generate.GenerationEngine(
        cfg, params, max_slots=8, max_len=2048,
        prompt_buckets=(32, 128, 512), steps_per_tick=4, device="cuda")
    clock = TickClock(engine)
    want = results["dense"]["greedy_outputs"]

    async def main():
        out = {}
        await warm(engine)
        torch.cuda.synchronize()
        await engine.start()
        try:
            await engine.generate(prompts[0], 8)
            k4 = await timed_burst(torch, engine, prompts, budget, samplings,
                                   600)
            out["k4"] = dict(outs=k4[0], wall=k4[1])
            out["prewarm"] = await prewarm_while_serving(
                torch, engine, SimpleNamespace(steps_per_tick=8), prompts,
                budget, samplings, clock, SimpleNamespace(tpu=engine))
            engine.apply_operating_point(SimpleNamespace(steps_per_tick=8))
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            calls0 = len(clock.calls)
            k8 = await timed_burst(torch, engine, prompts, budget, samplings,
                                   600)
            out["k8"] = dict(outs=k8[0], wall=k8[1])
            out["launches"] = read_launches(mods)
            after = run_counters(engine)
            out["counters"] = {k: after[k] - before[k] for k in after}
            out["ks"] = clock.ks_since(calls0)
            return out
        finally:
            await engine.stop()

    out = asyncio.run(main())
    if out["k4"]["outs"][:7] != want:
        raise AssertionError("op llama3: the burst before the move differs "
                             "from phase 15's")
    check_prewarm(out["prewarm"], out["k4"]["outs"], "op_llama3")
    check_moved(out["counters"], out["launches"], cfg, engine, out["ks"], 8,
                "op_llama3")
    tokens = budget * len(prompts)
    pw = out["prewarm"]
    row = dict(tokens_per_s_k4=tokens / out["k4"]["wall"],
               tokens_per_s_k8=tokens / out["k8"]["wall"],
               k8_greedy_equal=out["k8"]["outs"][:7] == want,
               prewarm={k: v for k, v in pw.items() if k != "bursts"},
               prewarm_bursts=len(pw["bursts"]), ks=out["ks"],
               counters=out["counters"], phase_s=time.monotonic() - t_phase)
    results["op_llama3"] = row
    log(f"op llama3-8b: tok/s k 4 {row['tokens_per_s_k4']:.1f}, k 8 "
        f"{row['tokens_per_s_k8']:.1f} (greedy equal to k 4: "
        f"{row['k8_greedy_equal']}); prewarm {pw['prewarm']['compiled']} "
        f"graphs in {pw['prewarm_s']:.2f}s while {len(pw['bursts'])} bursts "
        f"were served (longest tick gap {pw['longest_tick_gap_s']:.3f}s), "
        f"+{pw['reserved_added']} reserved bytes; {row['phase_s']:.1f}s")
    del engine
    torch.cuda.empty_cache()
    return {"op_llama3": out["launches"]}


# shared-prefix traffic (phase 24): one 256-token system prompt (8 pages
# of 32) before every prompt, then a distinct suffix
SYSTEM_TOKENS, PREFIX_RUNG = 256, 8
SUFFIX_LENS = (5, 17, 40, 64, 100, 129, 170, 200)


def prefix_waves(cfg, seed):
    """Two waves of 8 prompts: the same system prompt, each prompt its own
    suffix (wave 2's new ones)."""
    import numpy as np

    rng = np.random.default_rng(seed + 24)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_TOKENS).tolist()
    return [[system + rng.integers(0, cfg.vocab_size, n).tolist()
             for n in SUFFIX_LENS] for _ in range(2)]


# two rounds of the two waves, each round with its own system prompt: the
# first warms the suffix prefill's shapes (the prefill runs eagerly), the
# second is measured
PREFIX_ROUNDS = 2


def prefix_run(torch, generate, mods, cfg, params, engine_kw, prefix, seed):
    """Serve the rounds of two waves on one engine (captured ticks; wave 1
    to completion, then wave 2) with the prefix store on or off. Returns
    every wave's outputs, the last wave 2's TTFTs, prefill stream spans
    (CUDA events around each prefill dispatch on the device thread) and
    store stats, and the launches of all the waves."""
    rounds = [prefix_waves(cfg, seed + r) for r in range(PREFIX_ROUNDS)]
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine = generate.GenerationEngine(cfg, params, device="cuda",
                                       prefix_cache=prefix, **engine_kw)
    spans = []
    prefill = engine._prefill_insert

    def timed_prefill(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fetch = prefill(*args)
        end.record()
        spans.append((start, end))
        return fetch
    engine._prefill_insert = timed_prefill

    async def serve():
        await warm(engine)
        await engine.start()
        try:
            # warm-up: a prompt under one page publishes and reuses nothing
            await engine.generate(rounds[0][0][0][:5], 8)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            outs = []
            for waves in rounds:
                if waves is rounds[-1]:
                    last0 = run_counters(engine)
                for wave in waves:
                    if wave is rounds[-1][1]:
                        torch.cuda.synchronize()
                        engine.ttfts.clear()
                        spans.clear()
                        store0 = engine.stats().get("prefix_cache")
                        suffix0 = engine.suffix_prefill_dispatches
                    outs.append(await asyncio.wait_for(asyncio.gather(*[
                        engine.generate(p, 32, sampling=s)
                        for p, s in zip(wave, samplings)]), 600))
            torch.cuda.synchronize()
            launches = read_launches(mods)
            after = run_counters(engine)
            counters = {key: after[key] - before[key] for key in after}
            last = {key: after[key] - last0[key] for key in after}
            store = engine.stats().get("prefix_cache")
            delta = None
            if store is not None:
                delta = dict(
                    hits=store["lookups"]["hit"] - store0["lookups"]["hit"],
                    partial=(store["lookups"]["partial"]
                             - store0["lookups"]["partial"]),
                    misses=store["lookups"]["miss"]
                    - store0["lookups"]["miss"],
                    tokens_saved=store["tokens_saved"]
                    - store0["tokens_saved"],
                    admissions_by_rung={
                        r: n - store0["admissions_by_rung"].get(r, 0)
                        for r, n in store["admissions_by_rung"].items()
                        if n > store0["admissions_by_rung"].get(r, 0)},
                    suffix_prefills=engine.suffix_prefill_dispatches
                    - suffix0)
            return dict(outs=outs, ttfts=sorted(engine.ttfts),
                        prefill_ms=sum(a.elapsed_time(b) for a, b in spans),
                        prefills=len(spans), store=store, wave2=delta,
                        launches=launches, counters=counters,
                        last_round=last,
                        prefill_graphs=engine.stats()["graphs"]["prefill"])
        finally:
            await engine.stop()

    got = asyncio.run(serve())
    del engine
    torch.cuda.empty_cache()
    return got


def first_difference(torch, llama, cfg, params, prompt, want, got):
    """Where two greedy completions of ``prompt`` part, and the top-2
    logit margin of the full forward (flash prefill) at that position."""
    at = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    tokens = torch.tensor([prompt + want[:at]],
                          device=params["tok_emb"].device)
    logits = llama.forward(params, cfg, tokens)[0, -1].float()
    top = torch.topk(logits, 2).values
    return dict(position=at, margin=(top[0] - top[1]).item(),
                tokens=(want[at], got[at]))


def phase_prefix(torch, llama, generate, mods, cfg, params, engine_kw, path,
                 seed, results):
    """Phase 24, one configuration: the rounds of two waves with the store
    on and off. The measured wave 2 must admit all 8 at rung 8 (the
    system prompt's pages); with a bf16 cache every wave 2's greedy tokens
    must equal the store-off engine's. Returns the store-on run's
    launches."""
    log(f"== phase 24: {path}: prefix reuse, {cfg.n_layers} layers, "
        f"{'kv_int8' if cfg.kv_int8 else 'bf16'}, "
        f"{'paged' if engine_kw.get('paged_kv') else 'dense'}: two waves "
        f"of 8 (a {SYSTEM_TOKENS}-token system prompt + suffixes "
        f"{SUFFIX_LENS}), 32 new tokens, one sampled")
    on = prefix_run(torch, generate, mods, cfg, params, engine_kw, True,
                    seed)
    off = prefix_run(torch, generate, mods, cfg, params, engine_kw, False,
                     seed)
    for run in (on, off):
        check_launches(run["launches"],
                       expected_launches(cfg, run["counters"]), path)
    wave2 = on["wave2"]
    hits_ok = wave2["admissions_by_rung"] == {PREFIX_RUNG: 8}
    # the second round's prefills, its suffix prefills included, replay
    # graphs the first round captured
    for name, run in (("on", on), ("off", off)):
        last = run["last_round"]
        if last["prefill_lazy"] or last["prefill_replays"] \
                != last["prefills"] or (name == "on"
                                        and not last["suffix_prefills"]):
            raise AssertionError(
                f"{path} store {name}: the second round made "
                f"{last['prefill_lazy']} prefill captures and "
                f"{last['prefill_replays']} replays for {last['prefills']} "
                f"prefills ({last['suffix_prefills']} suffix)")
    same, diffs = [], []
    for r in range(PREFIX_ROUNDS):
        wave = 2 * r + 1
        for i in range(7):
            same.append(on["outs"][wave][i] == off["outs"][wave][i])
            if not same[-1]:
                diffs.append(dict(first_difference(
                    torch, llama, cfg, params,
                    prefix_waves(cfg, seed + r)[1][i], off["outs"][wave][i],
                    on["outs"][wave][i]), round=r, request=i))
    ttft = {name: dict(p50=run["ttfts"][len(run["ttfts"]) // 2],
                       max=run["ttfts"][-1], prefill_ms=run["prefill_ms"],
                       prefills=run["prefills"])
            for name, run in (("on", on), ("off", off))}
    results[path] = dict(wave2=wave2, greedy_identical=same,
                         first_differences=diffs, ttft=ttft,
                         store=on["store"], launches=on["launches"],
                         counters=on["counters"],
                         last_round=on["last_round"],
                         prefill_graphs=on["prefill_graphs"],
                         launches_off=off["launches"])
    log(f"{path}: wave 2 admissions by prefix rung "
        f"{wave2['admissions_by_rung']} (lookups: {wave2['hits']} hit, "
        f"{wave2['partial']} partial, {wave2['misses']} miss; "
        f"{wave2['tokens_saved']} prompt tokens saved; "
        f"{wave2['suffix_prefills']} suffix prefills); wave 2's greedy "
        f"tokens equal to store off: {sum(same)}/{len(same)} "
        f"{diffs or ''}; wave 2 TTFT p50 "
        f"{ttft['on']['p50']:.4f}s max {ttft['on']['max']:.4f}s with the "
        f"store, {ttft['off']['p50']:.4f}s / {ttft['off']['max']:.4f}s "
        f"without; prefill stream {ttft['on']['prefill_ms']:.3f} ms in "
        f"{ttft['on']['prefills']} dispatches vs "
        f"{ttft['off']['prefill_ms']:.3f} ms in {ttft['off']['prefills']}; "
        f"the second round's {on['last_round']['prefills']} prefills "
        f"({on['last_round']['suffix_prefills']} suffix) all replays, the "
        f"suffix rungs captured in the first ("
        f"{on['prefill_graphs']['by_kind']}); launches {on['launches']}")
    if not hits_ok:
        raise AssertionError(f"{path}: wave 2 admitted by rung "
                             f"{wave2['admissions_by_rung']}, expected 8 at "
                             f"rung {PREFIX_RUNG}")
    if not cfg.kv_int8 and not all(same):
        raise AssertionError(f"{path}: wave 2's greedy tokens differ with "
                             f"the store on: {diffs}")
    return on["launches"]


# -- phases 26-27: how the engine admits and steers requests ---------------

# the example app's generation model (examples/llama-generate/main.py:124):
# ``small`` over its byte-level tokenizer's 256 ids
EXAMPLE_VOCAB = 256
YES_NO = {"type": "regex", "pattern": "(yes|no)!"}
OK_SCHEMA = {"type": "json_schema",
             "json_schema": {"type": "object",
                             "properties": {"ok": {"type": "boolean"}},
                             "required": ["ok"]}}
RECORD_SCHEMA = {"type": "json_schema",
                 "json_schema": {"type": "object",
                                 "properties": {"id": {"type": "integer"},
                                                "name": {"type": "string"}}}}
# phase 26's burst over phase 9's prompt lengths: (response_format,
# sampled) of each request; the first n_constrained of the four
# constrained ones are sent
BURST_FORMATS = [(YES_NO, False), (OK_SCHEMA, False), (RECORD_SCHEMA, False),
                 (YES_NO, True)]
BURST_BUDGETS = (32, 40, 48, 36, 44, 32, 40, 48)
PATH_KERNELS.update({"constrained_small": ("flash", "ragged"),
                     "constrained_small_paged": ("flash", "ragged"),
                     "constrained_llama3": ("flash", "ragged"),
                     "admission_spec": ("flash", "verify", "flash_decode"),
                     "admission_order": ("flash", "ragged")})


def with_captures(counters, keys):
    """``counters`` plus the eager run each graph capture of ``keys``
    makes before it captures (a real launch of the tick's kernels, with
    every slot inactive): a plain or bias rung's k decode steps, a spec
    rung's verify and g + 1 draft steps."""
    counters = dict(counters)
    for kind, n, _, _ in keys:
        if kind == "spec":
            counters["spec_ticks"] += 1
            counters["draft_steps"] += n + 1
        else:
            counters["steps"] += n
    return counters


def burst_requests(generate, cfg, seed, n_constrained):
    """Phase 26's 8 requests, (prompt, budget, sampling, response_format):
    the first ``n_constrained`` constrained (greedy but for the seeded
    sampled regex), the rest unconstrained, the last of them sampled."""
    reqs = []
    for i, prompt in enumerate(engine_prompts(cfg, seed)):
        rf, sampled = (BURST_FORMATS[i] if i < n_constrained
                       else (None, i == 7))
        sampling = (generate.Sampling(temperature=0.8, top_p=0.95,
                                      seed=seed + i) if sampled
                    else generate.Sampling())
        reqs.append((prompt, BURST_BUDGETS[i], sampling, rf))
    return reqs


async def serve_requests(engine, reqs, timeout=600):
    t0 = time.monotonic()
    outs = await asyncio.wait_for(asyncio.gather(*[
        engine.generate(p, n, sampling=s, response_format=rf)
        for p, n, s, rf in reqs]), timeout)
    return outs, time.monotonic() - t0


def check_grammar(constrain, table, rf, tokens, what):
    """The tokens walk the grammar with no violation; a walk that reached
    ``must_stop`` is a full match. Returns whether it completed."""
    grammar = constrain.GrammarCache(table).get(rf, None)
    walker = constrain.GrammarWalker(grammar)
    for token in tokens:
        if walker.must_stop or not walker.advance(token):
            raise AssertionError(f"{what}: {tokens} leaves its grammar "
                                 f"{rf} at token {token}")
    if walker.must_stop and not grammar.fullmatch(tokens):
        raise AssertionError(f"{what}: {tokens} stopped short of a match")
    return walker.must_stop


def phase_constrained(torch, generate, constrain, mods, cfg, params,
                      engine_kw, path, seed, results, n_constrained,
                      warm_first=True, paged_check=False):
    """Phase 26, one engine: the mixed burst once to capture the biased
    rungs (their seconds reported), then counted: every constrained
    output walks its grammar, every tick replays a graph, each "bias"
    graph is k = 1, the launches are what the counters predict; then the
    all-unconstrained burst, whose unconstrained requests must give the
    mixed burst's tokens. With ``paged_check`` a paged engine (page 32)
    serves the mixed burst and its greedy constrained outputs must be the
    dense engine's. Returns launches by path."""
    t_phase = time.monotonic()
    table = constrain.token_byte_table(vocab_size=cfg.vocab_size)
    mixed = burst_requests(generate, cfg, seed, n_constrained)
    plain = [(p, n, s, None) for p, n, s, _ in mixed]
    log(f"== phase 26: {path}: constrained decoding, {cfg.n_layers} layers, "
        f"dim {cfg.dim}, vocab {cfg.vocab_size}, engine {engine_kw}: "
        f"{n_constrained} of 8 requests constrained")
    engine = generate.GenerationEngine(cfg, params, device="cuda",
                                       token_table=table, **engine_kw)
    by_path = {}

    async def run():
        t0 = time.monotonic()
        if warm_first:
            await warm(engine)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        await engine.start()
        try:
            await engine.generate(mixed[0][0], 8)
            lazy0 = engine.lazy_captures
            await serve_requests(engine, mixed)
            graphs = engine.stats()["graphs"]
            bias_capture = dict(
                seconds=graphs["capture_s_by_kind"].get("bias", 0.0),
                lazy_captures=engine.lazy_captures - lazy0)
            # earlier phases' garbage is slow to collect: not inside the
            # measured bursts
            gc.collect()
            for mod in mods:
                mod.reset_launches()
            before, keys = run_counters(engine), set(engine._graphs)
            ticks0 = engine.stats()["constrained"]["ticks"]
            engine.ttfts.clear()
            outs, wall = await serve_requests(engine, mixed)
            launches = read_launches(mods)
            after = run_counters(engine)
            counters = {key: after[key] - before[key] for key in after}
            counters["captured"] = [list(key) for key in engine._graphs
                                    if key not in keys]
            counters["biased_ticks"] = \
                engine.stats()["constrained"]["ticks"] - ticks0
            ttfts = sorted(engine.ttfts)
            engine.ttfts.clear()
            gc.collect()
            outs_plain, wall_plain = await serve_requests(engine, plain)
            ttfts_plain = sorted(engine.ttfts)
            return (warm_s, bias_capture, outs, wall, launches, counters,
                    ttfts, outs_plain, wall_plain, ttfts_plain)
        finally:
            await engine.stop()

    (warm_s, bias_capture, outs, wall, launches, counters, ttfts,
     outs_plain, wall_plain, ttfts_plain) = asyncio.run(run())
    complete = [check_grammar(constrain, table, rf, out, path)
                for (_, _, _, rf), out in zip(mixed, outs) if rf is not None]
    if outs[n_constrained:] != outs_plain[n_constrained:]:
        raise AssertionError(f"{path}: unconstrained outputs differ with "
                             f"constrained neighbours")
    ticks = counters["ticks"] + counters["spec_ticks"]
    bias_keys = [key for key in engine._graphs if key[0] == "bias"]
    if counters["replays"] != ticks or not counters["biased_ticks"] \
            or not bias_keys or any(key[1] != 1 for key in bias_keys):
        raise AssertionError(
            f"{path}: {counters['replays']} replays for {ticks} ticks, "
            f"{counters['biased_ticks']} biased ticks, bias graphs "
            f"{bias_keys}: every tick must replay a graph, every bias "
            f"graph k = 1")
    check_launches(launches, expected_launches(
        cfg, with_captures(counters, counters["captured"])), path)
    by_path[path] = launches
    tokens = sum(len(o) for o in outs)
    tokens_plain = sum(len(o) for o in outs_plain)
    row = dict(n_layers=cfg.n_layers, vocab=cfg.vocab_size,
               n_constrained=n_constrained, warmup_s=warm_s,
               bias_capture=bias_capture, bias_graphs=len(bias_keys),
               bias_bytes_per_tick=engine.max_slots * cfg.vocab_size * 4,
               new_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               ttft_p50_s=ttfts[len(ttfts) // 2], ttft_s=ttfts,
               unconstrained=dict(new_tokens=tokens_plain, wall_s=wall_plain,
                                  tokens_per_s=tokens_plain / wall_plain,
                                  ttft_p50_s=ttfts_plain[
                                      len(ttfts_plain) // 2]),
               counters=counters, launches=launches,
               constrained_outputs=outs[:n_constrained],
               grammar_complete=complete,
               grammar_cache=engine.stats()["constrained"]["grammar_cache"])
    log(f"{path}: mixed burst {tokens} tokens in {wall:.4f}s = "
        f"{row['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{row['ttft_p50_s']:.4f}s; all-unconstrained {tokens_plain} tokens "
        f"in {wall_plain:.4f}s = {row['unconstrained']['tokens_per_s']:.1f} "
        f"tok/s, TTFT p50 {row['unconstrained']['ttft_p50_s']:.4f}s; "
        f"{counters['biased_ticks']} biased ticks of {counters['ticks']}, "
        f"{row['bias_bytes_per_tick']} bias bytes a tick; {len(bias_keys)} "
        f"bias graphs (k 1) captured in {bias_capture['seconds']:.3f}s (the "
        f"first burst's lazy captures: {bias_capture['lazy_captures']}); "
        f"grammars complete "
        f"{complete}; constrained outputs {outs[:n_constrained]}; launches "
        f"{launches}")
    del engine
    torch.cuda.empty_cache()
    if paged_check:
        engine = generate.GenerationEngine(
            cfg, params, device="cuda", token_table=table,
            **dict(engine_kw, paged_kv=True, kv_page=32))

        async def run_paged():
            await engine.start()
            try:
                await engine.generate(mixed[0][0], 8)
                for mod in mods:
                    mod.reset_launches()
                before, keys = run_counters(engine), set(engine._graphs)
                got, _ = await serve_requests(engine, mixed)
                after = run_counters(engine)
                return got, read_launches(mods), with_captures(
                    {key: after[key] - before[key] for key in after},
                    [key for key in engine._graphs if key not in keys])
            finally:
                await engine.stop()
        paged_outs, paged_launches, paged_counters = asyncio.run(run_paged())
        paged_path = path + "_paged"
        check_launches(paged_launches,
                       expected_launches(cfg, paged_counters), paged_path)
        by_path[paged_path] = paged_launches
        greedy = [i for i, (_, _, s, rf) in enumerate(mixed)
                  if rf is not None and s.greedy]
        same = [paged_outs[i] for i in greedy] == [outs[i] for i in greedy]
        row["paged_greedy_identical"] = same
        log(f"{paged_path}: greedy constrained outputs identical to the "
            f"dense engine's: {same}")
        if not same:
            raise AssertionError(f"{paged_path}: greedy constrained outputs "
                                 f"differ from the dense engine's")
        del engine
        torch.cuda.empty_cache()
    row["phase_s"] = time.monotonic() - t_phase
    results[path] = row
    log(f"phase 26 {path}: {row['phase_s']:.1f}s")
    return by_path


# a backlog queued before the loop runs: (prompt length, deadline budget
# in ms, None for batch); one bucket, so each admission pass is one group
# whose rows are the queue's pops in order
BACKLOG = [(5, None), (6, 1900.0), (7, 60_000.0), (8, None), (9, 1900.0),
           (10, 1900.0), (11, 60_000.0), (12, None), (13, 1900.0), (14, None)]


def phase_admission(torch, llama, generate, slo, sched, constrain, mods,
                    cfg, params, seed, results):
    """Phase 27: on the spec engine (2-layer draft of views, γ 4) brownout
    level 1 refuses batch and serves a 500 ms deadline, level 2
    dispatches rung 1 only, level 3 no spec tick, level 0 admits batch
    again, and a constrained request walks its grammar on k = 1 bias
    ticks; an expired deadline is shed with no prefill; with 2 slots a
    mixed-class backlog is admitted in ``ClassQueues``' order. Returns
    launches by path."""
    t_phase = time.monotonic()
    log("== phase 27: admission: brownout, deadlines and class order on the "
        "small spec engine (2-layer draft of views, gamma 4) and a 2-slot "
        "engine")
    prompts = engine_prompts(cfg, seed)[:4]
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    engine = generate.GenerationEngine(
        cfg, params, device="cuda", draft_cfg=dcfg, draft_params=dparams,
        spec_gamma=SPEC_GAMMA, **SMALL_ENGINE)
    for mod in mods:
        mod.reset_launches()
    row = {}

    def delta(before):
        return {g: n - before.get(g, 0) for g, n in engine.spec_rungs.items()
                if n > before.get(g, 0)}

    async def level_burst(level):
        engine.set_brownout(level)
        rungs, ticks = dict(engine.spec_rungs), engine.ticks
        cap = engine.stats()["speculative"]["gamma_cap"]
        slo.set_request_deadline(60_000.0)          # standard class
        try:
            await asyncio.gather(*[engine.generate(p, 24) for p in prompts])
        finally:
            slo.set_request_deadline(None)
        return dict(gamma_cap_before=cap, spec_ticks_by_gamma=delta(rungs),
                    plain_ticks=engine.ticks - ticks)

    async def run():
        await engine.start()
        try:
            await engine.generate(prompts[0], 8)
            engine.set_brownout(1)
            try:
                await engine.generate(prompts[1], 8)
                raise AssertionError("brownout 1 admitted a batch request")
            except generate.BrownoutShed:
                pass
            slo.set_request_deadline(500.0)
            try:
                served = await engine.generate(prompts[1], 8)
            finally:
                slo.set_request_deadline(None)
            row["level1"] = dict(batch_shed=True, deadline_500ms_tokens=len(
                served))
            row["level2"] = await level_burst(2)
            row["level3"] = await level_burst(3)
            row["level0"] = await level_burst(0)
            row["level0"]["batch_tokens"] = len(
                await engine.generate(prompts[2], 8))
            # a constrained request on the spec engine rides k = 1 bias
            # ticks
            row["spec_constrained"] = await engine.generate(
                prompts[3], 16, response_format=YES_NO)
            prefills = engine.prefill_dispatches
            slo.set_request_deadline(1.0, now=time.monotonic() - 1.0)
            try:
                await engine.generate(prompts[3], 8)
                raise AssertionError("an expired request was served")
            except slo.DeadlineExceeded:
                pass
            finally:
                slo.set_request_deadline(None)
            row["expired_prefills"] = engine.prefill_dispatches - prefills
        finally:
            await engine.stop()

    asyncio.run(run())
    check_grammar(constrain, constrain.token_byte_table(
        vocab_size=cfg.vocab_size), YES_NO, row["spec_constrained"],
        "admission_spec")
    launches = read_launches(mods)
    check_launches(launches, expected_launches(
        cfg, with_captures(run_counters(engine), engine._graphs), 2),
        "admission_spec")
    row["classes"] = engine.stats()["classes"]
    log(f"brownout: {row}")
    if row["level2"]["gamma_cap_before"] < 2 \
            or set(row["level2"]["spec_ticks_by_gamma"]) != {1} \
            or row["level3"]["spec_ticks_by_gamma"] \
            or not row["level3"]["plain_ticks"] \
            or not row["level0"]["spec_ticks_by_gamma"] \
            or row["expired_prefills"] or row["classes"]["shed"] != {
                "batch": 1}:
        raise AssertionError(f"admission: brownout or deadline checks "
                             f"failed: {row}")
    by_path = {"admission_spec": launches}
    del engine
    torch.cuda.empty_cache()

    engine = generate.GenerationEngine(
        cfg, params, device="cuda", max_slots=2, max_len=1024,
        steps_per_tick=1, max_inflight_ticks=2)
    order = []
    claim = engine._claim_group

    def recorded(p_rung, bucket, group, *rest):
        order.extend(len(req.prompt) for req, _ in group)
        return claim(p_rung, bucket, group, *rest)

    async def run_order():
        await engine.start()
        await engine.generate(list(range(1, 5)), 8)
        await engine.stop()
        for mod in mods:
            mod.reset_launches()
        before, keys = run_counters(engine), set(engine._graphs)
        engine._claim_group = recorded
        tasks = []
        try:
            for n, budget in BACKLOG:
                slo.set_request_deadline(budget)
                tasks.append(asyncio.ensure_future(
                    engine.generate(list(range(1, n + 1)), 8)))
            slo.set_request_deadline(None)
            await asyncio.sleep(0)
            await engine.start()
            await asyncio.wait_for(asyncio.gather(*tasks), 120)
        finally:
            slo.set_request_deadline(None)
            await engine.stop()
        after = run_counters(engine)
        return with_captures({key: after[key] - before[key] for key in after},
                             [key for key in engine._graphs
                              if key not in keys])

    counters = asyncio.run(run_order())
    queues = sched.ClassQueues()
    for n, budget in BACKLOG:
        queues.put_nowait(n, sched.deadline_class(
            None if budget is None else time.monotonic() + budget / 1000))
    want = [queues.get_nowait() for _ in BACKLOG]
    launches = read_launches(mods)
    check_launches(launches, expected_launches(cfg, counters),
                   "admission_order")
    by_path["admission_order"] = launches
    row["order"] = dict(admitted=order, class_queues=want,
                        served=engine.stats()["classes"]["served"])
    log(f"2-slot backlog admitted as {order} (prompt lengths); ClassQueues "
        f"gives {want}")
    if order != want:
        raise AssertionError("admission order differs from ClassQueues'")
    del engine
    torch.cuda.empty_cache()
    row["phase_s"] = time.monotonic() - t_phase
    results["admission"] = row
    log(f"phase 27: {row['phase_s']:.1f}s")
    return by_path


# -- phase 28: telemetry and the SLO control loop ------------------------------

PATH_KERNELS.update({"telemetry_small": ("flash", "ragged"),
                     "telemetry_faults": ("flash", "ragged"),
                     "telemetry_spec": ("flash", "verify", "flash_decode"),
                     "telemetry_llama3": ("flash", "ragged")})
TELEMETRY_PAIRS = 3


class StrictLog:
    """A logger for the metrics sink whose ``error`` raises: a name the
    catalog lacks, or a wrong kind, fails the phase instead of being
    logged."""

    def error(self, message, *args):
        raise AssertionError(message % args if args else message)

    def warning(self, *args):
        pass

    info = warning


class TickStore:
    """The list-backed telemetry store ``attach_telemetry`` feeds."""

    def __init__(self):
        self.ticks = []

    def note_tick(self, entry):
        self.ticks.append(entry)


def hooks(name):
    """Every hook the engine takes, of the port's own, for a model named
    ``name``: a metrics sink with the catalog registered, a tracer
    exporting into a list, an SLO tracker, a flight recorder. Returns the
    engine's keywords and the span list."""
    from gofr_tpu_torch.metrics import Manager, register_engine_metrics
    from gofr_tpu_torch.slo import SLOTracker
    from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
    from gofr_tpu_torch.trace import ListExporter, Tracer

    metrics = register_engine_metrics(Manager(logger=StrictLog()))
    exporter = ListExporter()
    return dict(metrics=metrics, tracer=Tracer(exporter=exporter),
                slo=SLOTracker(metrics), recorder=FlightRecorder(),
                model_name=name), exporter


async def traced_burst(engine, prompts, budget, samplings, tracer=None):
    """The burst, each request under its own span when ``tracer`` is
    given. Returns (outputs, wall seconds, sorted TTFTs, trace ids)."""
    import contextlib

    async def one(i, prompt, sampling):
        scope = (tracer.start_span(f"request-{i}") if tracer is not None
                 else contextlib.nullcontext())
        with scope as span:
            out = await engine.generate(prompt, budget, sampling=sampling)
        return out, span.trace_id if tracer is not None else None

    engine.ttfts.clear()
    t0 = time.monotonic()
    done = await asyncio.wait_for(asyncio.gather(*[
        one(i, p, s) for i, (p, s) in enumerate(zip(prompts, samplings))]),
        600)
    wall = time.monotonic() - t0
    return ([out for out, _ in done], wall, sorted(engine.ttfts),
            [trace for _, trace in done])


def check_spans(spans, bursts, path, others=()):
    """One ``queue.wait``, ``prefill`` and ``decode`` span a request, under
    its request span; every engine-step span links a request span.
    ``bursts``: each burst's trace ids, by request; ``others``: the trace
    ids of the engine's other requests (its warm-up)."""
    from collections import Counter

    ids = {trace_id for burst in bursts for trace_id in burst}
    ids.update(others)
    for burst in bursts:
        for i, trace_id in enumerate(burst):
            names = Counter(s.name for s in spans if s.trace_id == trace_id)
            want = Counter({f"request-{i}": 1, "queue.wait": 1,
                            "prefill": 1, "decode": 1})
            if names != want:
                raise AssertionError(f"{path}: request {i}'s spans {names}")
    steps = [s for s in spans if s.name.startswith("tpu.engine.")]
    bad = [s.name for s in steps
           if not any(link["trace_id"] in ids for link in s.links)]
    if not steps or bad:
        raise AssertionError(f"{path}: {len(steps)} engine-step spans, "
                             f"{len(bad)} linking no request: {bad[:4]}")
    return Counter(s.name for s in steps)


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


def phase_telemetry(torch, llama, generate, slo, faults, mods, seed,
                    results):
    """Phase 28: telemetry and the SLO control loop on ``small`` at the
    example's engine. Hooks on against off (3 pairs in turns), the span,
    counter, device-seconds, anatomy, memory, compile and view checks;
    ``nan_logits`` and ``tick_exception`` on the card; the watchdog and
    the brownout ladder on the spec engine. Returns launches by path."""
    t_phase = time.monotonic()
    log("== phase 28: telemetry and the SLO control loop on the small "
        "preset at the example's engine (hooks on against off, faults, "
        "watchdog and brownout ladder)")
    cfg = llama.config("small", use_flash=True, n_layers=CUT_SMALL_LAYERS)
    params = llama.init(cfg, seed + 4, device="cuda")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    kw, exporter = hooks("small")
    metrics, tracer, tracker = kw["metrics"], kw["tracer"], kw["slo"]
    bare = generate.GenerationEngine(cfg, params, device="cuda",
                                     **SMALL_ENGINE)
    hooked = generate.GenerationEngine(cfg, params, device="cuda",
                                       **SMALL_ENGINE, **kw)
    store = TickStore()
    hooked.attach_telemetry(store, every=1)
    row = {}
    by_path = {}

    def ttft_count():
        return metrics.value("app_tpu_ttft", model=hooked.model_name) or 0

    async def pairs():
        for engine in (bare, hooked):
            await warm(engine)
        torch.cuda.synchronize()
        row["serving_compiles_after_warmup"] = hooked.serving_compiles()
        row["compiles"] = dict(hooked._compiles_by_class)
        for engine in (bare, hooked):
            await engine.start()
        try:
            await bare.generate(prompts[0], 8)
            with tracer.start_span("request-warmup") as span:
                await hooked.generate(prompts[0], 8)
            row["warmup_trace"] = span.trace_id
            for mod in mods:
                mod.reset_launches()
            before = {id(e): run_counters(e) for e in (bare, hooked)}
            runs = {"off": [], "on": []}
            for _ in range(TELEMETRY_PAIRS):
                gc.collect()
                outs, wall, ttfts, _ = await traced_burst(
                    bare, prompts, budget, samplings)
                runs["off"].append(dict(outs=outs, wall=wall, ttfts=ttfts))
                gc.collect()
                ticks0 = len(store.ticks)
                dispatched0 = hooked.ticks + hooked.spec_dispatches
                ttft0, tokens0 = ttft_count(), tracker.tokens.total()
                outs, wall, ttfts, traces = await traced_burst(
                    hooked, prompts, budget, samplings, tracer)
                runs["on"].append(dict(
                    outs=outs, wall=wall, ttfts=ttfts, traces=traces,
                    anatomy=store.ticks[ticks0:],
                    dispatched=(hooked.ticks + hooked.spec_dispatches
                                - dispatched0),
                    ttft_count=ttft_count() - ttft0,
                    slo_tokens=tracker.tokens.total() - tokens0))
            after = {id(e): run_counters(e) for e in (bare, hooked)}
        finally:
            for engine in (bare, hooked):
                await engine.stop()
        counters = {key: sum(after[i][key] - before[i][key] for i in after)
                    for key in after[id(hooked)]}
        return runs, counters

    runs, counters = asyncio.run(pairs())
    launches = read_launches(mods)
    check_launches(launches, expected_launches(cfg, counters),
                   "telemetry_small")
    by_path["telemetry_small"] = launches
    tracer.shutdown()
    spans = exporter.spans
    for run in runs["on"]:
        if run["outs"] != runs["off"][0]["outs"]:
            raise AssertionError("telemetry: hooked tokens differ from the "
                                 "unhooked engine's")
        if run["ttft_count"] != len(prompts) \
                or run["slo_tokens"] != budget * len(prompts):
            raise AssertionError(
                f"telemetry: {run['ttft_count']} TTFTs and "
                f"{run['slo_tokens']} SLO tokens for {len(prompts)} "
                f"requests of {budget}")
        if len(run["anatomy"]) != run["dispatched"] or any(
                entry[key] < 0 for entry in run["anatomy"]
                for key in entry if key.endswith("_s")):
            raise AssertionError(
                f"telemetry: {len(run['anatomy'])} anatomy entries for "
                f"{run['dispatched']} ticks dispatched, or a negative phase")
    if any(run["outs"] != runs["off"][0]["outs"] for run in runs["off"]):
        raise AssertionError("telemetry: the unhooked bursts differ")
    step_spans = check_spans(spans, [run["traces"] for run in runs["on"]],
                             "telemetry_small", [row.pop("warmup_trace")])
    by_class = sum(hooked._device_seconds.values())
    by_family = hooked.exec_ledger.total_seconds()
    if abs(by_class - by_family) > 1e-6:
        raise AssertionError(f"telemetry: device seconds by class "
                             f"{by_class} != by family {by_family}")
    hbm = hooked.hbm_attribution()
    params_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    if hbm["params_bytes"] != params_bytes \
            or hbm["device_bytes_in_use"] < hbm["attributed_bytes"]:
        raise AssertionError(f"telemetry: hbm attribution {hbm}")
    graphs = hooked.stats()["graphs"]
    lazy = graphs["lazy_captures"] + graphs["prefill"]["lazy_captures"]
    if hooked.serving_compiles() != lazy \
            or row["serving_compiles_after_warmup"] != 0:
        raise AssertionError(
            f"telemetry: {hooked.serving_compiles()} serving compiles, "
            f"{lazy} lazy captures (ticks and prefills), "
            f"{row['serving_compiles_after_warmup']} after warmup()")
    views = {name: len(json.dumps(getattr(hooked, name)()))
             for name in ("statusz", "xlaz", "health_check",
                          "hbm_attribution")}
    anatomy = [entry for run in runs["on"] for entry in run["anatomy"]]
    tok = budget * len(prompts)
    on = [tok / run["wall"] for run in runs["on"]]
    off = [tok / run["wall"] for run in runs["off"]]
    ttft_on = [median(run["ttfts"]) for run in runs["on"]]
    ttft_off = [median(run["ttfts"]) for run in runs["off"]]
    walls_on = sum(run["wall"] for run in runs["on"])
    row.update(
        tokens_per_s_on=on, tokens_per_s_off=off,
        tokens_per_s_on_median=median(on), tokens_per_s_off_median=median(off),
        tokens_per_s_ratio=median(on) / median(off),
        ttft_p50_on=ttft_on, ttft_p50_off=ttft_off,
        ttft_p50_ratio=median(ttft_on) / median(ttft_off),
        anatomy_ticks=len(anatomy),
        anatomy_median_s={key: median([e[key] for e in anatomy])
                          for key in ("admission_s", "host_dispatch_s",
                                      "device_wait_s")},
        anatomy_by_kind={kind: sum(1 for e in anatomy if e["kind"] == kind)
                         for kind in {e["kind"] for e in anatomy}},
        device_seconds_over_wall=by_class / walls_on,
        device_seconds=hooked.stats()["device_seconds"],
        executables=hooked.exec_ledger.snapshot(limit=6)["top"],
        step_spans=dict(step_spans), spans=len(spans),
        hbm=hbm, reserved_bytes=reserved, view_bytes=views,
        graphs=graphs["captured"], greedy_outputs=runs["on"][0]["outs"][:7])
    log(f"telemetry small: tok/s hooks on {row['tokens_per_s_on_median']:.1f} "
        f"off {row['tokens_per_s_off_median']:.1f} (ratio "
        f"{row['tokens_per_s_ratio']:.4f}; pairs on {on} off {off}); TTFT "
        f"p50 on {median(ttft_on):.4f}s off {median(ttft_off):.4f}s (ratio "
        f"{row['ttft_p50_ratio']:.4f}); anatomy medians "
        f"{row['anatomy_median_s']} over {len(anatomy)} ticks "
        f"{row['anatomy_by_kind']}; device seconds / wall "
        f"{row['device_seconds_over_wall']:.4f}; {len(spans)} spans, steps "
        f"{dict(step_spans)}; allocated {hbm['device_bytes_in_use']} B "
        f"(attributed {hbm['attributed_bytes']}, params "
        f"{hbm['params_bytes']}), reserved {reserved} B; views {views}")
    del bare

    # -- faults on the card, on the hooked engine ---------------------------------
    want = runs["off"][0]["outs"]
    captured = hooked.stats()["graphs"]["captured"]
    for mod in mods:
        mod.reset_launches()
    before = run_counters(hooked)

    async def faulted(spec):
        await hooked.start()
        try:
            faults.install(faults.FaultPlan(spec, metrics=metrics))
            try:
                out = await asyncio.wait_for(asyncio.gather(*[
                    hooked.generate(p, budget, sampling=s)
                    for p, s in zip(prompts, samplings)],
                    return_exceptions=True), 600)
            finally:
                faults.reset()
            later = await asyncio.wait_for(asyncio.gather(*[
                hooked.generate(p, budget, sampling=s)
                for p, s in zip(prompts, samplings)]), 600)
            return out, later
        finally:
            await hooked.stop()

    quarantined0 = dict(hooked.stats().get("resilience", {}).get(
        "quarantined", {}))
    nan_out, nan_later = asyncio.run(faulted("nan_logits:@1"))
    failed = [i for i, out in enumerate(nan_out)
              if isinstance(out, BaseException)]
    quarantined = hooked.stats()["resilience"]["quarantined"]
    kept = all(nan_out[i] == want[i] for i in range(len(prompts))
               if i not in failed)
    row["nan_logits"] = dict(failed=failed, quarantined=quarantined,
                             others_equal=kept, later_equal=nan_later == want)
    log(f"nan_logits: requests {failed} failed, quarantined {quarantined}, "
        f"the others' tokens unchanged: {kept}")
    if len(failed) != 1 or quarantined.get("nan_logits", 0) \
            - quarantined0.get("nan_logits", 0) != 1 or not kept \
            or nan_later != want:
        raise AssertionError(f"nan_logits: {row['nan_logits']}")
    tick_out, tick_later = asyncio.run(faulted("tick_exception:@3"))
    kinds = sorted({type(out).__name__ for out in tick_out})
    row["tick_exception"] = dict(
        outcomes=kinds, later_equal=tick_later == want,
        captured_before=captured,
        captured_after=hooked.stats()["graphs"]["captured"])
    log(f"tick_exception: callers got {kinds}; next burst equal: "
        f"{tick_later == want}; graphs {captured} -> "
        f"{row['tick_exception']['captured_after']}")
    if kinds != ["FaultError"] or tick_later != want \
            or row["tick_exception"]["captured_after"] != captured:
        raise AssertionError(f"tick_exception: {row['tick_exception']}")
    after = run_counters(hooked)
    launches = read_launches(mods)
    check_launches(launches, expected_launches(
        cfg, {key: after[key] - before[key] for key in after}),
        "telemetry_faults")
    by_path["telemetry_faults"] = launches
    del hooked
    torch.cuda.empty_cache()

    # -- the control loop on the spec engine -------------------------------------
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    kw, exporter = hooks("small")
    metrics, tracer = kw["metrics"], kw["tracer"]
    tracker = slo.SLOTracker(metrics, slice_s=0.05, max_window_s=60.0)
    kw["slo"] = tracker
    spec = generate.GenerationEngine(
        cfg, params, device="cuda", draft_cfg=dcfg, draft_params=dparams,
        spec_gamma=SPEC_GAMMA, **SMALL_ENGINE, **kw)
    ladder = slo.BrownoutLadder(apply_fn=spec.set_brownout, metrics=metrics,
                                escalate_after=1, recover_after=2)
    dog = slo.Watchdog(tracker, metrics=metrics, min_attainment=0.9,
                       hysteresis=2, window_s=0.8, ledger=spec,
                       max_serving_compiles=3, brownout=ladder)
    loop_row = {}

    async def control():
        await warm(spec)
        await spec.start()
        try:
            await spec.generate(prompts[0], 8)
            for mod in mods:
                mod.reset_launches()
            base = run_counters(spec)

            async def late(prompt):
                slo.set_request_deadline(1.0)      # 1 ms from now
                try:
                    return await spec.generate(prompt, budget)
                finally:
                    slo.set_request_deadline(None)

            outcomes0 = {name: tracker.outcomes[name].total()
                         for name in slo.TERMINAL_OUTCOMES}
            await asyncio.gather(*[late(p) for p in prompts],
                                 return_exceptions=True)
            t1 = time.monotonic()
            loop_row["late_outcomes"] = {
                name: tracker.outcomes[name].total() - outcomes0[name]
                for name in slo.TERMINAL_OUTCOMES}
            with tracer.start_span("watchdog.evaluate") as span:
                trail = []
                for i in range(2):
                    state = dog.evaluate(now=t1 + 0.001 * i)
                    trail.append((state, ladder.level))
                loop_row["escalation"] = trail
                try:
                    await spec.generate(prompts[1], 8)     # batch class
                    loop_row["batch_refused"] = False
                except generate.BrownoutShed:
                    loop_row["batch_refused"] = True
                await asyncio.sleep(1.0)         # the late burst leaves
                                                 # the window
                slo.set_request_deadline(60_000.0)         # standard
                try:
                    calm = await asyncio.gather(*[
                        spec.generate(p, budget) for p in prompts])
                finally:
                    slo.set_request_deadline(None)
                t2 = time.monotonic()
                recovery = []
                while ladder.level > 0 and len(recovery) < 16:
                    state = dog.evaluate(now=t2 + 0.001 * len(recovery))
                    recovery.append((state, ladder.level))
                loop_row["recovery"] = recovery
                loop_row["level_events"] = [
                    (e["attributes"]["previous"], e["attributes"]["level"])
                    for e in span.find_events("brownout.level")]
            loop_row["calm_tokens"] = sum(len(out) for out in calm)
            after = run_counters(spec)
            return with_captures(
                {key: after[key] - base[key] for key in after}, [])
        finally:
            await spec.stop()

    counters = asyncio.run(control())
    launches = read_launches(mods)
    check_launches(launches, expected_launches(cfg, counters, 2),
                   "telemetry_spec")
    by_path["telemetry_spec"] = launches
    tracer.shutdown()
    loop_row["watchdog"] = dog.statusz()
    loop_row["brownout_gauge"] = metrics.value("app_tpu_brownout_level",
                                               role="both")
    row["control_loop"] = loop_row
    log(f"control loop: late burst outcomes {loop_row['late_outcomes']}; "
        f"escalation (state, level) {loop_row['escalation']}; batch "
        f"refused {loop_row['batch_refused']}; recovery "
        f"{loop_row['recovery']}; level events "
        f"{loop_row['level_events']}")
    late_out = loop_row["late_outcomes"]
    levels = [level for _, level in loop_row["escalation"]]
    if late_out["ok"] or not late_out["violated"] \
            or late_out["violated"] + late_out["expired"] != len(prompts) \
            or levels != [1, 2] or loop_row["escalation"][-1][0] \
            != "DEGRADED" or not loop_row["batch_refused"] \
            or len(loop_row["recovery"]) != 2 * ladder.recover_after \
            or ladder.level != 0 or loop_row["level_events"] != [
                ("0", "1"), ("1", "2"), ("2", "1"), ("1", "0")]:
        raise AssertionError(f"control loop: {loop_row}")
    del spec, params, dparams
    torch.cuda.empty_cache()
    row["phase_s"] = time.monotonic() - t_phase
    results["telemetry"] = row
    log(f"phase 28: {row['phase_s']:.1f}s")
    return by_path


def phase_telemetry_llama3(torch, generate, mods, cfg, params, seed,
                           results):
    """Phase 28 at ``llama3-8b`` width, after phase 18: one unhooked and
    one hooked burst on the dense bf16 engine; equal tokens, the tok/s
    ratio. Returns launches by path."""
    t_phase = time.monotonic()
    log("== phase 28 (llama3-8b): hooks on against off, dense bf16")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine_kw = dict(max_slots=8, max_len=2048,
                     prompt_buckets=(32, 128, 512), steps_per_tick=4)
    kw, exporter = hooks("llama3-8b")
    out, warmups = {}, []
    counters = None
    for name, extra in (("off", {}), ("on", kw)):
        engine = generate.GenerationEngine(cfg, params, device="cuda",
                                           **engine_kw, **extra)

        async def run():
            await warm(engine)
            await engine.start()
            try:
                with kw["tracer"].start_span("request-warmup") as span:
                    await engine.generate(prompts[0], 8)
                warmups.append(span.trace_id)
                for mod in mods:
                    mod.reset_launches()
                before = run_counters(engine)
                gc.collect()
                burst = await traced_burst(
                    engine, prompts, budget, samplings,
                    kw["tracer"] if name == "on" else None)
                after = run_counters(engine)
                return burst, {k: after[k] - before[k] for k in after}
            finally:
                await engine.stop()

        out[name], delta = asyncio.run(run())
        launches = read_launches(mods)
        check_launches(launches, expected_launches(cfg, delta),
                       "telemetry_llama3")
        counters = launches if counters is None else {
            k: counters[k] + launches[k] for k in launches}
        del engine
        torch.cuda.empty_cache()
    kw["tracer"].shutdown()
    check_spans(exporter.spans, [out["on"][3]], "telemetry_llama3",
                warmups)
    tok = budget * len(prompts)
    row = dict(tokens_per_s_off=tok / out["off"][1],
               tokens_per_s_on=tok / out["on"][1],
               ttft_p50_off=median(out["off"][2]),
               ttft_p50_on=median(out["on"][2]),
               tokens_equal=out["on"][0] == out["off"][0])
    row["tokens_per_s_ratio"] = row["tokens_per_s_on"] \
        / row["tokens_per_s_off"]
    row["phase_s"] = time.monotonic() - t_phase
    results["telemetry_llama3"] = row
    log(f"telemetry llama3-8b: tok/s on {row['tokens_per_s_on']:.1f} off "
        f"{row['tokens_per_s_off']:.1f} (ratio "
        f"{row['tokens_per_s_ratio']:.4f}); TTFT p50 on "
        f"{row['ttft_p50_on']:.4f}s off {row['ttft_p50_off']:.4f}s; tokens "
        f"equal {row['tokens_equal']}; {row['phase_s']:.1f}s")
    if not row["tokens_equal"]:
        raise AssertionError("telemetry llama3-8b: hooked tokens differ")
    return {"telemetry_llama3": counters}


# -- phase 32: disaggregated serving ------------------------------------------
PATH_KERNELS.update({"disagg": ("flash", "ragged"),
                     "disagg_int8": ("flash", "int8"),
                     "registry_small": ("flash", "ragged")})
# phase 9's engine settings; the prefill replica runs them dense (phase
# 15's), the decode replica paged (phase 9's)
DISAGG_ENGINE = dict(max_slots=8, max_len=2048,
                     prompt_buckets=(32, 128, 512), steps_per_tick=4,
                     kv_page=32)


def probe_export_memory(torch, engine, into):
    """Add the reserved bytes each export-rung capture of ``engine``'s
    next ``warmup()`` holds to ``into["_warm_export"]`` (nothing for an
    engine of a tree before export rungs, which
    ``scripts/smoke_phases_ab.py`` may measure)."""
    call = getattr(engine, "_warm_export", None)
    if call is None:
        return

    def run(bucket):
        before = reserved_bytes(torch)
        call(bucket)
        into["_warm_export"] = into.get("_warm_export", 0) \
            + reserved_bytes(torch) - before
    engine._warm_export = run


async def routed_burst(router, prompts, budget, samplings, timeout):
    """One burst through a ``DisaggRouter``, each request streamed: (the
    outputs, wall seconds, sorted TTFTs from submit to first token)."""
    async def one(prompt, sampling):
        t0 = time.monotonic()
        stream = await router.generate_stream(prompt, budget,
                                              sampling=sampling)
        out, ttft = [], None
        async for token in stream:
            if ttft is None:
                ttft = time.monotonic() - t0
            out.append(token)
        return out, ttft

    t0 = time.monotonic()
    got = await asyncio.wait_for(asyncio.gather(*[
        one(p, s) for p, s in zip(prompts, samplings)]), timeout)
    return [g[0] for g in got], time.monotonic() - t0, \
        sorted(g[1] for g in got)


def wire_costs(kv_wire, payload):
    """The host's share of one payload's trip, each step timed with its
    GB/s: ``pack``, the 256 KiB frames, ``assemble``, ``unpack``."""
    t0 = time.perf_counter()
    blob = kv_wire.pack(payload)
    t1 = time.perf_counter()
    chunks = list(kv_wire.iter_chunks(blob))
    t2 = time.perf_counter()
    joined = kv_wire.assemble(chunks)
    t3 = time.perf_counter()
    kv_wire.unpack(joined)
    t4 = time.perf_counter()
    n = len(blob)
    steps = dict(pack_s=t1 - t0, frames_s=t2 - t1, assemble_s=t3 - t2,
                 unpack_s=t4 - t3)
    return dict(bytes=n, frames=len(chunks), tokens=payload.tokens,
                **steps, **{k[:-2] + "_gb_s": n / v / 1e9
                            for k, v in steps.items() if v > 0})


async def migrate_session(engine, target, cluster, kv_wire, prompt, budget,
                          sampling, after=8):
    """Serve ``prompt`` on ``engine``; after ``after`` tokens export the
    live session (ticks in flight), ship it through the wire and resume
    it on ``target``. Returns (the whole stream, ticks in flight at the
    export, the wire bytes)."""
    stream = await engine.generate_stream(prompt, budget, sampling=sampling)
    before = []
    while len(before) < after:
        before.append(await asyncio.wait_for(stream.__anext__(), 120))
    inflight = engine._ticks_inflight
    payload, state = await engine.export_session(stream)
    before += [token async for token in stream]
    blob = kv_wire.pack(payload)
    resumed = await cluster.InProcTransport(target).adopt_session(blob,
                                                                  state)
    return before + [token async for token in resumed], inflight, len(blob)


def phase_disagg(torch, generate, cluster, kv_wire, faults, mods, cfg,
                 params, seed, results):
    """Phase 32 (a)-(c) at ``llama3-8b`` (after the other ``llama3-8b``
    phases, on their weights): phase 9's burst through a ``DisaggRouter``
    over a dense prefill replica and a paged decode replica
    (``InProcTransport``), bf16 then ``kv_int8``; a live session
    migrated between two paged engines; a corrupted frame and a replayed
    adopt. Returns launches by path."""
    t_phase = time.monotonic()
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    by_path = {}
    for int8 in (False, True):
        c = dataclasses.replace(cfg, kv_int8=int8)
        path = "disagg_int8" if int8 else "disagg"
        mono = results["int8_engine" if int8 else "engine"]
        log(f"== phase 32a: llama3-8b disaggregated, {c.n_layers} layers, "
            f"dense prefill replica -> paged decode replica"
            f"{', kv_int8 (int8 codec)' if int8 else ' (raw bf16 codec)'}")
        prefill_eng = generate.GenerationEngine(
            c, params, paged_kv=False, model_name="prefill", device="cuda",
            **DISAGG_ENGINE)
        decode_eng = generate.GenerationEngine(
            c, params, paged_kv=True, model_name="decode", device="cuda",
            **DISAGG_ENGINE)
        registry = cluster.ClusterRegistry()
        registry.register("p0", cluster.ROLE_PREFILL,
                          cluster.InProcTransport(prefill_eng))
        registry.register("d0", cluster.ROLE_DECODE,
                          cluster.InProcTransport(decode_eng))
        router = cluster.DisaggRouter(registry)
        memory = {}
        probe_export_memory(torch, prefill_eng, memory)

        async def run():
            t0 = time.monotonic()
            # the prefill replica needs its export rungs (warmed with
            # count 1), the decode replica its ticks
            await prefill_eng.warmup(prompt_counts=(1,), ks=(1,),
                                     windows=(128,))
            await decode_eng.warmup(prompt_counts=(1,))
            warm_s = time.monotonic() - t0
            await decode_eng.start()
            try:
                await router.generate(prompts[0], 8)     # warm-up request
                for mod in mods:
                    mod.reset_launches()
                p0, d0 = prefill_eng.stats(), decode_eng.stats()
                c0 = run_counters(decode_eng)
                outs, wall, ttfts = await routed_burst(
                    router, prompts, budget, samplings, 900)
                launches = read_launches(mods)
                p1, d1 = prefill_eng.stats(), decode_eng.stats()
                c1 = run_counters(decode_eng)
                legs = list(router._stitches.values())[-len(prompts):]
                transfers = [dict(bytes=e["bytes"],
                                  prefill_rpc_s=e["prefill_rpc_s"],
                                  adopt_rpc_s=e["adopt_rpc_s"],
                                  adopt_gb_s=e["bytes"] / e["adopt_rpc_s"]
                                  / 1e9) for e in legs]
                payload = await prefill_eng.prefill_export(prompts[7])
                costs = wire_costs(kv_wire, payload)
                extra = None
                if not int8:
                    extra = await session_and_chaos(
                        torch, generate, cluster, kv_wire, faults, c,
                        params, prefill_eng, decode_eng, router, prompts,
                        mono, seed)
                return (outs, wall, ttfts, launches, p0, p1, d0, d1, c0,
                        c1, transfers, costs, warm_s, extra)
            finally:
                await decode_eng.stop()

        (outs, wall, ttfts, launches, p0, p1, d0, d1, c0, c1, transfers,
         costs, warm_s, extra) = asyncio.run(run())
        exports = p1["kv_exports"] - p0["kv_exports"]
        adoptions = d1["kv_adoptions"] - d0["kv_adoptions"]
        export_graphs = p1["graphs"]["export"]
        counters = dict(
            prefills=exports,
            prefill_lazy=export_graphs["lazy_captures"]
            - p0["graphs"]["export"]["lazy_captures"],
            steps=c1["steps"] - c0["steps"], spec_ticks=0, draft_steps=0)
        ticks = c1["ticks"] - c0["ticks"]
        replays = c1["replays"] - c0["replays"]
        export_replays = export_graphs["replays"] \
            - p0["graphs"]["export"]["replays"]
        tokens = budget * len(outs)
        greedy_same = outs[:7] == mono["greedy_outputs"]
        row = dict(
            n_layers=c.n_layers, kv_int8=int8, requests=len(outs),
            new_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            ttft_s=ttfts, ttft_p50_s=ttfts[len(ttfts) // 2],
            ttft_max_s=ttfts[-1],
            monolithic=dict(tokens_per_s=mono["tokens_per_s"],
                            ttft_p50_s=mono["ttft_p50_s"],
                            ttft_max_s=mono["ttft_max_s"]),
            greedy_identical_to_monolithic=greedy_same,
            exports=exports, adoptions=adoptions,
            decode_prefill_bucket_tokens=d1["prefill_bucket_tokens"],
            decode_steps=counters["steps"], ticks=ticks, replays=replays,
            export_replays=export_replays, launches=launches,
            transfers=transfers, wire_512=costs, warmup_s=warm_s,
            export_graphs=export_graphs,
            export_capture_bytes=memory.get("_warm_export"),
            router=router.stats(), extra=extra)
        results[path] = row
        log(f"{path}: {len(outs)} requests x {budget} tokens in "
            f"{wall:.3f}s = {row['tokens_per_s']:.1f} tok/s (monolithic "
            f"{mono['tokens_per_s']:.1f}); TTFT p50 {row['ttft_p50_s']:.3f}s "
            f"max {row['ttft_max_s']:.3f}s (monolithic "
            f"{mono['ttft_p50_s']:.3f} / {mono['ttft_max_s']:.3f}); "
            f"{exports} exports, {adoptions} adoptions, decode replica "
            f"prefill_bucket_tokens {d1['prefill_bucket_tokens']}; "
            f"launches {launches}; export graphs {export_graphs} "
            f"(+{memory.get('_warm_export')} reserved bytes)")
        for i, leg in enumerate(transfers):
            log(f"  request {i} ({len(prompts[i])} tokens): "
                f"{leg['bytes']} bytes, prefill leg "
                f"{leg['prefill_rpc_s'] * 1e3:.2f} ms, transfer leg "
                f"{leg['adopt_rpc_s'] * 1e3:.2f} ms = "
                f"{leg['adopt_gb_s']:.3f} GB/s")
        log(f"  512-token payload on the host: {costs}")
        if not greedy_same:
            raise AssertionError(f"{path}: greedy tokens through the router "
                                 f"differ from the monolithic engine's")
        if d1["prefill_bucket_tokens"] or adoptions != len(prompts) \
                or exports != len(prompts):
            raise AssertionError(
                f"{path}: {exports} exports, {adoptions} adoptions and "
                f"{d1['prefill_bucket_tokens']} prefill tokens on the decode "
                f"replica; expected {len(prompts)}, {len(prompts)}, 0")
        if replays != ticks or c1["lazy_captures"] - c0["lazy_captures"] \
                or export_replays != exports or counters["prefill_lazy"]:
            raise AssertionError(
                f"{path}: {replays} replays for {ticks} ticks, "
                f"{export_replays} export replays for {exports} exports, "
                f"{counters['prefill_lazy']} export captures: every tick "
                f"and export must replay a graph warmup() captured")
        check_launches(launches, expected_launches(c, counters), path)
        by_path[path] = launches
        del prefill_eng, decode_eng, router, registry
        torch.cuda.empty_cache()
    results["phase32_s"] = time.monotonic() - t_phase
    log(f"phase 32 (a-c): {results['phase32_s']:.1f}s")
    return by_path


async def session_and_chaos(torch, generate, cluster, kv_wire, faults, cfg,
                            params, prefill_eng, decode_eng, router, prompts,
                            mono, seed):
    """Phase 32 (b) and (c), on phase 32a's bf16 replicas (the decode
    replica serving): (b) a live session of ``prompts[5]`` migrated after
    8 of 32 tokens to a second paged engine on the same weights, greedy
    and sampled (seeded), each whole stream the unmigrated one, the
    source pool's free pages back to their baseline; (c)
    ``kv_chunk_corrupt:@1`` costs one fresh prefill round and keeps the
    tokens, and a replayed adopt returns the first stream with no second
    slot or page set."""
    log("== phase 32b: live session migration between two paged "
        "llama3-8b engines")
    target = generate.GenerationEngine(cfg, params, paged_kv=True,
                                       model_name="target", device="cuda",
                                       **DISAGG_ENGINE)
    await target.warmup(prompt_counts=(1,))
    await target.start()
    out = {}
    try:
        pool = decode_eng._pool
        baseline = pool.free_pages
        sampled = generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)
        want_sampled = await decode_eng.generate(prompts[5], 32,
                                                 sampling=sampled)
        t0 = time.monotonic()
        runs = {}
        for name, sampling, want in (
                ("greedy", None, mono["greedy_outputs"][5]),
                ("sampled", generate.Sampling(temperature=0.8, top_p=0.95,
                                              seed=seed), want_sampled)):
            got, inflight, nbytes = await migrate_session(
                decode_eng, target, cluster, kv_wire, prompts[5], 32,
                sampling)
            for _ in range(200):
                if pool.free_pages == baseline:
                    break
                await asyncio.sleep(0.01)
            runs[name] = dict(identical=got == want, ticks_inflight=inflight,
                              bytes=nbytes, source_free_pages=pool.free_pages,
                              baseline_free_pages=baseline)
            log(f"  {name}: whole stream equal to the unmigrated one: "
                f"{got == want}; {inflight} ticks in flight at the export; "
                f"{nbytes} bytes; source free pages {pool.free_pages} "
                f"(baseline {baseline})")
            if got != want or pool.free_pages != baseline:
                raise AssertionError(f"phase 32b {name}: migrated stream "
                                     f"or source pages differ")
            if inflight < 1:
                raise AssertionError(f"phase 32b {name}: no tick in flight "
                                     f"at the export")
        out["session"] = dict(runs, seconds=time.monotonic() - t0,
                              target=target.stats()["session_adoptions"],
                              source=decode_eng.stats()["session_exports"])
    finally:
        await target.stop()
    del target
    log("== phase 32c: a corrupted frame and a replayed adopt")
    retries = router.stats()["retries"]
    exports = prefill_eng.stats()["kv_exports"]
    faults.install(faults.FaultPlan("kv_chunk_corrupt:@1"))
    try:
        corrupt = await router.generate(prompts[1], 32)
    finally:
        faults.reset()
    rounds = prefill_eng.stats()["kv_exports"] - exports
    retried = router.stats()["retries"] - retries
    log(f"  kv_chunk_corrupt:@1: {rounds} prefill rounds, {retried} retry, "
        f"tokens equal: {corrupt == mono['greedy_outputs'][1]}")
    if corrupt != mono["greedy_outputs"][1] or rounds != 2 or retried != 1:
        raise AssertionError("phase 32c: a corrupted frame must cost one "
                             "fresh prefill round and keep the tokens")
    payload = await prefill_eng.prefill_export(prompts[2])
    first = await decode_eng.adopt_kv(payload, 32, dedupe="phase-32c")
    free, slots = decode_eng._pool.free_pages, len(decode_eng._free)
    again = await decode_eng.adopt_kv(payload, 32, dedupe="phase-32c")
    same_claim = (decode_eng._pool.free_pages, len(decode_eng._free)) \
        == (free, slots)
    tokens = [token async for token in first]
    hits = decode_eng.stats()["resilience"]["adopt_dedup_hits"]
    log(f"  replayed adopt: same stream {again is first}, no second claim "
        f"{same_claim}, dedup hits {hits}, tokens equal "
        f"{tokens == mono['greedy_outputs'][2]}")
    if again is not first or not same_claim or hits != 1 \
            or tokens != mono["greedy_outputs"][2]:
        raise AssertionError("phase 32c: a replayed adopt must return the "
                             "first stream and claim nothing")
    out["chaos"] = dict(corrupt_rounds=rounds, corrupt_retries=retried,
                        dedup_hits=hits)
    return out


def phase_registry(torch, generate, page_pool, registry_mod, mods, cfg,
                   params, seed, results):
    """Phase 32d (after phase 31, on phase 20's ``small`` weights):
    ``ModelRegistry`` over phase 30b's two paged engines sharing one
    ``PagePool`` of 512 MiB, warmed through the registry: both routes'
    bursts give the same greedy tokens, the watchdog's ``DEGRADED``
    routes the first model to its fallback, a drained model routes there
    too, health is UP, and ``hbm_attribution`` counts the shared pool
    once. Returns launches."""
    import types

    log("== phase 32d: ModelRegistry over two small paged engines on one "
        "shared page pool")
    pool = page_pool.PagePool(cfg, page=32, budget_bytes=512 << 20,
                              device="cuda")
    kw = dict(SMALL_ENGINE, paged_kv=True, kv_page=32, device="cuda")
    engines = [generate.GenerationEngine(cfg, params, page_pool=pool,
                                         model_name=f"m{i}", **kw)
               for i in range(2)]
    dog = types.SimpleNamespace(state="READY")
    registry = registry_mod.ModelRegistry(watchdog=dog, page_pool=pool)
    registry.register("m0", engines[0], fallback="m1")
    registry.register("m1", engines[1])
    prompts = engine_prompts(cfg, seed)[:4]

    async def run():
        for name in ("m0", "m1"):
            await registry.warmup(name, prompt_counts=(1, 4))
        await registry.start()
        try:
            for mod in mods:
                mod.reset_launches()
            before = [run_counters(e) for e in engines]
            routed = {}
            for name in ("m0", "m1"):
                engine = registry.route(name)
                routed[name] = (engine.model_name, await asyncio.gather(*[
                    engine.generate(p, 16) for p in prompts]))
            dog.state = "DEGRADED"
            degraded = registry.route("m0").model_name
            dog.state = "READY"
            drained = await registry.drain("m0", timeout_s=30.0)
            fallback = registry.route("m0").model_name
            launches = read_launches(mods)
            want = dict.fromkeys(launches, 0)
            for e, b in zip(engines, before):
                after = run_counters(e)
                for k, n in expected_launches(cfg, {
                        k: after[k] - b[k] for k in after}).items():
                    want[k] += n
            return (routed, degraded, drained, fallback, launches, want,
                    registry.health_check(), registry.hbm_attribution(),
                    registry.stats()["fallbacks_taken"])
        finally:
            await registry.stop()

    (routed, degraded, drained, fallback, launches, want, health, hbm,
     taken) = asyncio.run(run())
    per_model = {name: dict(params=m["params_bytes"],
                            staging=m["staging_bytes"],
                            pool=m["page_pool"]["pool_bytes"])
                 for name, m in hbm["models"].items()}
    once = sum(m["params"] + m["staging"] for m in per_model.values()) \
        + pool.pool_bytes
    log(f"routes {[(n, r[0]) for n, r in routed.items()]}, same tokens "
        f"{routed['m0'][1] == routed['m1'][1]}; DEGRADED routes m0 to "
        f"{degraded}; drained {drained}, then m0 routes to {fallback}; "
        f"fallbacks {taken}; health {health['status']}; hbm by model "
        f"{per_model}, attributed {hbm['attributed_bytes']} (the pool once: "
        f"{once}), device bytes {hbm['device_bytes_in_use']}")
    if [routed[n][0] for n in ("m0", "m1")] != ["m0", "m1"] \
            or routed["m0"][1] != routed["m1"][1]:
        raise AssertionError("phase 32d: the routes' tokens differ")
    if degraded != "m1" or not drained or fallback != "m1":
        raise AssertionError("phase 32d: fallback routing is not JAX's")
    if health["status"] != "UP" or hbm["attributed_bytes"] != once:
        raise AssertionError("phase 32d: health or attribution wrong")
    check_launches(launches, want, "registry_small")
    results["registry_small"] = dict(
        fallbacks=taken, hbm_by_model=per_model,
        attributed_bytes=hbm["attributed_bytes"],
        device_bytes_in_use=hbm["device_bytes_in_use"], launches=launches)
    del engines, registry, pool
    torch.cuda.empty_cache()
    return {"registry_small": launches}


# -- phase 33: the fleet control plane and online auto-tuning ---------------
PATH_KERNELS.update({"fleet": ("flash", "ragged"),
                     "autotune_small": ("flash", "ragged")})
# the fleet's replicas: phase 9's settings, paged, with the prefix store
# (each admission builds the residency the router steers by)
FLEET_ENGINE = dict(DISAGG_ENGINE, paged_kv=True, prefix_cache=True)
# every rung of the admission ladder of 8 slots
FLEET_COUNTS = (1, 2, 4, 8)
# tokens a drained session asks for (33b)
DRAIN_BUDGET = 128
# the kernels' launch counters by the names ``read_launches`` gives them
LAUNCH_NAMES = {"flash_attention.launches": "flash",
                "ragged_paged_attention.launches": "ragged",
                "ragged_paged_attention.verify_launches": "verify",
                "ragged_paged_attention.int8_launches": "int8",
                "ragged_paged_attention.int8_verify_launches": "int8_verify",
                "decode_attention.launches": "flash_decode"}


class DefaultConfig:
    """A config that holds no key: every ``get_*`` answers its default,
    as the app's config does with nothing set in the environment."""

    def get_bool(self, key, default=False):
        return default

    def get_int(self, key, default=0):
        return default

    def get_float(self, key, default=0.0):
        return default


def graph_launches(graphs, runs=1):
    """The launches ``runs`` runs of each of ``graphs`` (captured ticks,
    prefill or export rungs) make, by kernel."""
    out = dict.fromkeys(LAUNCH_NAMES.values(), 0)
    for graph in graphs:
        for key, n in graph.launches.items():
            out[LAUNCH_NAMES[key]] += runs * n
    return out


def captured_graphs(engine):
    """Every graph ``engine`` holds: ticks, prefill and export rungs."""
    return (list(engine._graphs.values())
            + [r for r in engine._prefills.values() if r.graph is not None]
            + [r for r in engine._exports.values() if r.graph is not None])


def add_launches(into, more):
    for name, n in more.items():
        into[name] += n
    return into


def served_launches(cfg, engine, before):
    """What ``engine``'s kernels launched since ``before`` (its
    ``run_counters``) serving: replays and the eager runs before the
    prefill rungs and the ticks it captured lazily (a lazy tick capture's
    eager run launches what a replay of its graph does)."""
    after = run_counters(engine)
    want = expected_launches(cfg, {k: after[k] - before[k] for k in after})
    lazy = after["lazy_captures"] - before["lazy_captures"]
    if lazy:
        keys = set(before.get("_tick_keys", ()))
        add_launches(want, graph_launches(
            [g for k, g in engine._graphs.items() if k not in keys]))
    return want


def counters_with_keys(engine):
    out = run_counters(engine)
    out["_tick_keys"] = list(engine._graphs)
    return out


def fresh_prompts(cfg, rng, n, lo=5, hi=500):
    """``n`` random prompts of random lengths in [lo, hi): no two share a
    page, so none hits a prefix store."""
    return [rng.integers(0, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(lo, hi, n)]


def phase_fleet(torch, generate, cluster, fleet, faults, mods, cfg, params,
                seed, results):
    """Phase 33 (a)-(d) at ``llama3-8b`` (after phase 32, on its weights):
    two paged replicas with the prefix store behind a ``FleetRouter``
    over ``InProcTransport``, each with the port's ``TimeSeriesStore``
    (``new_timeseries``). (d) first, while every rung it serves is one
    ``warmup()`` captured: the ``Autoscaler`` over the rollup scales up
    under a backlog (a third replica built, warmed, registered) and down
    when idle, draining the victim by migration; then (a) affinity, (b)
    migration and drain, (c) resume. Returns launches by path."""
    import numpy as np
    from types import SimpleNamespace

    from gofr_tpu_torch.hbmz import hbm_occupancy
    from gofr_tpu_torch.metrics import Manager, register_engine_metrics
    from gofr_tpu_torch.metrics.timeseries import new_timeseries

    t_phase = time.monotonic()
    log(f"== phase 33: the fleet at llama3-8b ({cfg.n_layers} layers): two "
        f"paged replicas with the prefix store behind a FleetRouter")
    metrics = register_engine_metrics(Manager(logger=StrictLog()))
    engines = {name: generate.GenerationEngine(
        cfg, params, model_name=name, device="cuda", **FLEET_ENGINE)
        for name in ("d0", "d1")}
    registry = cluster.ClusterRegistry(metrics=metrics)
    router = fleet.FleetRouter(registry, metrics=metrics)
    page_buckets = metrics.snapshot()["app_tpu_fleet_affinity_pages"].buckets

    def series(name, **labels):
        """A registered series now: a histogram's (count, sum, count in
        each bucket), a counter's value."""
        metric = metrics.snapshot()[name]
        state = metric.series.get(tuple(sorted(labels.items())))
        if metric.kind == "histogram":
            state = state or dict(count=0, sum=0.0,
                                  buckets=[0] * len(metric.buckets))
            return state["count"], state["sum"], list(state["buckets"])
        return state or 0.0

    def migrations_since(before):
        """The fleet's migrations since ``before`` (a ``migration_mark()``)
        from its series: ok ones, their downtime in all (the splice gaps
        ``app_tpu_fleet_migration_seconds`` observed) and the bytes
        shipped."""
        now = migration_mark()
        return dict(ok=now[0] - before[0], failed=now[1] - before[1],
                    downtime_s=now[2] - before[2], bytes=now[3] - before[3])

    def migration_mark():
        return (series("app_tpu_fleet_migrations_total", result="ok"),
                series("app_tpu_fleet_migrations_total", result="failed"),
                series("app_tpu_fleet_migration_seconds")[1],
                series("app_tpu_kv_transfer_bytes_total"))

    def requests_by_replica():
        return {n: r.requests for n, r in registry._replicas.items()}
    stores = {}
    base = {}                 # each engine's counters when counting began
    extra = dict.fromkeys(LAUNCH_NAMES.values(), 0)   # d2's warmup
    prompts = engine_prompts(cfg, seed)
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    mono = results["engine"]["greedy_outputs"]

    def attach(name, engine):
        """What ``App.start`` wires beside an engine: the telemetry store
        over its default signals, as the replica's telemetry."""
        store = new_timeseries(DefaultConfig(), tpu=engine,
                               container=SimpleNamespace(tpu=engine),
                               metrics=metrics)
        engine.attach_telemetry(store, every=store.tick_sample)
        stores[name] = store
        registry.register(name, cluster.ROLE_BOTH,
                          cluster.InProcTransport(engine))

    async def warm_replica(engine):
        t0 = time.monotonic()
        await engine.warmup(prompt_counts=FLEET_COUNTS)
        return time.monotonic() - t0

    def force(names_busy, state):
        for name in names_busy:
            registry._set_state(registry._require(name), state)

    # -- (d) the autoscaler -------------------------------------------------
    async def autoscale():
        log("== phase 33d: the Autoscaler over the rollup: a backlog of 24 "
            "scales up to a third replica, idle firings scale down by "
            "draining the victim by migration")
        rng = np.random.default_rng(seed + 33)
        container = SimpleNamespace(tpu=engines["d0"])
        grown = {}

        async def scale_up():
            engine = generate.GenerationEngine(
                cfg, params, model_name="d2", device="cuda", **FLEET_ENGINE)
            grown["warm_s"] = await warm_replica(engine)
            # its warmup ran each graph it captured eagerly, then once
            add_launches(extra, graph_launches(captured_graphs(engine), 2))
            engines["d2"] = engine
            base["d2"] = counters_with_keys(engine)
            attach("d2", engine)
            await engine.start()

        scaler = fleet.Autoscaler(
            registry, scale_up=scale_up, scale_down=router.drain,
            router=router, metrics=metrics, container=container,
            compile_ledger=engines["d0"], cooldown_s=0.0)
        router.autoscaler = scaler
        events = []

        async def fire():
            for store in stores.values():
                store.sample()
            await router.refresh()
            event = await scaler()
            events.append(event)
            return event

        backlog = [asyncio.ensure_future(router.generate(p, 64))
                   for p in fresh_prompts(cfg, rng, 24, 5, 300)]
        while sum(e.stats()["queue_depth"] for e in engines.values()) < 8:
            await asyncio.sleep(0.001)
        pressure = [await fire(), await fire()]
        await asyncio.wait_for(asyncio.gather(*backlog), 600)
        # the next burst: the new replica takes part of it
        requests0 = {n: r.requests for n, r in registry._replicas.items()}
        burst = await asyncio.wait_for(asyncio.gather(*[
            router.generate(p, 32)
            for p in fresh_prompts(cfg, rng, 12, 5, 300)]), 600)
        served = {n: r.requests - requests0.get(n, 0)
                  for n, r in registry._replicas.items()}
        # five live sessions: two on each of d0 and d1, one on d2, so the
        # least-loaded replica the scaler drains is d2
        session_prompts = fresh_prompts(cfg, rng, 5, 100, 400)
        force(("d2",), "DRAINING")
        sessions = [await router.generate_stream(p, 160)
                    for p in session_prompts[:4]]
        force(("d2",), "READY")
        sessions.append(await router.generate_stream(session_prompts[4],
                                                     160))
        placed = [s.replica_name for s in sessions]
        heads = [[await asyncio.wait_for(s.__anext__(), 120)
                  for _ in range(4)] for s in sessions]
        idle = []
        t0 = time.monotonic()
        for _ in range(64):
            event = await fire()
            idle.append(event)
            if event["result"] != "hold":
                break
        drain_s = time.monotonic() - t0
        tokens = [h + [t async for t in s] for h, s in zip(heads, sessions)]
        moved = [s.migrations for s in sessions]
        want = await asyncio.wait_for(asyncio.gather(*[
            engines["d1"].generate(p, 160) for p in session_prompts]), 600)
        return dict(
            events=[dict(result=e["result"], victim=e.get("victim"),
                         signals=e.get("signals")) for e in events],
            pressure=[e["result"] for e in pressure],
            idle=[e["result"] for e in idle], served=served,
            burst_ok=all(len(t) == 32 for t in burst), placed=placed,
            moved=moved, sessions_equal=tokens == want,
            drain_s=drain_s, warm_s=grown.get("warm_s"),
            hbm=hbm_occupancy(container), status=scaler.status(),
            rollup=router.rollup.statusz(),
            serving_compiles=engines["d0"].serving_compiles(120.0))

    # -- (a) affinity ---------------------------------------------------------
    async def affinity():
        log("== phase 33a: prefix affinity: a 256-token system prompt's "
            "wave 1, refresh, wave 2 of 8 through the router; then phase "
            "9's cold burst")
        rounds = [prefix_waves(cfg, seed + 330 + r) for r in range(2)]
        out = {"rounds": []}
        for waves in rounds:
            # wave 1 takes the fallback pick; d1 is held out of routing
            # meanwhile, so both rounds build residency on d0 and the
            # measured round replays the suffix rung the first captured
            force(("d1",), "DRAINING")
            wave1 = await asyncio.wait_for(router.generate(waves[0][0], 32),
                                           600)
            force(("d1",), "READY")
            index = await router.refresh()
            prefix0 = {n: dict(e.stats()["prefix_cache"]
                               ["admissions_by_rung"])
                       for n, e in engines.items()}
            stats0 = router.fleet_stats()["routing"]
            requests0 = requests_by_replica()
            pages0 = series("app_tpu_fleet_affinity_pages")
            outs, wall, ttfts = await routed_burst(
                router, waves[1], 32, samplings, 600)
            pages1 = series("app_tpu_fleet_affinity_pages")
            holders = sorted(n for n, k in requests_by_replica().items()
                             if k > requests0.get(n, 0))
            holder = holders[0]
            prefix1 = dict(engines[holder].stats()["prefix_cache"]
                           ["admissions_by_rung"])
            stats1 = router.fleet_stats()["routing"]
            out["rounds"].append(dict(
                wave1=len(wave1), index=index,
                # the affinity depths observed: routes, pages in all, and
                # routes by histogram bucket
                pages=(pages1[0] - pages0[0], pages1[1] - pages0[1],
                       [b - a for a, b in zip(pages0[2], pages1[2])]),
                holders=holders,
                affinity=stats1["affinity"] - stats0["affinity"],
                fallback=stats1["fallback"] - stats0["fallback"],
                admissions_by_rung={
                    r: n - prefix0[holder].get(r, 0)
                    for r, n in prefix1.items()
                    if n > prefix0[holder].get(r, 0)},
                outs=outs, ttfts=ttfts, wall=wall, holder=holder))
        last = out["rounds"][-1]
        cold = next(n for n in ("d0", "d1") if n != last["holder"])
        # the same wave 2 straight to the replica without the prefix: a
        # single paged engine with the store on, full prefills
        outs, wall, ttfts = await routed_burst(
            engines[cold], rounds[-1][1], 32, samplings, 600)
        out["cold"] = dict(replica=cold, outs=outs, ttfts=ttfts, wall=wall)
        # phase 9's cold burst: every request a fallback, split by least
        # in-flight
        stats0 = router.fleet_stats()["routing"]
        requests0 = {n: registry._replicas[n].requests for n in engines
                     if registry._replicas[n].state == "READY"}
        outs, wall, ttfts = await routed_burst(router, prompts, 32,
                                               samplings, 600)
        stats1 = router.fleet_stats()["routing"]
        out["burst"] = dict(
            outs=outs, wall=wall, ttfts=ttfts,
            affinity=stats1["affinity"] - stats0["affinity"],
            fallback=stats1["fallback"] - stats0["fallback"],
            split={n: registry._replicas[n].requests - k
                   for n, k in requests0.items()})
        return out

    # -- (b) migration and drain ---------------------------------------------
    async def migration():
        log("== phase 33b: migrate_session after 8 of 32 tokens on a "
            "300-token prompt, greedy and sampled; then router.drain(d0) "
            "with 4 live sessions")
        out = {"migrate": []}
        sampled = generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)
        want_sampled = await engines["d1"].generate(prompts[5], 32,
                                                    sampling=sampled)
        for name, sampling, want in (
                ("greedy", None, mono[5]),
                ("sampled", generate.Sampling(temperature=0.8, top_p=0.95,
                                              seed=seed), want_sampled)):
            session = await router.generate_stream(prompts[5], 32,
                                                   sampling=sampling)
            got = [await asyncio.wait_for(session.__anext__(), 120)
                   for _ in range(8)]
            source = session.replica_name
            target_name = next(n for n in ("d0", "d1") if n != source)
            inflight = engines[source]._ticks_inflight
            prefill0 = engines[target_name].stats()["prefill_bucket_tokens"]
            mark = migration_mark()
            t0 = time.perf_counter()
            target = await router.migrate_session(session)
            call_s = time.perf_counter() - t0
            got += [t async for t in session]
            out["migrate"].append(dict(
                name=name, equal=got == want, source=source, target=target,
                ticks_inflight=inflight, call_s=call_s,
                noted=migrations_since(mark),
                prefill_moved=engines[target].stats()
                ["prefill_bucket_tokens"] - prefill0))
        # drain: 4 live sessions on d0 (d1 held out of routing while they
        # are admitted), then router.drain("d0"); a budget long enough
        # that each is still decoding when its turn to migrate comes
        refs = await asyncio.wait_for(asyncio.gather(*[
            engines["d0"].generate(p, DRAIN_BUDGET) for p in prompts[:4]]),
            600)
        pool = engines["d0"]._pool
        baseline = pool.free_pages
        force(("d1",), "DRAINING")
        sessions = [await router.generate_stream(p, DRAIN_BUDGET)
                    for p in prompts[:4]]
        force(("d1",), "READY")
        heads = [[await asyncio.wait_for(s.__anext__(), 120)
                  for _ in range(2)] for s in sessions]
        placed = [s.replica_name for s in sessions]
        mark = migration_mark()
        t0 = time.monotonic()
        drained = await router.drain("d0")
        drain_s = time.monotonic() - t0
        tokens = [h + [t async for t in s] for h, s in zip(heads, sessions)]
        rest_s = time.monotonic() - t0 - drain_s
        for _ in range(200):
            if pool.free_pages == baseline:
                break
            await asyncio.sleep(0.01)
        registry.resume("d0")
        out["drain"] = dict(
            drained=drained, placed=placed,
            finished_on=[s.replica_name for s in sessions],
            equal=tokens == refs,
            greedy_is_phase9=[r[:32] for r in refs] == mono[:4],
            free_pages=pool.free_pages, baseline=baseline,
            drain_s=drain_s, rest_s=rest_s,
            migrations=migrations_since(mark))
        return out

    # -- (c) resume -------------------------------------------------------------
    async def resume():
        log("== phase 33c: crash_mid_decode:@5 and crash_mid_migration:@1, "
            "each healed by a resume on the peer")
        out = []
        for site in ("crash_mid_decode:@5", "crash_mid_migration:@1"):
            prompt = prompts[5]
            resumes0 = router.fleet_stats()["resumes"]["ok"]
            session = await router.generate_stream(prompt, 32)
            got = []
            if site.startswith("crash_mid_decode"):
                faults.install(faults.FaultPlan(site))
            else:
                got = [await asyncio.wait_for(session.__anext__(), 120)
                       for _ in range(4)]
                faults.install(faults.FaultPlan(site))
                try:
                    await router.migrate_session(session)
                except faults.FaultError:
                    pass
                else:
                    raise AssertionError("phase 33c: crash_mid_migration "
                                         "did not fire")
            source = session.replica_name
            emitted_at_crash = []

            resume = router._resume_session

            async def watched(sess, exc, _resume=resume):
                emitted_at_crash.append(list(sess._emitted))
                return await _resume(sess, exc)
            router._resume_session = watched
            try:
                got += [t async for t in session]
            finally:
                router._resume_session = resume
                faults.reset()
            emitted = emitted_at_crash[0]
            peer = engines[session.replica_name]
            fresh = await peer.generate(prompt + emitted, 32 - len(emitted))
            cont = got[len(emitted):]
            out.append(dict(
                site=site, length=len(got), source=source,
                peer=session.replica_name, emitted=len(emitted),
                head_equal=got[:len(emitted)] == mono[5][:len(emitted)],
                continuation_fresh=cont == fresh,
                continuation_same_as_uninterrupted=sum(
                    a == b for a, b in zip(cont, mono[5][len(emitted):])),
                resumes=router.fleet_stats()["resumes"]["ok"] - resumes0))
        return out

    async def main():
        out = {}
        warm = {}
        for name, engine in engines.items():
            for mod in mods:
                mod.reset_launches()
            warm[name] = await warm_replica(engine)
            out.setdefault("warmup_formula", []).append(
                (read_launches(mods),
                 graph_launches(captured_graphs(engine), 2)))
        for name, engine in engines.items():
            attach(name, engine)
            await engine.start()
        try:
            out["hbm_start"] = hbm_occupancy(SimpleNamespace(
                tpu=engines["d0"]))
            for mod in mods:
                mod.reset_launches()
            for name, engine in engines.items():
                base[name] = counters_with_keys(engine)
            t0 = time.monotonic()
            out["d"] = await autoscale()
            out["d_s"] = time.monotonic() - t0
            await engines["d2"].stop()
            t0 = time.monotonic()
            out["a"] = await affinity()
            out["a_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            out["b"] = await migration()
            out["b_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            out["c"] = await resume()
            out["c_s"] = time.monotonic() - t0
            torch.cuda.synchronize()
            out["launches"] = read_launches(mods)
            want = dict(extra)
            for name, engine in engines.items():
                add_launches(want, served_launches(cfg, engine, base[name]))
            out["want"] = want
            out["lazy"] = {n: e.stats()["graphs"]["lazy_captures"]
                           - base[n]["lazy_captures"]
                           for n, e in engines.items()}
            out["prefill_lazy"] = {
                n: e.stats()["graphs"]["prefill"]["lazy_captures"]
                - base[n]["prefill_lazy"] for n, e in engines.items()}
            out["stats"] = router.fleet_stats()
            out["warm_s"] = warm
        finally:
            for engine in engines.values():
                await engine.stop()
        return out

    out = asyncio.run(main())
    for measured, formula in out["warmup_formula"]:
        if measured != formula:
            raise AssertionError(f"phase 33: a warmup launched {measured}, "
                                 f"its graphs account for {formula}")
    d, a, b, c = out["d"], out["a"], out["b"], out["c"]
    sources = sorted({(e["signals"] or {}).get("source")
                      for e in d["events"]} - {None})
    log(f"33d: events {[(e['result'], e['victim']) for e in d['events']]}; "
        f"signal sources {sources}; "
        f"pressure firings {d['pressure']}, idle firings {d['idle']}; "
        f"d2 warmed in {d['warm_s']:.2f}s; next burst by replica "
        f"{d['served']}; sessions placed {d['placed']}, migrations "
        f"{d['moved']}, equal to their streams alone {d['sessions_equal']}; "
        f"drain firings {d['drain_s']:.3f}s; HBM occupancy at start "
        f"{out['hbm_start']:.4f}, after {d['hbm']:.4f}; d0 serving compiles "
        f"{d['serving_compiles']}; rollup {d['rollup']['signals']}")
    results_d = [e["result"] for e in d["events"]]
    if results_d.count("up") != 1 or results_d.count("down") != 1 \
            or results_d.index("up") > results_d.index("down") \
            or set(results_d) - {"hold", "up", "down"}:
        raise AssertionError(f"phase 33d: autoscaler events {results_d}: "
                             f"expected holds, one up, then one down")
    victim = next(e["victim"] for e in d["events"] if e["result"] == "down")
    if victim != "d2" or sorted(d["moved"]) != [0, 0, 0, 0, 1] \
            or not d["sessions_equal"] or not d["served"].get("d2") \
            or not d["burst_ok"]:
        raise AssertionError(f"phase 33d: victim {victim}, migrations "
                             f"{d['moved']}, sessions equal "
                             f"{d['sessions_equal']}, d2 served "
                             f"{d['served']}")
    if d["hbm"] is None or d["hbm"] >= 0.85:
        raise AssertionError(f"phase 33d: HBM occupancy {d['hbm']}")
    for r, rnd in enumerate(a["rounds"]):
        log(f"33a round {r}: wave 2 routed to {rnd['holders']}; affinity "
            f"pages (routes, pages, by bucket {page_buckets}) "
            f"{rnd['pages']}; affinity {rnd['affinity']}, fallback "
            f"{rnd['fallback']}; holder admissions by prefix rung "
            f"{rnd['admissions_by_rung']}; TTFT p50 "
            f"{rnd['ttfts'][len(rnd['ttfts']) // 2]:.4f}s")
    last = a["rounds"][-1]
    cold = a["cold"]
    log(f"33a: wave 2 through affinity: TTFT p50 "
        f"{last['ttfts'][4]:.4f}s max {last['ttfts'][-1]:.4f}s, "
        f"{last['wall']:.3f}s; the same wave straight to the cold replica "
        f"{cold['replica']}: TTFT p50 {cold['ttfts'][4]:.4f}s max "
        f"{cold['ttfts'][-1]:.4f}s, {cold['wall']:.3f}s; greedy tokens "
        f"equal {last['outs'][:7] == cold['outs'][:7]}, sampled "
        f"{last['outs'][7] == cold['outs'][7]}")
    burst = a["burst"]
    log(f"33a: phase 9's cold burst: affinity {burst['affinity']}, fallback "
        f"{burst['fallback']}, split {burst['split']}; greedy tokens phase "
        f"9's {burst['outs'][:7] == mono}; {256 / burst['wall']:.1f} tok/s, "
        f"TTFT p50 {burst['ttfts'][4]:.4f}s")
    # 8 routes of 64 pages in all, each in the bucket (4, 8]: each at the
    # system prompt's 8 pages
    pages8 = (8, 64.0, [8 if b == 8 else 0 for b in page_buckets])
    for rnd in a["rounds"]:
        if rnd["affinity"] != 8 or rnd["fallback"] != 0 \
                or len(rnd["holders"]) != 1 or rnd["pages"] != pages8 \
                or rnd["admissions_by_rung"] != {PREFIX_RUNG: 8}:
            raise AssertionError(f"phase 33a: wave 2 must take 8 affinity "
                                 f"routes to one holder at 8 pages: {rnd}")
    if last["outs"][:7] != cold["outs"][:7]:
        raise AssertionError("phase 33a: wave 2's greedy tokens through "
                             "affinity differ from a single paged engine's "
                             "with the store on")
    if burst["affinity"] or burst["fallback"] != 8 \
            or sorted(burst["split"].values()) != [4, 4] \
            or burst["outs"][:7] != mono:
        raise AssertionError(f"phase 33a: the cold burst: {burst['split']}, "
                             f"affinity {burst['affinity']}")
    for m in b["migrate"]:
        log(f"33b {m['name']}: {m['source']} -> {m['target']} with "
            f"{m['ticks_inflight']} ticks in flight; stream equal "
            f"{m['equal']}; {m['noted']['bytes']:.0f} bytes, downtime "
            f"{m['noted']['downtime_s'] * 1e3:.2f} ms (call "
            f"{m['call_s'] * 1e3:.2f} ms); "
            f"target prefill_bucket_tokens moved {m['prefill_moved']}")
        if not m["equal"] or m["prefill_moved"] or m["ticks_inflight"] < 1 \
                or m["noted"]["ok"] != 1 or m["noted"]["failed"]:
            raise AssertionError(f"phase 33b: migration {m}")
    dr = b["drain"]
    log(f"33b drain: sessions on {dr['placed']} finished on "
        f"{dr['finished_on']}, drained {dr['drained']} in "
        f"{dr['drain_s']:.3f}s, the rest of their decode "
        f"{dr['rest_s']:.3f}s; migrations {dr['migrations']['ok']} ok, "
        f"{dr['migrations']['failed']} failed, downtime "
        f"{dr['migrations']['downtime_s']:.4f}s and "
        f"{dr['migrations']['bytes']:.0f} bytes in all; tokens equal "
        f"{dr['equal']} (phase 9's {dr['greedy_is_phase9']}); d0 free pages "
        f"{dr['free_pages']} (baseline {dr['baseline']})")
    if not dr["drained"] or dr["placed"] != ["d0"] * 4 \
            or dr["finished_on"] != ["d1"] * 4 or not dr["equal"] \
            or dr["free_pages"] != dr["baseline"] \
            or dr["migrations"]["ok"] != 4 or dr["migrations"]["failed"]:
        raise AssertionError(f"phase 33b: drain {dr}")
    for r in c:
        log(f"33c {r['site']}: {r['source']} -> {r['peer']}, {r['length']} "
            f"tokens, {r['emitted']} delivered before the crash (equal to "
            f"the uninterrupted stream's: {r['head_equal']}); continuation "
            f"= a fresh request of prompt + emitted: "
            f"{r['continuation_fresh']}; continuation tokens equal to the "
            f"uninterrupted run's: {r['continuation_same_as_uninterrupted']}"
            f" of {32 - r['emitted']}; resumes {r['resumes']}")
        if r["length"] != 32 or not r["head_equal"] \
                or not r["continuation_fresh"] or r["resumes"] != 1 \
                or r["peer"] == r["source"]:
            raise AssertionError(f"phase 33c: resume {r}")
    log(f"33: lazy tick captures {out['lazy']}, lazy prefill captures "
        f"{out['prefill_lazy']}; fleet {out['stats']['routing']}, "
        f"{out['stats']['migrations']}, {out['stats']['resumes']}; "
        f"(d) {out['d_s']:.1f}s, (a) {out['a_s']:.1f}s, (b) "
        f"{out['b_s']:.1f}s, (c) {out['c_s']:.1f}s; launches "
        f"{out['launches']}")
    if any(out["lazy"].values()):
        raise AssertionError(f"phase 33: lazy tick captures {out['lazy']}")
    check_launches(out["launches"], out["want"], "fleet")
    results["fleet"] = dict(
        autoscale={k: v for k, v in d.items() if k != "status"},
        affinity=dict(rounds=[{k: v for k, v in r.items() if k != "outs"}
                              for r in a["rounds"]],
                      cold={k: v for k, v in cold.items() if k != "outs"},
                      burst={k: v for k, v in burst.items()
                             if k != "outs"}),
        migration=b["migrate"],
        drain={k: v for k, v in dr.items()}, resume=c,
        stats=out["stats"], launches=out["launches"],
        lazy_prefill=out["prefill_lazy"], warm_s=out["warm_s"],
        seconds=dict(d=out["d_s"], a=out["a_s"], b=out["b_s"],
                     c=out["c_s"]))
    results["phase33_fleet_s"] = time.monotonic() - t_phase
    log(f"phase 33 (a-d): {results['phase33_fleet_s']:.1f}s")
    del engines, router, registry
    torch.cuda.empty_cache()
    return {"fleet": out["launches"]}


# the tuner's engine: the example app's dense engine, detuned: one bucket
# and one step a tick
TUNE_ENGINE = dict(SMALL_ENGINE, prompt_buckets=(512,), steps_per_tick=1)
TUNE_LENS = (3, 5, 8, 12, 17, 21, 26, 30, 33, 36, 38, 40)
# new tokens a request of the staging-depth bursts
STAGING_BUDGET = 256
# reserved bytes a firing may leave beyond the live engine's prewarmed
# graphs: the caching allocator's segment rounding (its large segments are
# 20 MiB)
CLONE_BYTES_NOISE = 64 << 20


def phase_autotune(torch, generate, autotune, faults, mods, cfg, params,
                   seed, results):
    """Phase 33e (after phase 32d, on phase 20's ``small`` weights): the
    ``AutoTuner`` over the example's dense engine at a detuned point
    (buckets (512,), k 1), with a ``TrafficRecorder`` and real shadow
    replay, as ``scripts/autotune_smoke.py`` drives it: applied, firings
    until a rejection, served again with no serving compile, a forced
    worst pick rolled back; the same score twice; a burst during a
    scoring pass equals the burst without; the clones' bytes released;
    tok/s at staging depth 1 against the live depth, in turns. Returns
    launches by path."""
    import numpy as np

    from gofr_tpu_torch.tpu.workload import TrafficRecorder

    t_phase = time.monotonic()
    log("== phase 33e: the AutoTuner on small at the example's dense "
        "engine, detuned to buckets (512,) and k 1, scored by shadow "
        "replay")
    rng = np.random.default_rng(seed + 34)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in TUNE_LENS]
    engine = generate.GenerationEngine(cfg, params, device="cuda",
                                       model_name="small", **TUNE_ENGINE)
    recorder = TrafficRecorder(capacity=128)
    engine.attach_workload(recorder)
    clones = []               # (counters, lazily captured tick graphs)
    shadow_clone = engine.shadow_clone

    def counted_clone(point=None):
        clone = shadow_clone(point)
        stop = clone.stop

        async def stopped():
            await stop()
            clones.append((run_counters(clone),
                           graph_launches(clone._graphs.values())))
        clone.stop = stopped
        return clone
    engine.shadow_clone = counted_clone
    prewarms = []             # (graphs captured, their launches, bytes)
    prewarm = engine.prewarm_operating_point

    async def settled_bytes():
        # a stopped clone is freed once the loop has run its pending
        # callbacks
        await asyncio.sleep(0.05)
        return reserved_bytes(torch)

    async def counted_prewarm(point):
        keys = set(engine._graphs) | {k for k, r in engine._prefills.items()
                                      if r.graph is not None}
        before = await settled_bytes()
        warm = await prewarm(point)
        new = [g for k, g in engine._graphs.items() if k not in keys] + [
            r for k, r in engine._prefills.items()
            if r.graph is not None and k not in keys]
        prewarms.append((len(new), graph_launches(new, 2),
                         await settled_bytes() - before))
        return warm
    engine.prewarm_operating_point = counted_prewarm

    async def serve(budget=3):
        return await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, budget, eos_id=None) for p in prompts]), 600)

    async def main():
        out = {}
        await engine.warmup(prompt_counts=(1, 2, 4, 8))
        await engine.start()
        try:
            for mod in mods:
                mod.reset_launches()
            before = counters_with_keys(engine)
            await serve()
            out["compiles"] = [engine.serving_compiles(3600.0)]
            out["seed_point"] = engine.operating_point()
            goodput = {"value": 100.0}
            tuner = autotune.AutoTuner(
                engine, workload=recorder, improve_after=1, cooldown_s=0.0,
                probation_ticks=1, min_trace_events=8,
                goodput_fn=lambda: goodput["value"])
            passes = []
            score_point = tuner._score_point

            async def timed(point, trace):
                t0 = time.monotonic()
                score = await score_point(point, trace)
                passes.append(time.monotonic() - t0)
                return score
            tuner._score_point = timed
            torch.cuda.reset_peak_memory_stats()
            out["bytes_before"] = await settled_bytes()
            after_firing = []        # (reserved bytes, of them prewarms')
            steps = []
            for n in range(9):
                t0 = time.monotonic()
                event = await tuner()
                steps.append(dict(result=event["result"],
                                  score=event.get("score"),
                                  baseline=event.get("baseline"),
                                  point=event.get("point"),
                                  seconds=time.monotonic() - t0))
                after_firing.append((await settled_bytes(),
                                     sum(p[2] for p in prewarms)))
                if n == 0:
                    out["applied"] = engine.operating_point()
                elif event["result"] not in ("applied", "probation"):
                    break
            out["probation"] = tuner.status()["probation"]
            await serve()
            out["compiles"].append(engine.serving_compiles(3600.0))
            out["tuned"] = engine.operating_point()
            faults.install(faults.FaultPlan(autotune.FAULT_SITE_SELECT))
            try:
                event = await tuner()
            finally:
                faults.install(None)
            steps.append(dict(result=event["result"],
                              forced=event.get("forced"),
                              point=event.get("point")))
            goodput["value"] = 5.0
            event = await tuner()
            steps.append(dict(result=event["result"],
                              point=event.get("point")))
            after_firing.append((await settled_bytes(),
                                 sum(p[2] for p in prewarms)))
            out["restored"] = engine.operating_point()
            out["compiles"].append(engine.serving_compiles(3600.0))
            out["steps"], out["passes"] = steps, passes
            out["bytes_after"] = after_firing
            out["bytes_peak"] = torch.cuda.max_memory_reserved()
            out["rollbacks"] = tuner.status()["rollbacks"]
            # the same (point, trace) scored twice, the second time with
            # a greedy burst on the live engine meanwhile
            trace = tuner._load_trace()
            point = autotune.OperatingPoint.from_engine(engine)
            alone = await serve(32)
            one = await tuner._score_point(point, trace)
            two, during = await asyncio.gather(
                tuner._score_point(point, trace), serve(32))
            out["scores"] = (one, two)
            out["during_equal"] = during == alone
            # staging depth 1 against the live depth, in turns, each a
            # burst of STAGING_BUDGET tokens a request; the pinned slabs
            # after each (a lowered depth shrinks the rings it uploads
            # through)
            live = engine.operating_point()["staging_depth"]
            tok_s = {live: [], 1: []}
            slabs = {live: [], 1: []}
            for depth in (live, 1, 1, live, live, 1):
                engine.apply_operating_point(
                    autotune.OperatingPoint(staging_depth=depth),
                    source="autotune")
                t0 = time.monotonic()
                await serve(STAGING_BUDGET)
                tok_s[depth].append(STAGING_BUDGET * len(prompts)
                                    / (time.monotonic() - t0))
                slabs[depth].append(engine._staging.stats()["slab_bytes"])
            out["staging_tok_s"], out["staging_slab_bytes"] = tok_s, slabs
            out["compiles"].append(engine.serving_compiles(3600.0))
            torch.cuda.synchronize()
            out["launches"] = read_launches(mods)
            out["prewarms"] = [(n, nbytes) for n, _, nbytes in prewarms]
            out["clones"] = len(clones)
            want = served_launches(cfg, engine, before)
            for counters, lazy in clones:
                add_launches(want, expected_launches(cfg, counters))
                add_launches(want, lazy)
            for _, launches, _ in prewarms:
                add_launches(want, launches)
            out["want"] = want
            out["lazy"] = engine.lazy_captures
        finally:
            await engine.stop()
        return out

    out = asyncio.run(main())
    steps = out["steps"]
    log(f"33e: firings {[s['result'] for s in steps]}; applied "
        f"{out['applied']['prompt_buckets']} k "
        f"{out['applied']['steps_per_tick']} (score {steps[0]['score']:.4f} "
        f"against {steps[0]['baseline']:.4f}); tuned "
        f"{out['tuned']['prompt_buckets']} k {out['tuned']['steps_per_tick']}"
        f"; restored {out['restored']['prompt_buckets']} k "
        f"{out['restored']['steps_per_tick']} source "
        f"{out['restored']['source']}; serving compiles {out['compiles']}")
    passes = out["passes"]
    log(f"33e: {len(passes)} scoring passes, {sum(passes) / len(passes):.3f}"
        f" s each (min {min(passes):.3f}, max {max(passes):.3f}); firings "
        f"{[round(s.get('seconds', 0), 2) for s in steps]} s; reserved "
        f"bytes before {out['bytes_before']}, after each firing (of them "
        f"the live engine's prewarmed graphs) {out['bytes_after']}, peak "
        f"{out['bytes_peak']}; prewarms (graphs, bytes) {out['prewarms']}")
    # what the clones left: the bytes after each firing beyond the live
    # engine's own prewarmed graphs
    left = [nbytes - warm - out["bytes_before"]
            for nbytes, warm in out["bytes_after"]]
    log(f"33e: the same score twice {out['scores'][0] == out['scores'][1]} "
        f"({out['scores'][0]!r}); burst during a scoring pass equal "
        f"{out['during_equal']}; tok/s at staging depth "
        f"{out['staging_tok_s']} ({len(prompts)} x {STAGING_BUDGET} tokens "
        f"a burst), pinned slab bytes after each {out['staging_slab_bytes']}"
        f"; {out['clones']} shadow clones, bytes left after each firing "
        f"{left}")
    results_e = [s["result"] for s in steps]
    if results_e[0] != "applied" or results_e[-1] != "rolled_back" \
            or results_e[-3] not in ("rejected", "hold") \
            or not steps[-2].get("forced") \
            or steps[0]["score"] <= steps[0]["baseline"] \
            or out["applied"]["source"] != "autotune" \
            or out["applied"]["generation"] != 1 \
            or max(out["applied"]["prompt_buckets"]) >= 512:
        raise AssertionError(f"phase 33e: tuner firings {steps}")
    if out["restored"]["source"] != "rollback" \
            or out["restored"]["prompt_buckets"] \
            != out["tuned"]["prompt_buckets"] or out["rollbacks"] != 1:
        raise AssertionError(f"phase 33e: rollback restored "
                             f"{out['restored']}, tuned {out['tuned']}")
    if any(out["compiles"]) or out["lazy"]:
        raise AssertionError(f"phase 33e: serving compiles "
                             f"{out['compiles']}, lazy tick captures "
                             f"{out['lazy']}")
    if out["scores"][0] != out["scores"][1] or not out["during_equal"]:
        raise AssertionError("phase 33e: scoring is not deterministic or "
                             "a burst during it changed")
    slabs = out["staging_slab_bytes"]
    live = max(slabs)
    # the first burst at depth 1 came right after the first at the live
    # depth: the rings it uploaded through gave up their surplus slabs
    if slabs[1][0] >= slabs[live][0]:
        raise AssertionError(f"phase 33e: staging depth 1 left the pinned "
                             f"slabs of depth {live}: {slabs}")
    if max(left) > CLONE_BYTES_NOISE:
        raise AssertionError(f"phase 33e: the shadow clones left {left} "
                             f"reserved bytes after the firings")
    check_launches(out["launches"], out["want"], "autotune_small")
    results["autotune_small"] = {k: v for k, v in out.items()
                                 if k not in ("want",)}
    results["phase33e_s"] = time.monotonic() - t_phase
    log(f"phase 33e: {results['phase33e_s']:.1f}s")
    del engine
    torch.cuda.empty_cache()
    return {"autotune_small": out["launches"]}


# -- phase 34: the executor path (ResNet-50, BERT-base) ----------------------

EXEC_BUCKETS = (1, 4, 16, 32)     # the http-server and grpc-server examples
BATCHER_KW = dict(max_batch=32, max_delay_ms=2.0)  # the app's defaults
EXEC_REQUESTS, EXEC_INFLIGHT = 256, 64
EXEC_REL_TOL = 2e-2               # bf16 on the card against f32 on the CPU
BERT_COS_MIN = 0.999
BERT_MAX_LEN = 64                 # the grpc-server example's MAX_LEN
EXEC_TIMED = 20                   # replays (and eager runs) a bucket timed


def rel_err(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cpu_f32(torch, tree):
    """A params tree (dicts, lists) as float32 tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: cpu_f32(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cpu_f32(torch, v) for v in tree]
    return tree.detach().float().cpu()


def bucket_times(torch, executor, name, fn):
    """Per bucket: its replay bit for bit the eager run on the same static
    inputs, and the ms of a replay and of an eager run (CUDA events over
    ``EXEC_TIMED`` each, after one of each), on the executor's stream."""
    import numpy as np

    from gofr_tpu_torch.tpu.executor import tree_leaves, tree_unflatten

    model = executor._models[name]
    stream = executor._stream
    out = {}
    for bucket, exe in sorted(model.compiled.items()):
        inputs = tree_unflatten(exe.skeleton, exe.inputs)
        with torch.cuda.stream(stream):
            exe.graph.replay()
            replayed = [t.clone() for t in tree_leaves(exe.out)]
            eager = tree_leaves(fn(model.params, inputs))
            times = {}
            for kind in ("replay", "eager"):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                for _ in range(EXEC_TIMED):
                    if kind == "replay":
                        exe.graph.replay()
                    else:
                        fn(model.params, inputs)
                end.record(stream)
                end.synchronize()
                times[kind] = start.elapsed_time(end) / EXEC_TIMED
        same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
        if not same:
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(replayed, eager))
            raise AssertionError(f"phase 34 {name} bucket {bucket}: the "
                                 f"replay differs from the eager run by "
                                 f"{diff}")
        out[bucket] = dict(replay_ms=times["replay"], eager_ms=times["eager"],
                           replay_per_s=bucket / times["replay"] * 1e3,
                           eager_per_s=bucket / times["eager"] * 1e3,
                           flops=exe.flops)
        del replayed, eager
    return out


async def batcher_burst(batcher, name, examples, inflight):
    """``examples`` through the batcher, at most ``inflight`` waiting at
    once: (outputs, each request's seconds, wall seconds)."""
    sem = asyncio.Semaphore(inflight)
    seconds = [0.0] * len(examples)

    async def one(i, example):
        async with sem:
            t0 = time.perf_counter()
            out = await batcher.predict(name, example)
            seconds[i] = time.perf_counter() - t0
            return out

    t0 = time.perf_counter()
    outs = await asyncio.gather(*[one(i, e) for i, e in enumerate(examples)])
    return outs, seconds, time.perf_counter() - t0


def exec_model(torch, executor_mod, batcher_mod, name, fn, params, example,
               batches, cpu_ref, examples, gate, results, device="cuda"):
    """One model of phase 34: register at ``EXEC_BUCKETS``, ``warmup()``
    (one graph a bucket: seconds, reserved bytes), every bucket's replay
    against its eager run and both timed, the card at B 4 against the
    CPU's float32 path (``gate(card, cpu)`` returns the figures and
    raises past its limits), then ``examples`` one request each through
    the ``DynamicBatcher`` at ``EXEC_INFLIGHT`` in flight: latency p50 /
    p99, flush causes, batch fill, duty cycle and MFU, no capture."""
    import numpy as np

    from gofr_tpu_torch.metrics import Manager, register_engine_metrics

    metrics = register_engine_metrics(Manager())
    executor = executor_mod.Executor(None, metrics,
                                     peak_flops=BF16_FLOP_PER_S,
                                     device=device)
    executor.register(name, fn, params, buckets=EXEC_BUCKETS)
    cuda = device == "cuda"
    before = reserved_bytes(torch) if cuda else 0
    t0 = time.monotonic()
    executor.warmup(name, example)
    warm_s = time.monotonic() - t0
    added = (reserved_bytes(torch) - before) if cuda else 0
    events = executor.ledger.snapshot()["recent"]
    captures = {e["bucket"]: e["duration_s"] for e in events}
    if sorted(executor._models[name].compiled) != list(EXEC_BUCKETS) \
            or executor.ledger.total("warmup") != len(EXEC_BUCKETS):
        raise AssertionError(f"phase 34 {name}: warmup built "
                             f"{sorted(executor._models[name].compiled)}")
    log(f"34 {name}: warmup captured {len(captures)} graphs in "
        f"{warm_s:.2f}s (by bucket {captures}); reserved bytes "
        f"+{added}")
    timings = bucket_times(torch, executor, name, fn) if cuda else {}
    for bucket, t in timings.items():
        log(f"34 {name} bucket {bucket}: replay {t['replay_ms']:.4f} ms "
            f"({t['replay_per_s']:.1f}/s), eager {t['eager_ms']:.4f} ms "
            f"({t['eager_per_s']:.1f}/s), {t['flops']:.4g} FLOPs; replay "
            f"= eager bits")
    card = executor.predict(name, batches)
    figures = gate(card, cpu_ref)
    log(f"34 {name}: B 4 on the card against the CPU's f32 path: "
        f"{figures}")
    # the reference of each burst request: its image at the top bucket
    top = EXEC_BUCKETS[-1]
    stacked = [executor.predict(name, batcher_mod._stack(examples[i:i + top]))
               for i in range(0, len(examples), top)]
    want = np.concatenate(stacked)
    compiles = executor.ledger.total()
    busy0, flops0 = executor._busy_s.total(), executor._flops_done.total()
    hits0 = sum(executor.shapes.bucket_hits(name).values())
    sizes0 = executor.shapes.distribution(name)
    batcher = batcher_mod.DynamicBatcher(executor, metrics=metrics,
                                         **BATCHER_KW)
    outs, seconds, wall = asyncio.run(batcher_burst(batcher, name, examples,
                                                    EXEC_INFLIGHT))
    busy = executor._busy_s.total() - busy0
    flops = executor._flops_done.total() - flops0
    flushes = sum(batcher.flush_causes.values())
    sizes = {n: c - sizes0.get(n, 0)
             for n, c in executor.shapes.distribution(name).items()
             if c > sizes0.get(n, 0)}
    batch_sum = sum(n * c for n, c in sizes.items())
    hits = sum(executor.shapes.bucket_hits(name).values()) - hits0
    got = np.stack(outs)
    err = rel_err(got, want)
    if not np.isfinite(got).all() or got.shape != want.shape \
            or err > EXEC_REL_TOL:
        raise AssertionError(f"phase 34 {name}: burst outputs {got.shape} "
                             f"against {want.shape}, max rel err {err}")
    if executor.ledger.total() != compiles or hits != flushes \
            or batch_sum != len(examples):
        raise AssertionError(
            f"phase 34 {name}: {executor.ledger.total() - compiles} "
            f"captures in the burst, {hits} executes for {flushes} "
            f"flushes, {batch_sum} rows for {len(examples)} requests")
    seconds.sort()
    sat = executor.saturation(window_s=60.0)
    row = dict(warmup_s=warm_s, capture_s=captures, reserved_added=added,
               buckets=timings, gate=figures, requests=len(examples),
               in_flight=EXEC_INFLIGHT, wall_s=wall,
               requests_per_s=len(examples) / wall,
               latency_p50_s=seconds[len(seconds) // 2],
               latency_p99_s=seconds[int(len(seconds) * 0.99) - 1],
               flush_causes=dict(batcher.flush_causes), batch_sizes=sizes,
               batch_fill=batch_sum / flushes / BATCHER_KW["max_batch"],
               duty_cycle=busy / wall,
               mfu=flops / wall / BF16_FLOP_PER_S,
               burst_max_rel_err=err,
               saturation_60s={k: sat[k] for k in (
                   "duty_cycle", "mfu", "effective_mfu", "padding_ratio")},
               data_plane=executor.data_plane()["staging"])
    log(f"34 {name}: {len(examples)} requests at {EXEC_INFLIGHT} in "
        f"flight in {wall:.3f}s = {row['requests_per_s']:.1f}/s; latency "
        f"p50 {row['latency_p50_s'] * 1e3:.3f} ms p99 "
        f"{row['latency_p99_s'] * 1e3:.3f} ms; flushes "
        f"{row['flush_causes']}, batch sizes {sizes}, fill "
        f"{row['batch_fill']:.3f}; duty cycle {row['duty_cycle']:.4f}, "
        f"MFU {row['mfu']:.4f} (peak {BF16_FLOP_PER_S:.3g}); no capture "
        f"in the burst; max rel err against the top bucket {err:.3e}")
    results[f"exec_{name}"] = row
    executor.close()
    return row


def phase_executor(torch, executor_mod, batcher_mod, resnet, bert, seed,
                   results, rcfg=None, bcfg=None, device="cuda"):
    """Phase 34: the executor path at full width, bf16: (a) ResNet-50 at
    224 x 224, 1000 classes; (b) BERT-base at max_len 64, its ``mean``
    embedding; each at the examples' buckets (1, 4, 16, 32) and through
    the ``DynamicBatcher`` at the app's defaults."""
    import numpy as np

    t_phase = time.monotonic()
    rng = np.random.default_rng(seed + 40)
    rcfg = rcfg or resnet.config("50")
    log(f"== phase 34a: ResNet-{sum(rcfg.stage_sizes) * 3 + 2} "
        f"({rcfg.image_size}^2, {rcfg.num_classes} classes, bf16) through "
        f"the Executor, buckets {EXEC_BUCKETS}, and the DynamicBatcher "
        f"{BATCHER_KW}")
    rparams = resnet.init(rcfg, seed + 41, device=device)

    def rfn(p, x):
        return resnet.apply(p, rcfg, x)

    size = rcfg.image_size
    images = rng.standard_normal((EXEC_REQUESTS, size, size, 3)).astype(
        np.float32)
    cpu_cfg = dataclasses.replace(rcfg, dtype=torch.float32)
    ref = resnet.apply(cpu_f32(torch, rparams), cpu_cfg,
                       torch.from_numpy(images[:4])).numpy()

    def rgate(card, cpu):
        err = rel_err(card, cpu)
        top1 = float((card.argmax(-1) == cpu.argmax(-1)).mean())
        if not np.isfinite(card).all() or err > EXEC_REL_TOL:
            raise AssertionError(f"phase 34a: ResNet B 4 on the card "
                                 f"against the CPU f32: max|d|/max|ref| "
                                 f"{err} > {EXEC_REL_TOL}")
        return dict(max_rel_err=err, limit=EXEC_REL_TOL, top1_agree=top1)

    exec_model(torch, executor_mod, batcher_mod, "resnet50", rfn, rparams,
               images[0], images[:4], ref, list(images), rgate, results,
               device)
    del rparams
    if device == "cuda":
        torch.cuda.empty_cache()

    bcfg = bcfg or bert.config("base", max_len=BERT_MAX_LEN)
    log(f"== phase 34b: BERT ({bcfg.n_layers} layers, dim {bcfg.dim}, "
        f"max_len {bcfg.max_len}, bf16) mean embeddings through the "
        f"Executor, buckets {EXEC_BUCKETS}, and the DynamicBatcher")
    bparams = bert.init(bcfg, seed + 42, device=device)

    def bfn(p, inputs):
        ids, mask = inputs
        return bert.apply(p, bcfg, ids, mask)["mean"]

    lengths = rng.integers(5, bcfg.max_len + 1, EXEC_REQUESTS)
    ids = rng.integers(0, bcfg.vocab_size,
                       (EXEC_REQUESTS, bcfg.max_len)).astype(np.int32)
    mask = (np.arange(bcfg.max_len)[None] < lengths[:, None]).astype(
        np.int32)
    ids *= mask
    cpu_bcfg = dataclasses.replace(bcfg, dtype=torch.float32)
    bref = bert.apply(cpu_f32(torch, bparams), cpu_bcfg,
                      torch.from_numpy(ids[:4]),
                      torch.from_numpy(mask[:4]))["mean"].numpy()

    def bgate(card, cpu):
        err = rel_err(card, cpu)
        cos = float(((card * cpu).sum(-1) / np.linalg.norm(card, axis=-1)
                     / np.linalg.norm(cpu, axis=-1)).min())
        if not np.isfinite(card).all() or err > EXEC_REL_TOL \
                or cos < BERT_COS_MIN:
            raise AssertionError(f"phase 34b: BERT B 4 on the card against "
                                 f"the CPU f32: max rel err {err} (limit "
                                 f"{EXEC_REL_TOL}), min cosine {cos} "
                                 f"(limit {BERT_COS_MIN})")
        return dict(max_rel_err=err, limit=EXEC_REL_TOL, min_cosine=cos,
                    cosine_limit=BERT_COS_MIN)

    examples = [(ids[i], mask[i]) for i in range(EXEC_REQUESTS)]
    exec_model(torch, executor_mod, batcher_mod, "bert", bfn, bparams,
               examples[0], (ids[:4], mask[:4]), bref, examples, bgate,
               results, device)
    results["exec_bert"]["token_counts"] = [int(lengths.min()),
                                            int(lengths.max())]
    del bparams
    if device == "cuda":
        torch.cuda.empty_cache()
    results["phase34_s"] = time.monotonic() - t_phase
    log(f"phase 34: {results['phase34_s']:.1f}s")


# -- phase 35: the batch lane beside interactive traffic; the pool wedge ------

LANE_JOBS, LANE_NEW = 32, 64
LANE_TOPIC = "gen-jobs"
INTERACTIVE_BUDGET_MS = 2000.0    # sched's interactive budget: the class
PATH_KERNELS.update({"lane_small": ("flash", "ragged"),
                     "wedge_small": ("flash", "ragged"),
                     "wedge_small_spec": ("flash", "verify",
                                          "flash_decode")})


async def drain_topic(broker, topic, count, timeout=120.0):
    out = []
    for _ in range(count):
        message = await asyncio.wait_for(broker.subscribe(topic), timeout)
        out.append(json.loads(message.value.decode()))
    return out


async def interactive_burst(slo, engine, prompts, budget, samplings):
    """Phase 20's burst, each request under an interactive deadline and
    streamed: (outputs, sorted client-side TTFTs, wall seconds)."""
    async def one(prompt, sampling):
        slo.set_request_deadline(INTERACTIVE_BUDGET_MS)
        t0 = time.monotonic()
        stream = await engine.generate_stream(prompt, budget,
                                              sampling=sampling)
        tokens, ttft = [], None
        async for tok in stream:
            if ttft is None:
                ttft = time.monotonic() - t0
            tokens.append(tok)
        return tokens, ttft

    t0 = time.monotonic()
    done = await asyncio.wait_for(asyncio.gather(*[
        one(p, s) for p, s in zip(prompts, samplings)]), 300)
    wall = time.monotonic() - t0
    return [t for t, _ in done], sorted(f for _, f in done), wall


def phase_batch_lane(torch, generate, lane_mod, pubsub, slo, sched, mods,
                     cfg, params, seed, results, engine_kw=None,
                     device="cuda"):
    """Phase 35a: the example's dense engine with a ``BatchLane`` over the
    port's ``InMemoryBroker``: phase 20's interactive burst (under an
    interactive deadline) with the lane off, on, on, off in turns, 32
    jobs of 64-256 prompt tokens and 64 new tokens each on-turn. Returns
    launches by path."""
    import numpy as np

    t_phase = time.monotonic()
    engine_kw = engine_kw or SMALL_ENGINE
    log(f"== phase 35a: the batch lane on {cfg.n_layers}-layer dim "
        f"{cfg.dim} at the example's engine {engine_kw}: {LANE_JOBS} jobs "
        f"of 64-256 prompt tokens x {LANE_NEW} new beside phase 20's "
        f"interactive burst, lane off, on, on, off")
    rng = np.random.default_rng(seed + 50)
    jobs = [dict(id=f"job-{i}",
                 prompt_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                 max_new_tokens=LANE_NEW)
            for i, n in enumerate(rng.integers(64, 257, LANE_JOBS))]
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine = generate.GenerationEngine(cfg, params, device=device,
                                       **engine_kw)
    broker = pubsub.InMemoryBroker()
    from gofr_tpu_torch.metrics import Manager, register_engine_metrics

    metrics = register_engine_metrics(Manager())
    lane = lane_mod.BatchLane(engine, broker, LANE_TOPIC, poll_s=0.005,
                              metrics=metrics)

    async def main():
        await warm(engine)
        await engine.start()
        try:
            await engine.generate(prompts[0], 8)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            served0 = dict(engine.stats()["classes"]["served"])
            turns, lane_results = [], []
            for on in (False, True, True, False):
                if on:
                    await lane.start()
                    t_lane = time.monotonic()
                    for job in jobs:
                        broker.publish(LANE_TOPIC, json.dumps(job).encode())
                outs, ttfts, wall = await interactive_burst(
                    slo, engine, prompts, budget, samplings)
                turn = dict(lane=on, tokens_per_s=budget * len(outs) / wall,
                            ttft_p50_s=ttfts[len(ttfts) // 2],
                            ttft_max_s=ttfts[-1], wall_s=wall,
                            greedy_outputs=outs[:7])
                if on:
                    got = await drain_topic(broker, lane.result_topic,
                                            LANE_JOBS)
                    lane_wall = time.monotonic() - t_lane
                    turn.update(lane_wall_s=lane_wall,
                                lane_tokens_per_s=sum(
                                    len(r["tokens"]) for r in got)
                                / lane_wall)
                    lane_results.append({r["id"]: r["tokens"] for r in got})
                    if not await lane.drain(60.0):
                        raise AssertionError("phase 35a: the lane did not "
                                             "drain")
                turns.append(turn)
            served = {k: v - served0.get(k, 0) for k, v in
                      engine.stats()["classes"]["served"].items()}
            launches = read_launches(mods)
            after = run_counters(engine)
            counters = {key: after[key] - before[key] for key in after}
            # a malformed job is dead-lettered; the consumer keeps going
            await lane.start()
            broker.publish(LANE_TOPIC, b"not json \xff")
            broker.publish(LANE_TOPIC, json.dumps(jobs[0]).encode())
            dead = await drain_topic(broker, lane.dead_letter_topic, 1)
            after_dead = await drain_topic(broker, lane.result_topic, 1)
            await lane.stop()
            # a backlog past pause_depth pauses a lane, which resumes
            # below resume_depth
            gate = lane_mod.BatchLane(engine, broker, "gated-jobs",
                                      pause_depth=4, resume_depth=1,
                                      poll_s=0.005, metrics=metrics)
            backlog = [asyncio.ensure_future(engine.generate(
                job["prompt_ids"], LANE_NEW)) for job in jobs[:24]]
            await asyncio.sleep(0)
            depth = engine.admission_depth()
            await gate.start()
            broker.publish("gated-jobs", json.dumps(jobs[1]).encode())
            t_pause = time.monotonic()
            while not gate.paused and time.monotonic() - t_pause < 10:
                await asyncio.sleep(0.002)
            paused = gate.paused
            await asyncio.gather(*backlog)
            gated = await drain_topic(broker, gate.result_topic, 1)
            await gate.stop()
            direct = await asyncio.gather(*[
                engine.generate(job["prompt_ids"], LANE_NEW)
                for job in jobs])
            return dict(turns=turns, lane_results=lane_results,
                        served=served, launches=launches,
                        counters=counters, dead=dead, after_dead=after_dead,
                        depth=depth, paused=paused, gated=gated,
                        gate=gate.stats(), direct=direct,
                        paused_metric=metrics.value(
                            "app_pubsub_consumer_paused_total",
                            topic="gated-jobs",
                            reason=lane_mod.PAUSE_ADMISSION))
        finally:
            await engine.stop()

    out = asyncio.run(main())
    for turn in out["turns"]:
        log(f"35a: lane {'on ' if turn['lane'] else 'off'}: interactive "
            f"{turn['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{turn['ttft_p50_s']:.4f}s max {turn['ttft_max_s']:.4f}s"
            + (f"; lane {turn['lane_tokens_per_s']:.1f} tok/s "
               f"({LANE_JOBS} x {LANE_NEW} tokens in "
               f"{turn['lane_wall_s']:.3f}s)" if turn["lane"] else ""))
    direct = {job["id"]: tokens for job, tokens in zip(jobs, out["direct"])}
    equal = [sum(res[k] == direct[k] for k in direct)
             for res in out["lane_results"]]
    log(f"35a: lane results equal to direct generation: {equal} of "
        f"{LANE_JOBS} each on-turn; served by class {out['served']}; "
        f"dead letter {out['dead'][0]['error']}; gated lane: admission "
        f"depth {out['depth']}, paused {out['paused']} (counted "
        f"{out['paused_metric']}), pauses {out['gate']['pauses']} resumes "
        f"{out['gate']['resumes']}")
    interactive = [t["greedy_outputs"] for t in out["turns"]]
    out["interactive_equal_across_turns"] = all(
        o == interactive[0] for o in interactive)
    if equal != [LANE_JOBS] * 2:
        raise AssertionError(f"phase 35a: lane results equal to direct "
                             f"generation {equal} of {LANE_JOBS}")
    if out["served"].get(sched.CLASS_BATCH, 0) < 2 * LANE_JOBS \
            or out["served"].get(sched.CLASS_INTERACTIVE, 0) \
            < 4 * len(prompts):
        raise AssertionError(f"phase 35a: served by class {out['served']}")
    if out["dead"][0]["error"]["type"] != "JobError" \
            or out["after_dead"][0]["id"] != jobs[0]["id"]:
        raise AssertionError(f"phase 35a: dead letter {out['dead']}, next "
                             f"result {out['after_dead']}")
    if not out["paused"] or out["paused_metric"] != 1.0 \
            or out["gate"]["resumes"] < 1 \
            or out["gated"][0]["id"] != jobs[1]["id"]:
        raise AssertionError(f"phase 35a: gated lane {out['gate']}, "
                             f"paused {out['paused']}, depth {out['depth']}")
    counters = out["counters"]
    ticks = counters["ticks"] + counters["spec_ticks"]
    if device == "cuda" and (
            counters["replays"] != ticks or counters["lazy_captures"]
            or counters["prefill_replays"] != counters["prefills"]
            or counters["prefill_lazy"]):
        raise AssertionError(f"phase 35a: replays {counters}")
    check_launches(out["launches"], expected_launches(cfg, counters),
                   "lane_small")
    results["lane_small"] = {k: v for k, v in out.items()
                             if k not in ("direct", "lane_results")}
    results["phase35a_s"] = time.monotonic() - t_phase
    log(f"phase 35a: {results['phase35a_s']:.1f}s")
    del engine
    return {"lane_small": out["launches"]}


WEDGE_ENGINE = dict(paged_kv=True, kv_page=4, kv_pages=8, kv_page_reserve=0,
                    max_slots=2, max_inflight_ticks=1, max_len=64,
                    prompt_buckets=(8, 16))
WEDGE_MESSAGE = ("kv page pool wedged: no slot can grow and nothing is "
                 "reclaimable; shedding the newest request")


def phase_wedge(torch, llama, generate, mods, cfg, params, seed, results,
                device="cuda"):
    """Phase 35b: the pool-wedge repro on a paged engine (8 pages of 4,
    2 slots, 1 tick in flight): two 8-token prompts with 20 new tokens
    each need 7 pages apiece. The first returns its 20 tokens, the second
    fails with the wedge's ``RuntimeError`` within 10 s, and the pool's
    free pages come back; plain, then speculative (a 2-layer draft of
    views). Returns launches by path."""
    t_phase = time.monotonic()
    prompts = [list(range(1, 9)), list(range(11, 19))]
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    by_path = {}
    for path, kw in (("wedge_small", {}),
                     ("wedge_small_spec", dict(draft_cfg=dcfg,
                                               draft_params=dparams,
                                               spec_gamma=SPEC_GAMMA))):
        log(f"== phase 35b: {path}: {WEDGE_ENGINE}")
        engine = generate.GenerationEngine(cfg, params, device=device,
                                           **WEDGE_ENGINE, **kw)

        async def main():
            await engine.warmup(prompt_counts=(1, 2))
            free = engine._pool.free_pages
            await engine.start()
            try:
                for mod in mods:
                    mod.reset_launches()
                before = run_counters(engine)
                first = asyncio.ensure_future(
                    engine.generate(prompts[0], 20))
                await asyncio.sleep(0)
                second = asyncio.ensure_future(
                    engine.generate(prompts[1], 20))
                t0 = time.monotonic()
                done = await asyncio.wait_for(asyncio.gather(
                    first, second, return_exceptions=True), 10.0)
                seconds = time.monotonic() - t0
                after = run_counters(engine)
                return (done, seconds, free, engine._pool.free_pages,
                        read_launches(mods),
                        {key: after[key] - before[key] for key in after},
                        engine.stats()["kv_pool"]["page_stalls"])
            finally:
                await engine.stop()

        (first, second), seconds, free, back, launches, counters, stalls = \
            asyncio.run(main())
        got = len(first) if isinstance(first, list) else repr(first)
        log(f"35b {path}: first {got} tokens, second {second!r} in "
            f"{seconds:.3f}s; free pages "
            f"{free} -> {back}; page stalls {stalls}; launches {launches}")
        if not isinstance(first, list) or len(first) != 20 \
                or not isinstance(second, RuntimeError) \
                or str(second) != WEDGE_MESSAGE or back != free:
            raise AssertionError(f"phase 35b {path}: first {first!r}, "
                                 f"second {second!r}, pages {free} -> "
                                 f"{back}")
        check_launches(launches, expected_launches(
            cfg, counters, 2 if kw else 0), path)
        results[path] = dict(seconds=seconds, free_pages=free,
                             free_after=back, page_stalls=stalls,
                             launches=launches)
        by_path[path] = launches
        del engine
    results["phase35b_s"] = time.monotonic() - t_phase
    log(f"phase 35b: {results['phase35b_s']:.1f}s")
    return by_path


# -- phase 36: training on one card ------------------------------------------
#
# ``small`` at full width and depth (36a-d), ``moe-small`` (36e) and
# ``llama3-8b``'s width at depth 2 (36f), each trained by the port's
# AdamW (optax's ``adamw``) on one fixed batch of random tokens.

TRAIN_BATCH = (8, 1024)          # 36a-c: B x S
MOE_BATCH = (4, 512)             # 36e
BIG_BATCH = (2, 512)             # 36f
BIG_LAYERS = 2                   # 36f: llama3-8b's depth cut to this
TRAIN_STEPS, TIMED_STEPS, MOE_STEPS, BIG_STEPS = 20, 10, 5, 3
F32_LOSS_RTOL = 2e-2             # 36a: a float32 step against bf16's loss
F32_GRAD_COS = 0.99              # ... and its gradients, leaf by leaf
EVAL_FLASH_RTOL = 1e-2           # 36c: the flash eval against the plain


def train_batch(torch, vocab, shape, seed, device):
    """Random tokens from ``seed`` and their next tokens as targets."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, vocab, shape, generator=gen, device=device)
    return tokens, torch.roll(tokens, -1, dims=1)


def tree_clone(tree_util, tree):
    return tree_util.unflatten(tree, {
        key: leaf.clone() for key, leaf in tree_util.flatten(tree).items()})


def leaf_diffs(tree_util, a, b):
    """max |a - b| of each leaf, as floats."""
    fb = tree_util.flatten(b)
    return {key: (leaf.float() - fb[key].float()).abs().max().item()
            for key, leaf in tree_util.flatten(a).items()}


def leaf_scales(tree_util, tree):
    """max |leaf| of each leaf, as floats."""
    return {key: leaf.float().abs().max().item()
            for key, leaf in tree_util.flatten(tree).items()}


def within_spread(diffs, spread, scales):
    """Leaves whose ``diffs`` exceed the run-to-run ``spread``: a leaf
    that came out the same twice must come out the same; one that did
    not (the embedding's gradient sums by atomics) may differ by its
    spread or by two bf16 roundings of its largest value (2^-7 of it),
    whichever is larger."""
    return {key: diffs[key] for key in diffs
            if diffs[key] > (max(spread[key], scales[key] * 2.0 ** -7)
                             if spread[key] > 0 else 0.0)}


def card_label(device):
    """The card's name and power limit, or "cpu" for a rehearsal."""
    return card_line() if device == "cuda" else "cpu"


def free_device(torch, device):
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def same_bits(torch, tree_util, a, b):
    """Every leaf of ``a`` and ``b`` the same dtype and bits."""
    fb = tree_util.flatten(b)
    for key, leaf in tree_util.flatten(a).items():
        other = fb[key]
        if leaf.dtype != other.dtype or leaf.shape != other.shape:
            return False
        if leaf.dtype == torch.bfloat16:
            leaf, other = leaf.view(torch.int16), other.view(torch.int16)
        if not torch.equal(leaf, other):
            return False
    return True


def timed_steps(torch, fn, n, device):
    """Run ``fn()`` ``n`` times back to back (no sync between): each
    call's ms (CUDA events; the host clock on the CPU) and its results."""
    outs, ms = [], []
    if device == "cpu":
        for _ in range(n):
            t0 = time.perf_counter()
            outs.append(fn())
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, outs
    events = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], outs


def peak_bytes(torch, fn, device):
    """``fn()``'s result and the allocator's peak while it ran (0 on the
    CPU)."""
    if device == "cpu":
        return fn(), 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def grad_refusal_calls(torch, mods, device="cuda"):
    """One call of each kernel wrapper on card tensors at shapes it
    takes (D 64), q requiring a gradient: (name, fn, args)."""
    flash_mod, ragged_mod, decode_mod = mods
    gen = torch.Generator(device=device).manual_seed(36)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()

    b, t, hq, hkv, d = 2, 64, 4, 2, 64
    q_prefill = randn(b, t, hq, d).requires_grad_()
    k, v = randn(b, t, hkv, d), randn(b, t, hkv, d)
    q = randn(b, 1, hq, d).requires_grad_()
    k_new, v_new = randn(b, hkv, d), randn(b, hkv, d)
    lens = torch.tensor([5, 40], dtype=torch.int32, device=device)
    page = 32
    table = (torch.arange(b, dtype=torch.int32, device=device)[:, None]
             * (t // page)
             + torch.arange(t // page, dtype=torch.int32,
                            device=device)[None, :]).contiguous()
    pages = (k.view(-1, page, hkv, d), v.view(-1, page, hkv, d))
    return [
        ("flash_attention", flash_mod.flash_attention, (q_prefill, k, v)),
        ("ragged_paged_decode_attention",
         ragged_mod.ragged_paged_decode_attention,
         (q, *pages, table, k_new, v_new, lens)),
        ("flash_decode_attention", decode_mod.flash_decode_attention,
         (q, k, v, k_new, v_new, lens)),
    ]


def phase_train(torch, llama, moe, train, checkpoint, mods, seed, results,
                device="cuda", small_cfg=None, moe_cfg=None, big_cfg=None,
                batches=(TRAIN_BATCH, MOE_BATCH, BIG_BATCH)):
    """Phase 36 (after phase 35): training on one card. Returns the
    launches of 36c's eval through the flash kernel, by path."""
    from gofr_tpu_torch.utils import tree as tree_util

    t_phase = time.monotonic()
    out = results.setdefault("train", {})
    small_cfg = small_cfg or llama.config("small")
    by_path = phase_train_small(torch, llama, train, checkpoint, tree_util,
                                mods, small_cfg, batches[0], seed, out,
                                device)
    free_device(torch, device)
    phase_train_moe(torch, moe, train, tree_util, moe_cfg
                    or moe.config("small"), batches[1], seed, out, device)
    free_device(torch, device)
    phase_train_big(torch, llama, train, big_cfg or llama.config(
        "llama3-8b", n_layers=BIG_LAYERS), batches[2], seed, out, device)
    free_device(torch, device)
    results["phase36_s"] = time.monotonic() - t_phase
    log(f"phase 36: {results['phase36_s']:.1f}s")
    return by_path


def phase_train_small(torch, llama, train, checkpoint, tree_util, mods, cfg,
                      batch, seed, out, device):
    """36a-d on ``cfg`` (``small``: 8 layers, dim 1024, 16 heads, D 64,
    vocab 32000), bf16, at ``batch`` (B 8 x S 1024)."""
    import tempfile
    from torch.utils.flop_counter import FlopCounterMode

    card = card_label(device)
    init_fn, step_fn = train.make_train_step(cfg, device=device)
    _, remat_step = train.make_train_step(cfg, remat=True, device=device)
    state0 = init_fn(seed)
    n_params = sum(p.numel() for p in tree_util.flatten(
        state0.params).values())
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 1,
                                  device)
    log(f"== phase 36a: train small ({n_params / 1e6:.1f} M params, "
        f"{cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads} heads, D "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}) bf16 at B {batch[0]} x S "
        f"{batch[1]}; {card}")

    def loss(params, t, y):
        return llama.loss_fn(params, cfg, t, y)

    # FLOPs a step (forward and backward; the optimizer's elementwise
    # work is not counted). The counter is a dispatch mode, under which
    # some ops take other paths: its run is not one of the runs compared
    with FlopCounterMode(display=False) as counter:
        train.value_and_grad(loss, state0.params, tokens, targets)
    flops = counter.get_total_flops()
    # the gradient twice from one state (the spread: the embedding's
    # scatter-add sums by atomics on the card), once under remat
    loss_a, grads_a = train.value_and_grad(loss, state0.params, tokens,
                                           targets)
    loss_b, grads_b = train.value_and_grad(loss, state0.params, tokens,
                                           targets)
    loss_r, grads_r = train.value_and_grad(loss, state0.params, tokens,
                                           targets, remat=True)
    spread = leaf_diffs(tree_util, grads_a, grads_b)
    remat_d = leaf_diffs(tree_util, grads_a, grads_r)
    loss_spread = abs(loss_a.item() - loss_b.item())
    log(f"36a grad spread (plain twice) {spread}; loss "
        f"{loss_a.item():.6f}, spread {loss_spread:.3e}")
    log(f"36a remat against plain: loss {loss_r.item():.6f} "
        f"(|d| {abs(loss_r.item() - loss_a.item()):.3e}), grads {remat_d}")
    outside = within_spread(remat_d, spread,
                            leaf_scales(tree_util, grads_a))
    if abs(loss_r.item() - loss_a.item()) > loss_spread or outside:
        raise AssertionError(f"phase 36a: remat's loss or gradients "
                             f"{outside} outside the plain step's "
                             f"run-to-run spread")
    del grads_b, grads_r

    # one float32 step from the same state
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tree_util.unflatten(state0.params, {
        k: v.float() for k, v in tree_util.flatten(state0.params).items()})
    loss_32, grads_32 = train.value_and_grad(
        lambda p, t, y: llama.loss_fn(p, cfg32, t, y), params32, tokens,
        targets)
    rel = abs(loss_32.item() - loss_a.item()) / abs(loss_32.item())
    g16 = tree_util.flatten(grads_a)
    cosines = {k: torch.nn.functional.cosine_similarity(
        g.flatten(), g16[k].float().flatten(), dim=0).item()
        for k, g in tree_util.flatten(grads_32).items()}
    log(f"36a float32 step: loss {loss_32.item():.6f} (rel {rel:.3e} of "
        f"bf16's), gradient cosines {cosines}")
    if rel > F32_LOSS_RTOL or min(cosines.values()) < F32_GRAD_COS:
        raise AssertionError(f"phase 36a: float32 against bf16: loss rel "
                             f"{rel}, cosines {cosines}")
    del params32, grads_32, grads_a

    # a step twice from one state (the params' spread, for 36b), peak
    # bytes with and without remat
    runs = []
    for stepper in (step_fn, step_fn, remat_step):
        state = tree_clone(tree_util, state0)
        (_, _), peak = peak_bytes(
            torch, lambda: stepper(state, tokens, targets), device)
        runs.append((state, peak))
    param_spread = leaf_diffs(tree_util, runs[0][0].params,
                              runs[1][0].params)
    remat_params = leaf_diffs(tree_util, runs[0][0].params,
                              runs[2][0].params)
    peak_plain, peak_remat = runs[0][1], runs[2][1]
    log(f"36a one step twice: param spread {param_spread}; remat's params "
        f"against plain {remat_params}; peak bytes {peak_plain} plain, "
        f"{peak_remat} remat")
    del runs

    # 20 steps on the fixed batch, each timed
    state = tree_clone(tree_util, state0)
    ms, losses = timed_steps(
        torch, lambda: step_fn(state, tokens, targets)[1], TRAIN_STEPS,
        device)
    losses = [l.item() for l in losses]
    step_ms = median(ms[-TIMED_STEPS:])
    tok_s = batch[0] * batch[1] / (step_ms / 1e3)
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    log(f"36a {TRAIN_STEPS} steps: losses {[round(l, 4) for l in losses]}")
    ln_v = math.log(cfg.vocab_size)
    if not (losses[-1] < losses[0]
            and abs(losses[0] - ln_v) <= 0.1 * ln_v):
        raise AssertionError(f"phase 36a: losses {losses} (ln V {ln_v})")
    if int(state.step.item()) != TRAIN_STEPS:
        raise AssertionError(f"phase 36a: step {state.step.item()}")

    # the device's idle share of one more step (on a copy)
    idle, top, out_prof = None, [], {}
    if device == "cuda":
        probe = tree_clone(tree_util, state)
        step_fn(probe, tokens, targets)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(probe, tokens, targets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kernel, _ = device_times(torch, prof)
        busy = sum(by_kernel.values())
        idle = 1.0 - busy / wall
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        # cuBLAS's GEMMs on Hopper (nvjet, xmma or cutlass kernels)
        gemm_s = sum(sec for name, sec in by_kernel.items() if any(
            tag in name.lower()
            for tag in ("gemm", "cutlass", "xmma", "nvjet")))
        log(f"36a one step profiled: {wall * 1e3:.3f} ms wall, device "
            f"busy {busy * 1e3:.3f} ms, of it GEMMs {gemm_s * 1e3:.3f} ms "
            f"and the rest (elementwise, reductions, copies) "
            f"{(busy - gemm_s) * 1e3:.3f} ms")
        out_prof = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                        gemm_ms=gemm_s * 1e3)
        del probe
    log(f"36a {card}: step {step_ms:.3f} ms (median of the last "
        f"{TIMED_STEPS}; all {[round(m, 3) for m in ms]}), {tok_s:.0f} "
        f"train tokens/s, {flops:.4e} FLOPs a step (FlopCounterMode), MFU "
        f"{mfu:.4f} of 989 TFLOP/s; peak bytes {peak_plain} plain, "
        f"{peak_remat} remat; device idle share of a step {idle}; top "
        f"kernels (s) {top}")
    out["small"] = dict(
        card=card, params=n_params, batch=list(batch), losses=losses,
        step_ms=ms, step_ms_median=step_ms, tokens_per_s=tok_s,
        flops_per_step=flops, mfu=mfu, peak_bytes=peak_plain,
        peak_bytes_remat=peak_remat, idle_share=idle,
        top_kernels=[[k, s] for k, s in top], profile=out_prof,
        grad_spread=spread,
        remat_grad_diff=remat_d, param_spread=param_spread,
        remat_param_diff=remat_params, f32_loss=loss_32.item(),
        bf16_loss=loss_a.item(), f32_loss_rel=rel, f32_grad_cos=cosines)

    # 36b: checkpoint at step 2, resume, step 3 against the straight run
    ck = tree_clone(tree_util, state0)
    for _ in range(2):
        step_fn(ck, tokens, targets)
    with tempfile.TemporaryDirectory(prefix="gofr_ckpt_") as tmp:
        t0 = time.monotonic()
        checkpoint.save_checkpoint(tmp, ck, step=2,
                                   metadata={"preset": "small"})
        save_s = time.monotonic() - t0
        saved = tree_clone(tree_util, ck)
        _, loss_straight = step_fn(ck, tokens, targets)
        fresh = init_fn(seed + 1)
        t0 = time.monotonic()
        restored = checkpoint.restore_checkpoint(tmp, fresh, device=device)
        restore_s = time.monotonic() - t0
        del fresh
        bits = same_bits(torch, tree_util, restored, saved)
        os.rename(os.path.join(tmp, "step_2"),
                  os.path.join(tmp, "step_2.old"))
        old_ok = checkpoint.latest_step(tmp) == 2 and same_bits(
            torch, tree_util, checkpoint.restore_checkpoint(
                tmp, saved, device=device), saved)
    _, loss_resumed = step_fn(restored, tokens, targets)
    dloss = abs(loss_resumed.item() - loss_straight.item())
    dparams = leaf_diffs(tree_util, restored.params, ck.params)
    log(f"== phase 36b: save {save_s:.2f}s, restore {restore_s:.2f}s; "
        f"restored bits equal {bits}; step_2.old found and equal {old_ok}; "
        f"step 3 loss {loss_straight.item():.6f} straight, "
        f"{loss_resumed.item():.6f} resumed (|d| {dloss:.3e}); params max "
        f"|d| {max(dparams.values()):.3e} by leaf {dparams}")
    outside = within_spread(dparams, param_spread,
                            leaf_scales(tree_util, ck.params))
    if not (bits and old_ok and dloss <= loss_spread) or outside:
        raise AssertionError(f"phase 36b: the resumed run left the "
                             f"uninterrupted run's spread: {outside}")
    out["checkpoint"] = dict(save_s=save_s, restore_s=restore_s,
                             bits_equal=bits, old_found=old_ok,
                             loss_diff=dloss, params_max_diff=dparams)
    del ck, saved, restored

    # 36c: eval through the flash kernel, on the trained params
    by_path = phase_train_eval(torch, train, mods, cfg, state.params, tokens,
                               targets, out, device)
    del state, state0

    # 36d: refusals
    try:
        train.make_train_step(dataclasses.replace(cfg, use_flash=True),
                              device=device)
        raise AssertionError("phase 36d: make_train_step took use_flash")
    except ValueError as exc:
        refused = [f"make_train_step: {exc}"]
    before = read_launches(mods)
    for name, fn, args in grad_refusal_calls(torch, mods, device):
        try:
            fn(*args)
        except RuntimeError as exc:
            if "no backward" not in str(exc):
                raise
            refused.append(f"{name}: {exc}")
            continue
        raise AssertionError(f"phase 36d: {name} ran under autograd")
    if read_launches(mods) != before:
        raise AssertionError("phase 36d: a refused call launched")
    log(f"== phase 36d: refused {len(refused)}: {refused}")
    out["refusals"] = refused
    return by_path


def phase_train_eval(torch, train, mods, cfg, params, tokens, targets, out,
                     device):
    """36c: ``make_eval_step`` with ``use_flash`` (the flash kernel,
    ``n_layers`` launches a call) against ``use_flash=False``."""
    flash_eval = train.make_eval_step(
        dataclasses.replace(cfg, use_flash=True), device=device)
    plain_eval = train.make_eval_step(cfg, device=device)
    for mod in mods:
        mod.reset_launches()
    flash_loss = flash_eval(params, tokens, targets).item()
    launches = read_launches(mods)
    plain_loss = plain_eval(params, tokens, targets).item()
    want = dict.fromkeys(launches, 0)
    want["flash"] = cfg.n_layers
    check_launches(launches, want, "train_eval_small")
    rel = abs(flash_loss - plain_loss) / abs(plain_loss)
    flash_ms, _ = timed_steps(torch, lambda: flash_eval(
        params, tokens, targets), 5, device)
    plain_ms, _ = timed_steps(torch, lambda: plain_eval(
        params, tokens, targets), 5, device)
    log(f"== phase 36c ({card_label(device)}): eval loss {flash_loss:.6f} "
        f"through the flash kernel, "
        f"{plain_loss:.6f} plain (rel {rel:.3e}); {median(flash_ms):.3f} "
        f"ms against {median(plain_ms):.3f} ms; launches {launches}")
    if rel > EVAL_FLASH_RTOL:
        raise AssertionError(f"phase 36c: flash eval rel {rel}")
    out["eval"] = dict(flash_loss=flash_loss, plain_loss=plain_loss,
                       rel=rel, flash_ms=median(flash_ms),
                       plain_ms=median(plain_ms), launches=launches)
    # the tally counts from 0 again after the timed calls
    for mod in mods:
        mod.reset_launches()
    return {"train_eval_small": launches}


def phase_train_moe(torch, moe, train, tree_util, cfg, batch, seed, out,
                    device):
    """36e: ``moe-small`` (8 experts) bf16, MOE_STEPS AdamW steps on
    ``moe.loss_fn`` at ``batch`` (B 4 x S 512)."""
    params = moe.init(cfg, seed, device=device)
    n_params = sum(p.numel() for p in tree_util.flatten(params).values())
    opt_state = train.adamw_init(params)
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 2,
                                  device)
    log(f"== phase 36e: train moe-small ({n_params / 1e6:.1f} M params, "
        f"{cfg.n_experts} experts, {cfg.n_layers} layers) bf16 at B "
        f"{batch[0]} x S {batch[1]}")
    record = []

    def step():
        drops = []
        loss, grads = train.value_and_grad(
            lambda p, t, y: moe.loss_fn(p, cfg, t, y, drops), params,
            tokens, targets)
        router = grads["layers"]["router"]
        train.adamw_update(grads, opt_state, params)
        record.append((router.abs().max(), torch.isfinite(router).all(),
                       torch.stack(drops)))
        return loss

    ms, losses = timed_steps(torch, step, MOE_STEPS, device)
    losses = [l.item() for l in losses]
    router_max = [r.item() for r, _, _ in record]
    finite = all(f.item() for _, f, _ in record)
    drops = [d.tolist() for _, _, d in record]
    tokens_n = batch[0] * batch[1]
    log(f"36e {card_label(device)}: losses "
        f"{[round(l, 4) for l in losses]}; router grad max "
        f"{router_max}, finite {finite}; dropped tokens a layer each step "
        f"(of {tokens_n}) {drops}; step ms {[round(m, 3) for m in ms]}")
    if not (losses[-1] < losses[0] and finite and min(router_max) > 0):
        raise AssertionError(f"phase 36e: losses {losses}, router grads "
                             f"{router_max}, finite {finite}")
    out["moe"] = dict(params=n_params, batch=list(batch), losses=losses,
                      router_grad_max=router_max, dropped=drops,
                      step_ms=ms)


def phase_train_big(torch, llama, train, cfg, batch, seed, out, device):
    """36f: ``llama3-8b``'s width (GQA 32:8, D 128, vocab 128256) at
    ``cfg.n_layers`` layers, BIG_STEPS remat steps at ``batch``."""
    from gofr_tpu_torch.utils import tree as tree_util

    init_fn, step_fn = train.make_train_step(cfg, remat=True, device=device)
    state = init_fn(seed)
    n_params = sum(p.numel() for p in tree_util.flatten(
        state.params).values())
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 3,
                                  device)
    log(f"== phase 36f: train llama3-8b width ({n_params / 1e9:.3f} B params)"
        f", depth cut to {cfg.n_layers} of 32 layers, bf16, remat, at B "
        f"{batch[0]} x S {batch[1]}")
    (ms, losses), peak = peak_bytes(torch, lambda: timed_steps(
        torch, lambda: step_fn(state, tokens, targets)[1], BIG_STEPS,
        device), device)
    losses = [l.item() for l in losses]
    log(f"36f {card_label(device)}: losses "
        f"{[round(l, 4) for l in losses]}; step ms "
        f"{[round(m, 3) for m in ms]}; peak bytes {peak}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 36f: losses {losses}")
    out["llama3_8b_d2"] = dict(params=n_params, layers=cfg.n_layers,
                               batch=list(batch), losses=losses, step_ms=ms,
                               peak_bytes=peak)


# -- phase 37: the app framework serving the example on the card ----------

# the example's defaults (examples/llama-generate/main.py:135-145, 99),
# every port 0; the knobs the example reads are unset but these
APP_ENV = dict(LLAMA_PRESET="small", GENERATE_SLOTS="8", STEPS_PER_TICK="16",
               INFLIGHT_TICKS="4", HTTP_PORT="0", METRICS_PORT="0",
               GRPC_PORT="0", LOG_LEVEL="WARN")
APP_UNSET = ("MODELS", "GENERATE_DRAFT_MODEL", "LLAMA_KV_INT8",
             "GENERATE_PAGED_KV", "GENERATE_PREFIX_CACHE", "CLUSTER_PEERS",
             "MESH", "TPU_MESH", "FLEET_ROUTING", "BATCH_LANE_TOPIC",
             "PUBSUB_BACKEND", "FAULT_PLAN", "TRACE_EXPORTER",
             "REQUEST_TIMEOUT", "GENERATE_COALESCE_UPLOADS",
             "GENERATE_COALESCE_STREAM", "CLUSTER_ROLE")
APP_BUDGET = 32
APP_PROMPT_BYTES = (5, 30, 64, 100, 128, 300, 480, 512)
APP_BUSY_BUDGET = 160     # the slots the deadline probe waits behind
APP_TURNS = ("direct", "http", "http", "direct")


def app_corpus(seed, sizes=APP_PROMPT_BYTES):
    """Prompts of ``sizes`` bytes of words drawn from a seeded corpus."""
    import numpy as np

    rng = np.random.default_rng(seed + 37)
    words = ["".join(chr(c) for c in rng.integers(97, 123, n))
             for n in rng.integers(1, 10, 400)]
    prompts = []
    for size in sizes:
        text = ""
        while len(text) < size:
            text += words[int(rng.integers(0, len(words)))] + " "
        prompts.append(text[:size])
    return prompts


def app_bodies(prompts, seed, budget=APP_BUDGET):
    """The burst's JSON bodies: seven greedy, the last sampled (seeded)."""
    bodies = [{"prompt": p, "max_new_tokens": budget} for p in prompts]
    bodies[-1].update(temperature=0.8, top_p=0.95, seed=seed)
    return bodies


async def http_call(port, method, path, body=None, headers=None):
    """One HTTP/1.1 request over asyncio streams: (status, headers,
    body). ``body`` is sent as JSON, or as is when it is bytes."""
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else b"")
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        headers = dict(headers or {})
        headers.setdefault("Content-Type", "application/json")
        for key, value in headers.items():
            head += f"{key}: {value}\r\n"
        head += (f"Content-Length: {len(data)}\r\nConnection: close"
                 f"\r\n\r\n")
        writer.write(head.encode() + data)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    blob, _, payload = raw.partition(b"\r\n\r\n")
    lines = blob.decode("latin-1").split("\r\n")
    got = {k.strip().lower(): v.strip() for k, _, v in
           (line.partition(":") for line in lines[1:])}
    return int(lines[0].split()[1]), got, payload


async def sse_call(port, path, body, first_frame=None):
    """POST an SSE stream; read its chunks as they arrive. Returns
    (status, headers, frames, seconds to the first ``data:`` frame).
    ``first_frame`` (an event) is set when the first frame lands."""
    data = json.dumps(body).encode()
    t0 = time.monotonic()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/json\r\nContent-Length: "
                      f"{len(data)}\r\nConnection: close\r\n\r\n").encode()
                     + data)
        await writer.drain()
        blob = await reader.readuntil(b"\r\n\r\n")
        lines = blob.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (line.partition(":") for line in lines[1:] if line)}
        frames, ttft = [], None
        if headers.get("transfer-encoding") != "chunked":
            await reader.read()
            return status, headers, frames, ttft
        while True:
            size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
            if size == 0:
                break
            chunk = await reader.readexactly(size + 2)
            if ttft is None:
                ttft = time.monotonic() - t0
                if first_frame is not None:
                    first_frame.set()
            frames.append(chunk[:-2].decode()[len("data: "):].rstrip("\n"))
    finally:
        writer.close()
    return status, headers, frames, ttft


def sse_tokens(frames):
    if not frames or frames[-1] != "[DONE]":
        raise AssertionError(f"app: the SSE stream did not end with [DONE]: "
                             f"{frames[-2:]}")
    return [json.loads(f)["token"] for f in frames[:-1]]


def metric_count(metrics, name, **labels):
    """A counter's value or a histogram's count for one label set."""
    return metrics.value(name, **labels) or 0.0


def metric_total(metrics, name):
    """Sum of a metric's counts over every label set."""
    metric = metrics.snapshot()[name]
    return sum(s["count"] if isinstance(s, dict) else s
               for s in metric.series.values())


class app_environment:
    """The example's environment for the phase, restored after it."""

    base, unset = APP_ENV, APP_UNSET

    def __init__(self, env=None):
        self.env = dict(self.base, **(env or {}))

    def __enter__(self):
        self.saved = {k: os.environ.get(k)
                      for k in list(self.env) + list(self.unset)}
        for key in self.unset:
            os.environ.pop(key, None)
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


async def direct_turn(engine, ids, bodies, generate):
    """The burst straight into the engine: one stream a request, each
    request's first token timed as it arrives. (outputs, wall, client
    TTFTs)."""
    async def one(prompt_ids, body):
        t0 = time.monotonic()
        sampling = generate.Sampling(
            temperature=body.get("temperature", 0.0),
            top_p=body.get("top_p", 1.0), seed=body.get("seed"))
        stream = await engine.generate_stream(
            prompt_ids, max_new_tokens=body["max_new_tokens"],
            sampling=sampling)
        out, first = [], None
        async for token in stream:
            if first is None:
                first = time.monotonic() - t0
            out.append(token)
        return out, first

    t0 = time.monotonic()
    got = await asyncio.wait_for(asyncio.gather(*[
        one(i, b) for i, b in zip(ids, bodies)]), 600)
    return [g[0] for g in got], time.monotonic() - t0, [g[1] for g in got]


async def http_turn(port, bodies):
    """The burst over HTTP, each request an SSE stream. (outputs, wall,
    client TTFTs at the first frame, trace ids)."""
    t0 = time.monotonic()
    got = await asyncio.wait_for(asyncio.gather(*[
        sse_call(port, "/generate/stream", b) for b in bodies]), 600)
    wall = time.monotonic() - t0
    for status, headers, _, _ in got:
        if status != 200 or headers.get("content-type") \
                != "text/event-stream":
            raise AssertionError(f"app: /generate/stream answered {status} "
                                 f"{headers}")
    return ([sse_tokens(g[2]) for g in got], wall, [g[3] for g in got],
            [g[1].get("x-trace-id") for g in got])


async def grpc_tokens(port, body):
    import grpc

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
        method = channel.unary_stream("/gofr.Llama/generate")
        return [json.loads(raw)["data"]["token"]
                async for raw in method(json.dumps(body).encode())]


def phase_app(torch, generate, mods, seed, results, device="cuda",
              env=None, sizes=APP_PROMPT_BYTES, busy_budget=APP_BUSY_BUDGET):
    """Phase 37: the port's ``examples/llama_generate`` app at its
    defaults on the card, through HTTP, SSE and gRPC. Returns launches by
    path. A CPU rehearsal passes ``device="cpu"`` and ``env`` (e.g.
    ``{"LLAMA_PRESET": "tiny"}``), prompt ``sizes`` and a ``busy_budget``
    that fit its cache, with ``check_launches`` stubbed; it profiles
    nothing."""
    from torch.profiler import ProfilerActivity

    from gofr_tpu_torch.examples import llama_generate

    t_phase = time.monotonic()
    cuda = device == "cuda"
    with app_environment(env):
        app = llama_generate.build_app(device=device)
    engine = app.engine
    cfg = engine.cfg
    log(f"== phase 37: the app framework on the card: "
        f"gofr_tpu_torch.examples.llama_generate at its defaults (small, "
        f"dim {cfg.dim}, {cfg.n_layers} layers, head_dim {cfg.head_dim}, "
        f"vocab {cfg.vocab_size}, {engine.max_slots} slots, max_len "
        f"{engine.max_len}, k {engine.steps_per_tick}, "
        f"{engine.max_inflight_ticks} ticks in flight, "
        f"{'paged' if engine.paged else 'dense'}); tokenizer "
        f"{app.tokenizer.encoder}; gRPC "
        + ("on (grpc imports)" if app.grpc_on else
           "off: grpc does not import on this host, its path is not "
           "driven"))
    prompts = app_corpus(seed, sizes)
    bodies = app_bodies(prompts, seed)
    ids = [app.tokenizer.encode(p)[-512:] for p in prompts]
    metrics = app.container.metrics
    out = {}

    async def main():
        t0 = time.monotonic()
        await app.start()     # warm-up: every graph before the bind
        out["start_s"] = time.monotonic() - t0
        out["reserved_after_start"] = reserved_bytes(torch) if cuda \
            else None
        port = app.bound_http_port
        mport = app.bound_metrics_port
        try:
            # warm-up request (cuBLAS handles, allocator), not counted
            await engine.generate(ids[0], 8)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            out["alive"] = await http_call(port, "GET", "/.well-known/alive")
            out["health"] = await http_call(port, "GET",
                                            "/.well-known/health")
            ttft0 = metric_total(metrics, "app_tpu_ttft")
            http0 = metric_count(metrics, "app_http_response",
                                 path="/generate/stream", method="POST",
                                 status="200")
            # the gated burst: HTTP SSE, then the direct reference
            records0 = len(engine.recorder.snapshot()["recent"])
            http = await http_turn(port, bodies)
            out["http"] = http
            out["ttft_delta"] = metric_total(metrics, "app_tpu_ttft") - ttft0
            out["http_delta"] = metric_count(
                metrics, "app_http_response", path="/generate/stream",
                method="POST", status="200") - http0
            out["records"] = {tid: engine.recorder.find(tid)
                              for tid in http[3]}
            out["records_added"] = len(engine.recorder.snapshot()["recent"]) \
                - records0
            out["direct"] = await direct_turn(engine, ids, bodies, generate)
            out["unary_sampled"] = await http_call(port, "POST", "/generate",
                                                   bodies[-1])
            # the scrape
            _, _, text = await http_call(mport, "GET", "/metrics")
            out["metrics_text"] = text.decode()
            # the deadline bridge: every slot busy with a long stream, a
            # request with a 1 ms budget waits for one and is shed
            expired0 = metric_count(metrics, "app_tpu_slo_total",
                                    outcome="expired")
            firsts = [asyncio.Event() for _ in range(engine.max_slots)]
            busy = [asyncio.ensure_future(sse_call(
                port, "/generate/stream",
                {"prompt": prompts[i % 3], "max_new_tokens": busy_budget},
                first_frame=firsts[i])) for i in range(engine.max_slots)]
            await asyncio.wait_for(asyncio.gather(*[e.wait() for e in firsts]),
                                   600)
            out["shed"] = await http_call(
                port, "POST", "/generate", bodies[0],
                headers={"X-Request-Deadline-Ms": "1"})
            busy_out = await asyncio.wait_for(asyncio.gather(*busy), 600)
            out["busy_tokens"] = [len(sse_tokens(b[2])) for b in busy_out]
            out["expired_delta"] = metric_count(
                metrics, "app_tpu_slo_total", outcome="expired") - expired0
            # gRPC, where grpc imports
            if app.grpc_on:
                out["grpc"] = await asyncio.wait_for(
                    grpc_tokens(app.bound_grpc_port, bodies[1]), 600)
            out["launches"] = read_launches(mods)
            after = run_counters(engine)
            out["counters"] = {k: after[k] - before[k] for k in after}
            # the turns: direct, HTTP, HTTP, direct; each once timed, then
            # once under the profiler for the device's idle share
            out["turns"] = []
            for kind in APP_TURNS:
                row = {"kind": kind}
                for profiled in ((False, True) if cuda else (False,)):
                    gc.collect()
                    engine.ttfts.clear()
                    prof = (torch.profiler.profile(
                        activities=[ProfilerActivity.CUDA])
                        if profiled else None)
                    if prof is not None:
                        prof.__enter__()
                    try:
                        if kind == "direct":
                            outs, wall, ttfts = await direct_turn(
                                engine, ids, bodies, generate)
                        else:
                            outs, wall, ttfts, _ = await http_turn(port,
                                                                   bodies)
                        if cuda:
                            torch.cuda.synchronize()
                    finally:
                        if prof is not None:
                            prof.__exit__(None, None, None)
                    if profiled:
                        busy_s = sum(device_times(torch, prof)[0].values())
                        row["idle_share"] = 1.0 - busy_s / wall
                        row["profiled_wall_s"] = wall
                    else:
                        row.update(
                            outs=outs, wall_s=wall,
                            tokens_per_s=APP_BUDGET * len(outs) / wall,
                            client_ttft_p50_s=median(ttfts),
                            client_ttft_max_s=max(ttfts),
                            engine_ttft_p50_s=median(list(engine.ttfts)))
                out["turns"].append(row)
            out["slab_bytes_turns"] = engine._staging.stats()["slab_bytes"]
        finally:
            await app.stop()
        stats = engine.stats()
        out["after_stop"] = dict(
            free_slots=stats["free_slots"], active=stats["active_slots"],
            queue=stats["queue_depth"], inflight=stats["ticks_inflight"],
            slab_bytes=engine._staging.stats()["slab_bytes"],
            device_thread=engine._own_exec is None)
        await asyncio.sleep(0.05)

    asyncio.run(main())
    by_path = {}
    # gates
    status, _, body = out["alive"]
    if status != 200 or json.loads(body) != {"status": "UP"}:
        raise AssertionError(f"app: /.well-known/alive {status} {body!r}")
    status, _, body = out["health"]
    health = json.loads(body)
    if status != 200 or health["status"] != "UP" \
            or health["tpu"]["status"] != "UP":
        raise AssertionError(f"app: /.well-known/health {status} {health}")
    c = out["counters"]
    if c["lazy_captures"] or c["prefill_lazy"] or cuda and (
            c["replays"] != c["ticks"] + c["spec_ticks"]
            or c["prefill_replays"] != c["prefills"]):
        raise AssertionError(f"app: a tick or prefill served over HTTP was "
                             f"not a replay of a warm-up graph: {c}")
    check_launches(out["launches"], expected_launches(cfg, c), "app_small")
    by_path["app_small"] = out["launches"]
    http_outs, _, _, trace_ids = out["http"]
    direct_outs = out["direct"][0]
    if http_outs[:7] != direct_outs[:7]:
        raise AssertionError("app: greedy tokens over HTTP differ from the "
                             "engine's direct generate of the same ids")
    status, _, body = out["unary_sampled"]
    unary = json.loads(body)["data"]
    if status != 201 or unary["tokens"] != http_outs[-1] \
            or unary["completion"] != app.tokenizer.decode(http_outs[-1]):
        raise AssertionError(f"app: the sampled SSE stream {http_outs[-1]} "
                             f"is not the unary response {unary['tokens']}")
    sampled_direct_equal = direct_outs[-1] == http_outs[-1]
    if out["ttft_delta"] != len(bodies):
        raise AssertionError(f"app: app_tpu_ttft counted "
                             f"{out['ttft_delta']} of the burst's "
                             f"{len(bodies)}")
    if out["http_delta"] != len(bodies):
        raise AssertionError(f"app: app_http_response counted "
                             f"{out['http_delta']} of the burst's "
                             f"{len(bodies)} streams")
    text = out["metrics_text"]
    for series in ("app_tpu_ttft_count", "app_http_response_count",
                   "app_http_response_bucket", "app_tpu_slo_total"):
        if series not in text:
            raise AssertionError(f"app: /metrics lacks {series}")
    status, _, body = out["shed"]
    if status != 503 or "deadline" not in json.loads(body)["error"][
            "message"] or out["expired_delta"] != 1:
        raise AssertionError(f"app: the 1 ms deadline request answered "
                             f"{status} {body!r}, expired counted "
                             f"{out['expired_delta']}")
    if out["busy_tokens"] != [busy_budget] * engine.max_slots:
        raise AssertionError(f"app: the busy streams returned "
                             f"{out['busy_tokens']} tokens")
    if len(set(trace_ids)) != len(bodies) or any(
            len(out["records"][t]) != 1 for t in trace_ids) \
            or out["records_added"] != len(bodies):
        raise AssertionError(
            f"app: trace ids {trace_ids}: flight records "
            f"{ {t: len(r) for t, r in out['records'].items()} }, "
            f"{out['records_added']} added for {len(bodies)} requests")
    if app.grpc_on and out["grpc"] != direct_outs[1]:
        raise AssertionError(f"app: gRPC tokens {out['grpc']} differ from "
                             f"the direct {direct_outs[1]}")
    turns = out["turns"]
    for row in turns:
        if row["outs"][:7] != direct_outs[:7]:
            raise AssertionError(f"app: a {row['kind']} turn's greedy "
                                 f"tokens differ")
    stop = out["after_stop"]
    if (stop["free_slots"], stop["active"], stop["queue"],
            stop["inflight"]) != (engine.max_slots, 0, 0, 0) \
            or not stop["device_thread"] \
            or stop["slab_bytes"] != out["slab_bytes_turns"]:
        raise AssertionError(f"app: after stop {stop} (slab bytes after the "
                             f"turns {out['slab_bytes_turns']})")
    row = dict(
        start_s=out["start_s"], graphs=engine.stats()["graphs"]["captured"],
        prefill_graphs=engine.stats()["graphs"]["prefill"]["captured"],
        reserved_after_start=out["reserved_after_start"],
        counters=c, launches=out["launches"], grpc=app.grpc_on,
        grpc_tokens_equal=(out["grpc"] == direct_outs[1]
                           if app.grpc_on else None),
        tokenizer=app.tokenizer.encoder,
        sampled_direct_equal=sampled_direct_equal,
        health_keys=sorted(health), shed=out["shed"][0],
        turns=[{k: v for k, v in r.items() if k != "outs"} for r in turns],
        after_stop=stop, phase_s=time.monotonic() - t_phase)
    results["app_small"] = row
    log(f"app: started (warm-up and captures before the bind) in "
        f"{row['start_s']:.2f}s, {row['graphs']} tick and "
        f"{row['prefill_graphs']} prefill graphs; alive UP, health "
        f"{sorted(health)}; {len(bodies)} SSE streams: greedy = direct, "
        f"sampled SSE = unary (= direct: {sampled_direct_equal}); "
        f"app_tpu_ttft +{out['ttft_delta']:.0f}, app_http_response "
        f"+{out['http_delta']:.0f}; 1 ms deadline: {out['shed'][0]}, "
        f"expired +{out['expired_delta']:.0f}; one flight record a trace "
        f"id; gRPC "
        + (f"driven, tokens equal {row['grpc_tokens_equal']}"
           if app.grpc_on else "off (grpc does not import): not driven")
        + f"; launches {out['launches']}")
    for r in row["turns"]:
        log(f"app turn {r['kind']}: {r['tokens_per_s']:.1f} tok/s, client "
            f"TTFT p50 {r['client_ttft_p50_s']:.4f}s max "
            f"{r['client_ttft_max_s']:.4f}s, engine TTFT p50 "
            f"{r['engine_ttft_p50_s']:.4f}s, idle share "
            f"{r.get('idle_share')}")
    log(f"app stopped: {stop}; phase 37 {row['phase_s']:.1f}s")
    del engine, app
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return by_path


# phase 38: the debug pages and a remote prefill replica (the example at
# its defaults in a child process, CLUSTER_ROLE=prefill; the decode
# replica in this process, paged as JAX's adopt_kv needs)
DISAGG_PAGES = ("statusz", "varz", "xlaz", "hbmz", "timez", "workloadz",
                "sloz", "whyz", "tunez", "clusterz")
DISAGG_TURNS = ("monolithic", "disaggregated", "disaggregated", "monolithic")
POLL_TURNS = ("quiet", "polled", "polled", "quiet")
POLL_EVERY_S = 0.1
POLL_BURSTS = 5          # bursts a polling turn, back to back (~0.4 s)
# the child's ports come from here, below the kernel's ephemeral range, so
# no port-0 bind of this process can take one; a port another process
# takes between the probe and the child's bind fails the child's start,
# and the phase starts again on other ports
CHILD_PORTS = (20000, 30000)
CHILD_TRIES = 3
CHILD_READY_S = 300.0
PHASE38_DIR = Path(__file__).resolve().parent / "build" / "phase38"


def probe_ports(rng, n):
    """``n`` distinct ports of ``CHILD_PORTS`` that bind right now."""
    import socket

    ports = []
    while len(ports) < n:
        port = int(rng.integers(*CHILD_PORTS))
        with socket.socket() as sock:
            try:
                sock.bind(("0.0.0.0", port))
            except OSError:
                continue
        if port not in ports:
            ports.append(port)
    return ports


def _end_with_parent():
    """In the child, before exec: SIGTERM when this process ends, so a
    killed smoke leaves no replica on the card."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)


class ReplicaProcess:
    """The prefill replica: ``python -m
    gofr_tpu_torch.examples.llama_generate`` (on the CPU, ``build_app``
    with ``device="cpu"``) with its own ports and a log file, stopped by
    :meth:`stop` on every exit path."""

    def __init__(self, env, log_path, device):
        self.env = env
        self.log_path = log_path
        self.device = device
        self.proc = None

    def start(self):
        cmd = [sys.executable, "-m", "gofr_tpu_torch.examples.llama_generate"]
        if self.device != "cuda":
            cmd = [sys.executable, "-c",
                   "from gofr_tpu_torch.examples import llama_generate as m; "
                   f"m.build_app(device={self.device!r}).run()"]
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            cmd, cwd=str(Path(__file__).resolve().parent), env=self.env,
            stdout=self._log, stderr=subprocess.STDOUT,
            preexec_fn=_end_with_parent)

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    def tail(self, n=20):
        lines = self.log_path.read_text(errors="replace").splitlines()
        return "\n".join(lines[-n:])

    def stop(self):
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        self._log.close()
        return self.proc.returncode


async def wait_alive(child, port, timeout=CHILD_READY_S):
    """Until the child's ``/.well-known/alive`` answers 200; raises if it
    exits first."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if not child.alive():
            raise RuntimeError(f"disagg: the prefill replica exited "
                               f"({child.proc.returncode}):\n{child.tail()}")
        try:
            status, _, _ = await http_call(port, "GET", "/.well-known/alive")
            if status == 200:
                return time.monotonic() - t0
        except OSError:
            pass
        await asyncio.sleep(0.25)
    raise RuntimeError(f"disagg: the prefill replica did not answer in "
                       f"{timeout}s:\n{child.tail()}")


def scrape_count(text, name, **labels):
    """A Prometheus series' value (a histogram's ``_count``) from an
    exposition, summed over the series whose labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name) or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if all(f'{k}="{v}"' in head for k, v in labels.items()):
            total += float(value)
    return total


async def disagg_turn(port, bodies):
    """The burst through ``POST /disagg/generate`` (unary JSON). (outputs,
    wall, client latencies, trace ids)."""
    async def one(body):
        t0 = time.monotonic()
        status, headers, payload = await http_call(port, "POST",
                                                   "/disagg/generate", body)
        if status != 201:
            raise AssertionError(f"disagg: /disagg/generate answered "
                                 f"{status} {payload[:300]!r}")
        return (json.loads(payload)["data"]["tokens"],
                time.monotonic() - t0, headers.get("x-trace-id"))

    t0 = time.monotonic()
    got = await asyncio.wait_for(asyncio.gather(*[one(b) for b in bodies]),
                                 600)
    return ([g[0] for g in got], time.monotonic() - t0, [g[1] for g in got],
            [g[2] for g in got])


async def get_page(port, path):
    t0 = time.monotonic()
    status, _, body = await http_call(port, "GET", path)
    ms = (time.monotonic() - t0) * 1e3
    data = json.loads(body)["data"] if status == 200 else body
    return status, data, ms


async def poll_pages(port, stop):
    """Every page once each ``POLL_EVERY_S`` until ``stop`` is set;
    returns the polls made."""
    polls = 0
    while not stop.is_set():
        for page in DISAGG_PAGES:
            await http_call(port, "GET", f"/debug/{page}")
        polls += 1
        try:
            await asyncio.wait_for(stop.wait(), POLL_EVERY_S)
        except asyncio.TimeoutError:
            pass
    return polls


def series_sampled(timez):
    """Signals of a timez page with at least one sampled value."""
    series = (timez.get("series") or {}).get("series") or {}
    return [name for name, values in series.items()
            if any(v is not None for v in values)]


def check_pages(pages, index, replica, decode, cuda):
    """Every page 200 and its sections filled (``decode``: the replica
    with the peer; ``cuda``: the allocator's figure on hbmz)."""
    bad = {page: got[0] for page, got in pages.items() if got[0] != 200}
    if bad or index[0] != 200 or len(index[1]) != 12:
        raise AssertionError(f"disagg: {replica}: pages not 200: {bad}, "
                             f"index {index[0]} {index[1]}")
    statusz = pages["statusz"][1]
    if not {"engine", "devices"} <= set(statusz) \
            or "compiles" not in statusz["engine"]["stats"]:
        raise AssertionError(f"disagg: {replica}: statusz sections "
                             f"{sorted(statusz)}")
    hbmz = pages["hbmz"][1]
    if not hbmz.get("attributed_bytes") or cuda and (
            not hbmz.get("device_bytes_in_use")
            or hbmz.get("occupancy") is None):
        raise AssertionError(f"disagg: {replica}: hbmz {hbmz}")
    if not series_sampled(pages["timez"][1]):
        raise AssertionError(f"disagg: {replica}: timez has no sample")
    if decode:
        clusterz = pages["clusterz"][1]
        replicas = clusterz["replicas"]
        if sorted(replicas) != ["local", "pf"] or replicas["pf"]["stale"] \
                or replicas["pf"]["transport"] != "http" \
                or replicas["local"].get("goodput_tokens_per_s") is None \
                or "goodput_tokens_per_s" not in replicas["pf"]:
            raise AssertionError(f"disagg: clusterz {replicas}")


def trace_kernel_events(path):
    """Kernel events of a Chrome trace by name, and its bytes."""
    data = Path(path).read_bytes()
    events = json.loads(data)["traceEvents"]
    counts = {}
    for event in events:
        if event.get("cat") == "kernel":
            counts[event["name"]] = counts.get(event["name"], 0) + 1
    return counts, len(data)


def named(counts, needle):
    return sum(n for name, n in counts.items() if needle in name)


def phase_disagg_app(generate, cluster_mod, kv_wire, mods, seed, results,
                     device="cuda", env=None, sizes=APP_PROMPT_BYTES):
    """Phase 38: the example at its defaults across two processes on one
    card: a prefill replica in a child process and a decode replica here
    whose ``CLUSTER_PEERS`` names it, every debug page on both, a
    profile through ``/debug/profiler``. Returns launches by path. A CPU
    rehearsal passes ``device="cpu"``, ``env`` (e.g. ``{"LLAMA_PRESET":
    "tiny"}``) and prompt ``sizes`` that fit, with ``check_launches``
    stubbed; it checks no device event."""
    import numpy as np

    from gofr_tpu_torch.examples import llama_generate

    t_phase = time.monotonic()
    cuda = device == "cuda"
    rng = np.random.default_rng(seed + 38)
    prompts = app_corpus(seed, sizes)
    bodies = [{"prompt": p, "max_new_tokens": APP_BUDGET} for p in prompts]
    log("== phase 38: the debug pages and a remote replica: the example "
        "at its defaults, a prefill replica in a child process and a "
        "paged decode replica here whose CLUSTER_PEERS names it")
    out = {"tries": []}
    child = app = None
    for attempt in range(CHILD_TRIES):
        http_port, grpc_port, metrics_port = probe_ports(rng, 3)
        child_env = dict(os.environ)
        for key in APP_UNSET:
            child_env.pop(key, None)
        child_env.update(APP_ENV, **(env or {}))
        child_env.update(CLUSTER_ROLE="prefill", HTTP_PORT=str(http_port),
                         GRPC_PORT=str(grpc_port),
                         METRICS_PORT=str(metrics_port), LOG_LEVEL="INFO")
        child = ReplicaProcess(child_env, PHASE38_DIR / "prefill.log",
                               device)
        t0 = time.monotonic()
        child.start()
        peers = (f"pf=prefill@http://127.0.0.1:{http_port}"
                 f"#127.0.0.1:{grpc_port}")
        with app_environment(dict(env or {}, CLUSTER_ROLE="decode",
                                  GENERATE_PAGED_KV="1",
                                  CLUSTER_PEERS=peers)):
            app = llama_generate.build_app(device=device)
        try:
            out.update(asyncio.run(_disagg_main(
                generate, cluster_mod, kv_wire, mods, app, child,
                (http_port, grpc_port, metrics_port), prompts, bodies, t0)))
            break
        except ChildBindError as exc:
            out["tries"].append(str(exc))
            log(f"disagg: the prefill replica could not bind ({exc}); "
                f"again on other ports")
        finally:
            child.stop()
    else:
        raise AssertionError(f"disagg: the prefill replica did not start "
                             f"in {CHILD_TRIES} tries: {out['tries']}")
    return check_disagg(app, out, cuda, t_phase, results)


class WarnTap:
    """A logger that keeps the ``warn`` lines of the one object it is
    given to (the peer's transport) and passes every call on."""

    def __init__(self, inner):
        self.inner = inner
        self.warnings = []

    def warn(self, message, *args, **fields):
        self.warnings.append(message % args)
        self.inner.warn(message, *args, **fields)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ChildBindError(RuntimeError):
    """The child replica exited because a port was taken."""


async def _disagg_main(generate, cluster_mod, kv_wire, mods, app, child,
                       ports, prompts, bodies, t0):
    engine = app.engine
    child_http, child_grpc, child_metrics = ports
    transport = app.container.cluster._replicas["pf"].transport
    transport.logger = WarnTap(transport.logger)
    router = app.container.cluster_router
    ids = [app.tokenizer.encode(p)[-512:] for p in prompts]
    out = {}
    await app.start()        # the decode replica's warm-up, beside the child's
    out["decode_start_s"] = time.monotonic() - t0
    try:
        try:
            await wait_alive(child, child_http)
        except RuntimeError as exc:
            if "Address already in use" in child.tail(50):
                raise ChildBindError(str(exc).splitlines()[0]) from exc
            raise
        out["child_ready_s"] = time.monotonic() - t0
        port = app.bound_http_port
        log(f"disagg: the prefill replica (pid {child.proc.pid}) answers "
            f"on :{child_http} (gRPC :{child_grpc}) {out['child_ready_s']:.1f}"
            f"s after its start; the decode replica started in "
            f"{out['decode_start_s']:.1f}s")
        # warm-up (cuBLAS handles, the gRPC channel, the allocator), not
        # counted
        await engine.generate(ids[0], 8)
        await disagg_turn(port, bodies[:1])
        _, _, metrics_text = await http_call(child_metrics, "GET", "/metrics")
        fetch0 = (scrape_count(metrics_text.decode(),
                               "app_http_service_response_count",
                               service="grpc", method="/gofr.Disagg/fetch"),
                  scrape_count(metrics_text.decode(),
                               "app_http_response_count",
                               path="/disagg/fetch"))
        # the counted window: one disaggregated burst, one monolithic
        for mod in mods:
            mod.reset_launches()
        before = run_counters(engine)
        stats0 = engine.stats()
        shipped0 = router.stats()["bytes_shipped"]
        out["disagg"] = await disagg_turn(port, bodies)
        stats1 = engine.stats()
        out["no_prefill"] = dict(
            prefills=stats1["prefill_batches"] - stats0["prefill_batches"],
            bucket_tokens=stats1["prefill_bucket_tokens"]
            - stats0["prefill_bucket_tokens"],
            adoptions=stats1["kv_adoptions"] - stats0["kv_adoptions"])
        out["kv_bytes_per_request"] = (router.stats()["bytes_shipped"]
                                       - shipped0) / len(bodies)
        out["monolithic"] = await http_turn(port, bodies)
        out["launches"] = read_launches(mods)
        after = run_counters(engine)
        out["counters"] = {k: after[k] - before[k] for k in after}
        _, _, metrics_text = await http_call(child_metrics, "GET", "/metrics")
        out["fetches"] = (
            scrape_count(metrics_text.decode(),
                         "app_http_service_response_count",
                         service="grpc", method="/gofr.Disagg/fetch")
            - fetch0[0],
            scrape_count(metrics_text.decode(), "app_http_response_count",
                         path="/disagg/fetch") - fetch0[1])
        out["warned"] = list(transport.logger.warnings)
        # one HTTPTransport with no gRPC target, called directly; its
        # handoff adopted here
        plain = cluster_mod.HTTPTransport(f"http://127.0.0.1:{child_http}")
        blob = await plain.prefill(ids[1], generate.Sampling())
        stream = await engine.adopt_kv(kv_wire.unpack(blob), APP_BUDGET)
        out["plain_http"] = [t async for t in stream]
        # fetch seconds: one handoff, over gRPC and over HTTP
        status, _, body = await http_call(
            child_http, "POST", "/disagg/prefill",
            {"prompt": ids[-1], "sampling": {}})
        handoff = json.loads(body)["data"]["handoff"]
        t1 = time.monotonic()
        over_grpc = await cluster_mod._grpc_fetch(
            f"127.0.0.1:{child_grpc}", handoff)
        t2 = time.monotonic()
        over_http = await plain.service.aget("/disagg/fetch",
                                             params={"handoff": handoff})
        t3 = time.monotonic()
        out["fetch_s"] = dict(grpc=t2 - t1, http=t3 - t2,
                              bytes=len(over_grpc),
                              same=over_grpc == over_http.body)
        # the turns: monolithic, disaggregated, disaggregated, monolithic
        out["turns"] = []
        for kind in DISAGG_TURNS:
            gc.collect()
            engine.ttfts.clear()
            if kind == "monolithic":
                outs, wall, ttfts, _ = await http_turn(port, bodies)
            else:
                outs, wall, ttfts, _ = await disagg_turn(port, bodies)
            out["turns"].append(dict(
                kind=kind, outs=outs, wall_s=wall,
                tokens_per_s=APP_BUDGET * len(outs) / wall,
                client_p50_s=median(ttfts),
                engine_ttft_p50_s=median(list(engine.ttfts))))
        # every page on both replicas, rendered while a burst runs here
        burst = asyncio.ensure_future(disagg_turn(port, bodies))
        pages = {}
        for page in DISAGG_PAGES:
            pages[page] = await get_page(port, f"/debug/{page}")
        out["burst_during_pages"] = await burst
        out["pages"] = pages
        out["index"] = (await get_page(port, "/debug/"))[:2]
        out["child_pages"] = {page: await get_page(child_http,
                                                   f"/debug/{page}")
                              for page in DISAGG_PAGES}
        out["child_index"] = (await get_page(child_http, "/debug/"))[:2]
        tid = out["disagg"][3][0]
        out["tracez"] = await get_page(port, f"/debug/tracez/{tid}")
        out["whyz"] = await get_page(port, f"/debug/whyz/{tid}")
        out["child_tracez"] = await get_page(
            child_http, f"/debug/tracez/{tid}?local=1")
        # the pages polled every 100 ms against not, in turns
        out["poll_turns"] = []
        for kind in POLL_TURNS:
            stop = asyncio.Event()
            poller = (asyncio.ensure_future(poll_pages(port, stop))
                      if kind == "polled" else None)
            t1 = time.monotonic()
            for _ in range(POLL_BURSTS):
                await http_turn(port, bodies)
            wall = time.monotonic() - t1
            stop.set()
            polls = await poller if poller is not None else 0
            out["poll_turns"].append(dict(
                kind=kind, polls=polls,
                tokens_per_s=APP_BUDGET * len(bodies) * POLL_BURSTS / wall))
        # a profile of a monolithic burst through /debug/profiler
        trace_dir = PHASE38_DIR / "profile"
        for mod in mods:
            mod.reset_launches()
        before = run_counters(engine)
        status, _, body = await http_call(port, "POST",
                                          "/debug/profiler/start",
                                          {"dir": str(trace_dir),
                                           "duration_s": 120})
        out["profile_start"] = (status, json.loads(body)["data"])
        profiled = await http_turn(port, bodies)
        status, _, body = await http_call(port, "POST",
                                          "/debug/profiler/stop")
        out["profile_stop"] = (status, json.loads(body)["data"])
        out["profile_launches"] = read_launches(mods)
        after = run_counters(engine)
        out["profile_counters"] = {k: after[k] - before[k] for k in after}
        out["profiled"] = dict(outs=profiled[0], wall_s=profiled[1],
                               tokens_per_s=APP_BUDGET * len(bodies)
                               / profiled[1])
        out["trace"] = trace_kernel_events(trace_dir / "trace.json")
        # a graph captured under the profiler: a constrained request's
        # bias graphs are captured at its first use
        lazy0 = engine.stats()["graphs"]["lazy_captures"]
        constrained = {"prompt": prompts[2], "max_new_tokens": 16,
                       "response_format": YES_NO}
        await http_call(port, "POST", "/debug/profiler/start",
                        {"dir": str(PHASE38_DIR / "profile-capture"),
                         "duration_s": 120})
        first = await http_call(port, "POST", "/generate", constrained)
        await http_call(port, "POST", "/debug/profiler/stop")
        second = await http_call(port, "POST", "/generate", constrained)
        out["capture_under_profile"] = dict(
            lazy_captures=engine.stats()["graphs"]["lazy_captures"] - lazy0,
            first=(first[0], json.loads(first[2])["data"]["tokens"]),
            second=(second[0], json.loads(second[2])["data"]["tokens"]))
        # the peer gone: the breaker opens, clusterz marks it stale
        out["child_exit"] = child.stop()
        answers = []
        for _ in range(6):
            answers.append((await http_call(port, "POST", "/disagg/generate",
                                            bodies[0]))[0])
            if not transport.available():
                break
        out["after_kill"] = dict(
            answers=answers, circuit=transport.service.state,
            clusterz=await get_page(port, "/debug/clusterz"),
            generate=await http_call(port, "POST", "/disagg/generate",
                                     bodies[0]))
    finally:
        await app.stop()
    return out


def check_disagg(app, out, cuda, t_phase, results):
    """Phase 38's gates over what ``_disagg_main`` gathered; its log
    lines. Returns launches by path."""
    engine = app.engine
    cfg = engine.cfg
    c = out["counters"]
    if c["lazy_captures"] or c["prefill_lazy"] or cuda and (
            c["replays"] != c["ticks"] + c["spec_ticks"]
            or c["prefill_replays"] != c["prefills"]):
        raise AssertionError(f"disagg: a tick or prefill of the counted "
                             f"window was not a replay: {c}")
    check_launches(out["launches"], expected_launches(cfg, c), "disagg_app")
    disagg_outs = out["disagg"][0]
    mono_outs = out["monolithic"][0]
    if disagg_outs != mono_outs:
        raise AssertionError(
            f"disagg: tokens through /disagg/generate differ from the "
            f"decode replica's /generate: "
            f"{[i for i, (a, b) in enumerate(zip(disagg_outs, mono_outs)) if a != b]}")
    for row in out["turns"] + [dict(kind="pages burst",
                                    outs=out["burst_during_pages"][0]),
                               dict(kind="profiled",
                                    outs=out["profiled"]["outs"])]:
        if row["outs"] != mono_outs:
            raise AssertionError(f"disagg: a {row['kind']} turn's tokens "
                                 f"differ")
    n = len(disagg_outs)
    if out["no_prefill"] != dict(prefills=0, bucket_tokens=0, adoptions=n):
        raise AssertionError(f"disagg: the decode replica ran a prefill or "
                             f"missed an adoption: {out['no_prefill']}")
    if out["fetches"] != (float(n), 0.0) or out["warned"]:
        raise AssertionError(f"disagg: handoffs over (gRPC, HTTP) "
                             f"{out['fetches']} for {n} requests; warnings "
                             f"{out['warned']}")
    if out["plain_http"] != mono_outs[1]:
        raise AssertionError(f"disagg: the HTTP-fetched handoff adopted "
                             f"gave {out['plain_http']}, /generate "
                             f"{mono_outs[1]}")
    if not out["fetch_s"]["same"]:
        raise AssertionError("disagg: gRPC and HTTP fetched other bytes")
    check_pages(out["pages"], out["index"], "decode", True, cuda)
    check_pages(out["child_pages"], out["child_index"], "prefill", False,
                cuda)
    status, timeline, _ = out["tracez"]
    names = [p["name"] for p in timeline.get("phases", [])]
    total = sum(p["duration_s"] for p in timeline.get("phases", []))
    if status != 200 or not timeline.get("stitched") \
            or sorted(names) != ["decode", "handoff_gap", "kv_transfer",
                                 "prefill"] \
            or abs(total - timeline["e2e_s"]) > 0.10 * timeline["e2e_s"] \
            or not timeline["records"]["prefill"]:
        raise AssertionError(f"disagg: tracez {status} {timeline}")
    status, whyz, _ = out["whyz"]
    if status != 200 or not whyz.get("verdicts"):
        raise AssertionError(f"disagg: whyz {status} {whyz}")
    start, stop = out["profile_start"], out["profile_stop"]
    if start[1]["status"] != "started" or stop[1]["status"] != "stopped":
        raise AssertionError(f"disagg: profiler {start} {stop}")
    kernels, trace_bytes = out["trace"]
    want = expected_launches(cfg, out["profile_counters"])
    ragged_events = named(kernels, "ragged_kernel")
    flash_events = named(kernels, "flash_wgmma_kernel")
    if cuda and (not flash_events
                 or flash_events != out["profile_launches"]["flash"]
                 or ragged_events != out["profile_launches"]["ragged"]
                 or ragged_events != want["ragged"]):
        raise AssertionError(
            f"disagg: the profile holds {flash_events} flash_wgmma_kernel "
            f"and {ragged_events} ragged_kernel events; the counters "
            f"{out['profile_launches']}, expected {want}")
    capture = out["capture_under_profile"]
    if capture["first"] != capture["second"] or capture["first"][0] != 201:
        raise AssertionError(f"disagg: a request whose graph was captured "
                             f"under the profiler: {capture}")
    after = out["after_kill"]
    status, clusterz, _ = after["clusterz"]
    peer = clusterz["replicas"]["pf"] if status == 200 else None
    if after["circuit"] != "open" or status != 200 or not peer["stale"] \
            or peer["stale_reason"] != "circuit open" \
            or after["generate"][0] != 503:
        raise AssertionError(f"disagg: after the prefill replica's kill: "
                             f"circuit {after['circuit']}, clusterz {status} "
                             f"{peer}, /disagg/generate {after['generate'][0]}")
    turns = [{k: v for k, v in r.items() if k != "outs"}
             for r in out["turns"]]
    row = dict(
        child_ready_s=out["child_ready_s"],
        decode_start_s=out["decode_start_s"], counters=c,
        launches=out["launches"], no_prefill=out["no_prefill"],
        fetches=out["fetches"], kv_bytes_per_request=out[
            "kv_bytes_per_request"], fetch_s=out["fetch_s"], turns=turns,
        page_ms={p: g[2] for p, g in out["pages"].items()},
        poll_turns=out["poll_turns"],
        profiled_tokens_per_s=out["profiled"]["tokens_per_s"],
        trace_bytes=trace_bytes, trace_flash_events=flash_events,
        trace_ragged_events=ragged_events,
        capture_under_profile=dict(capture, first=None, second=None,
                                   tokens_equal=True),
        after_kill=dict(answers=after["answers"], circuit=after["circuit"]),
        child_exit=out["child_exit"], tries=out["tries"],
        phase_s=time.monotonic() - t_phase)
    results["disagg_app"] = row
    log(f"disagg: {n} x {APP_BUDGET} greedy requests through "
        f"/disagg/generate = the decode replica's /generate; no prefill "
        f"there ({out['no_prefill']}); handoffs over (gRPC, HTTP) "
        f"{out['fetches']}; an HTTPTransport without gRPC: its handoff "
        f"adopted gives /generate's tokens; launches {out['launches']}")
    log(f"disagg: KV {row['kv_bytes_per_request']:.0f} bytes a request; "
        f"one {out['fetch_s']['bytes']}-byte handoff fetched over gRPC in "
        f"{out['fetch_s']['grpc']:.4f}s, over HTTP in "
        f"{out['fetch_s']['http']:.4f}s")
    for r in turns:
        log(f"disagg turn {r['kind']}: {r['tokens_per_s']:.1f} tok/s, client "
            + ("TTFT" if r["kind"] == "monolithic" else "latency")
            + f" p50 {r['client_p50_s']:.4f}s, engine TTFT p50 "
            f"{r['engine_ttft_p50_s']:.4f}s")
    log("disagg pages (ms while a burst runs): " + ", ".join(
        f"{p} {ms:.1f}" for p, ms in row["page_ms"].items()))
    log("disagg pages polled every 100 ms: " + ", ".join(
        f"{r['kind']} {r['tokens_per_s']:.1f} tok/s ({r['polls']} polls)"
        for r in row["poll_turns"]))
    log(f"disagg profiler: {row['profiled_tokens_per_s']:.1f} tok/s under "
        f"it; trace.json {trace_bytes} bytes, {flash_events} "
        f"flash_wgmma_kernel and {ragged_events} ragged_kernel events "
        f"(launches counted {out['profile_launches']}); a constrained "
        f"request's {capture['lazy_captures']} graphs captured under the "
        f"profiler replay its tokens")
    log(f"disagg: prefill replica stopped ({out['child_exit']}); "
        f"/disagg/generate answered {after['answers']} until the circuit "
        f"opened, then {after['generate'][0]}; clusterz 200, the peer stale "
        f"({peer['stale_reason']}); phase 38 {row['phase_s']:.1f}s")
    return {"disagg_app": out["launches"]}


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def _numel(tree):
    return (leaf.numel() for leaf in _leaves(tree))


# -- phase 39: serving over a device mesh ------------------------------------
# the per-rank attention shapes of the sharded paths (39d): llama3-8b at
# tp 2 (Hq 16 / Hkv 4) and tp 4 (8 / 2), small at tp 2 (8 / 8)
LLAMA3_TP2 = dataclasses.replace(LLAMA3, q_heads=16, kv_heads=4)
LLAMA3_TP4 = dataclasses.replace(LLAMA3, q_heads=8, kv_heads=2)
SMALL_TP2 = dataclasses.replace(SMALL, q_heads=8, kv_heads=8)
# teacher-forced logits of a sharded model against the unsharded one
# (39b, 39c): relative L2 a step, phase 7's bf16 gate (a card's bf16
# against the CPU's f32). The row-parallel sums of wo and w_down reorder
# bf16 roundings (each rank's product rounded to bf16, the ranks summed
# in float32, one rounding): differences of the order of a bf16 ulp a
# layer, far inside a gate a wrong shard or a missing rank's part fails
# by ~0.5 or more
MESH_REL_TOL = MODEL_REL_TOL
MESH_STEPS = 4
RING_SEQ = 8192                  # 39e: B 1, S 8192, llama3-8b heads
# ring attention's bf16 output against the plain causal attention's: the
# same function as the flash kernel's, held to phase 3's gate (one bf16
# ulp at |x| < 4 is 1.6e-2, which a run on the H100 reached)
RING_TOL = FLASH_TOL
# 39f: the same ops in the same order, over microbatches of 2 rows (GEMMs
# of other shapes than the unsharded forward's, whose bits may differ)
PP_TOL = MODEL_REL_TOL


def kv_shards(engine):
    """The engine's KV leaves by name, every shard of a sharded leaf
    apart (``name@coordinate``)."""
    leaves = engine._pool.leaves if engine.paged else engine.cache
    out = {}
    for name, leaf in leaves.items():
        if hasattr(leaf, "addressable_shards"):
            out.update({f"{name}@{coord}": t
                        for coord, t in leaf.addressable_shards})
        else:
            out[name] = leaf
    return out


def mesh_expected(cfg, counters, dp, tp):
    """:func:`expected_launches` over a dp × tp mesh: a prefill runs on
    dp row 0's tp ranks, a decode step on every rank of every row."""
    want = expected_launches(cfg, counters)
    prefills = counters["prefills"] + counters["prefill_lazy"]
    want["flash"] = cfg.n_layers * prefills * tp
    for name in ("ragged", "int8"):
        want[name] *= dp * tp
    return want


def tp_params(torch, params, axes, device="cuda"):
    """Each dp row's ``TPShards`` of ``params`` over ``axes`` on the card
    (every shard on cuda:0), as the engine holds them."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.quant import quantized_specs
    from gofr_tpu_torch.parallel import collectives, make_mesh, sharding

    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    mesh = make_mesh(axes, [dev] * 8)
    specs = sharding.prune_specs(quantized_specs(
        sharding.llama_param_specs(), params), mesh)
    sharded = sharding.shard_pytree(params, mesh, specs)
    return [llama.TPShards([sharding.local_tree(sharded, c) for c in line],
                           collectives.Group([mesh.devices[c]
                                              for c in line]))
            for line in mesh.axis_coords("tp")]


def teacher_forced(torch, llama, cfg, params, axes, paged, seed, what,
                   results, device="cuda"):
    """39b/39c's gate: one prefill and ``MESH_STEPS`` decode steps of the
    model unsharded and over ``axes`` (each dp row over its slots, each
    of its tp ranks over its heads), fed the same tokens (the unsharded
    run's greedy ones); relative L2 of the logits a step within
    ``MESH_REL_TOL``. A CPU rehearsal passes ``device="cpu"``."""
    import numpy as np

    from gofr_tpu_torch.tpu.page_pool import PagePool

    rng = np.random.default_rng(seed)
    b, s, page = 4, 64, 32
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             device=device)
    lengths = torch.tensor([64, 40, 17, 33], device=device)
    rows = tp_params(torch, params, axes, device)
    dp, tp = len(rows), len(rows[0])
    rank_cfg = llama.rank_config(cfg, tp)

    def run(row_params, c, sl, feed):
        record = not feed
        tok, lens = tokens[sl], lengths[sl]
        n = tok.shape[0]
        small = llama.init_cache(c, n, 512, device=device)
        if isinstance(row_params, llama.TPShards):
            small = [llama.init_cache(rank_cfg, n, 512, device=device)
                     for _ in range(tp)]
        logits, small, cache_len = llama.prefill(row_params, c, tok, small,
                                                 lengths=lens)
        out = [logits.float()]
        active = torch.ones(n, dtype=torch.bool, device=device)
        if paged:
            table = torch.arange(n * 16, dtype=torch.int32,
                                 device=device).view(n, 16)
            geo = c if not isinstance(row_params, llama.TPShards) \
                else rank_cfg
            pools = [PagePool(geo, page=page, num_pages=n * 16,
                              device=device).leaves
                     for _ in (small if isinstance(small, list)
                               else [small])]
            for pool, sm in zip(pools, small if isinstance(small, list)
                                else [small]):
                for name in pool:
                    pool[name][:, :n * 16] = sm[name].reshape(
                        c.n_layers, n * 16, page, *sm[name].shape[3:])
            kv = pools if isinstance(small, list) else pools[0]
        else:
            kv = small
        for step in range(MESH_STEPS):
            if record:
                feed.append(logits.argmax(-1))
            if paged:
                logits, _, cache_len = llama.decode_step_paged(
                    row_params, c, feed[step][sl], kv, table, cache_len,
                    active)
            else:
                logits, _, cache_len = llama.decode_step(
                    row_params, c, feed[step][sl], kv, cache_len)
            out.append(logits.float())
        return out

    feed = []
    want = run(params, cfg, slice(0, b), feed)
    per = b // dp
    got = [torch.cat(step) for step in zip(*[
        run(rows[d], cfg, slice(d * per, (d + 1) * per),
            [f for f in feed]) for d in range(dp)])]
    rel = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
    agree = sum(int((g.argmax(-1) == w.argmax(-1)).sum())
                for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"{what}: teacher-forced logits over {axes} against unsharded, "
        f"relative L2 a step {[round(r, 6) for r in rel]} (gate "
        f"{MESH_REL_TOL}); top-1 agreement {agree}/{len(got) * b}")
    results[what] = dict(rel_l2=rel, top1_agree=agree,
                         top1_total=len(got) * b, bound=MESH_REL_TOL)
    if not finite or max(rel) > MESH_REL_TOL:
        raise AssertionError(f"{what}: sharded logits off by {max(rel)} "
                             f"(finite {finite}), gate {MESH_REL_TOL}")


def mesh_burst(torch, generate, mods, cfg, params, axes, engine_kw, path,
               ref_outs, exact, seed, results, profile=False):
    """One engine over a mesh of ``axes`` shards all on cuda:0: phase 9's
    burst (``serve_burst``: warm-up captures, every tick and prefill a
    replay), its launch counts against :func:`mesh_expected`, a tick's
    replay against its eager run, and its 7 greedy completions against
    ``ref_outs`` (the unsharded engine's): equal when ``exact`` (one
    shard), counted otherwise. Returns the launches."""
    from gofr_tpu_torch.parallel import make_mesh

    cuda = torch.device("cuda", 0)
    mesh = make_mesh(axes, [cuda] * 8)
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine = generate.GenerationEngine(cfg, params, mesh=mesh, device=cuda,
                                       **engine_kw)
    dp, tp = mesh.shape.get("dp", 1), mesh.shape.get("tp", 1)

    def replay_check(engine):
        key = ("plain", 1, False, None if engine.paged else
               engine._window_ladder[0])
        if key not in engine._graphs:
            key = next(iter(engine._graphs))
        engine.active.fill_(True)
        replay_equals_eager(
            torch, engine,
            lambda: engine._tick_body(key, engine.active).clone(),
            lambda: engine._run_tick(key, None, None)(), f"{path} {key}")
        engine.active.fill_(False)
        return key

    outs, wall, launches, counters, ttfts, figures = serve_burst(
        torch, engine, prompts, budget, samplings, mods, 900,
        stream_tokens=8, profile=profile, extra=None)
    check_launches(launches, mesh_expected(cfg, counters, dp, tp), path)
    key = replay_check(engine)
    equal = sum(int(a == b) for got, ref in zip(outs[:7], ref_outs)
                for a, b in zip(got, ref))
    tokens = budget * len(outs)
    row = dict(mesh=dict(mesh.shape), devices=mesh.distinct_devices,
               requests=len(outs), new_tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
               ttft_max_s=ttfts[-1], launches=launches, counters=counters,
               kv_bytes=kv_bytes(engine), replay_key=list(key),
               greedy_equal_tokens=equal, greedy_tokens=7 * budget,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               params_bytes=engine.hbm_attribution()["params_bytes"],
               **figures)
    results[path] = row
    log(f"{path}: mesh {dict(mesh.shape)} on {mesh.distinct_devices} card: "
        f"{len(outs)} requests x {budget} tokens in {wall:.3f}s = "
        f"{row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.4f}s; launches {launches} (each rank's); "
        f"capture {figures['capture_s']:.2f}s ticks + "
        f"{figures['prefill_capture_s']:.2f}s prefills, reserved after "
        f"warmup {figures['reserved_after_warmup']}, params "
        f"{row['params_bytes']} B; greedy tokens equal "
        f"to the unsharded engine's: {equal}/{7 * budget}")
    if exact and outs[:7] != ref_outs:
        raise AssertionError(f"{path}: a one-shard mesh's greedy tokens "
                             f"differ from the unsharded engine's")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_mesh_llama3(torch, llama, generate, mods, cfg, params, seed,
                      results):
    """Phases 39a-b on the llama3-8b weights of phases 9-18: a one-shard
    mesh (dense and paged) bit for bit the unsharded engine; tp 2 with
    both shards on the card (dense, paged, paged kv_int8): teacher-forced
    logits, a burst, replay = eager, each rank's launches. Returns
    launches by path."""
    by_path = {}
    base = dict(max_slots=8, max_len=2048, prompt_buckets=(32, 128, 512),
                steps_per_tick=4, kv_page=32)
    log("== phase 39a: llama3-8b over a mesh {dp: 1, tp: 1} on the card, "
        "dense then paged: the unsharded engine's greedy tokens bit for bit")
    for paged, ref in ((False, "dense"), (True, "engine")):
        path = f"mesh_tp1_{'paged' if paged else 'dense'}"
        by_path[path] = mesh_burst(
            torch, generate, mods, cfg, params, {"dp": 1, "tp": 1},
            dict(base, paged_kv=paged), path, results[ref]["greedy_outputs"],
            True, seed, results, profile=paged)
    log("== phase 39b: llama3-8b at tp 2, both shards on cuda:0 (Hq 16 / "
        "Hkv 4 a rank): teacher-forced logits, then dense, paged and paged "
        "kv_int8 bursts")
    for paged, int8 in ((False, False), (True, False), (True, True)):
        c = dataclasses.replace(cfg, kv_int8=int8)
        name = ("paged" if paged else "dense") + ("_int8" if int8 else "")
        teacher_forced(torch, llama, c, params, {"tp": 2}, paged, seed,
                       f"mesh_tp2_{name}_logits", results)
        ref = engine_kind(c, paged, False)[0]
        by_path[f"mesh_tp2_{name}"] = mesh_burst(
            torch, generate, mods, c, params, {"tp": 2},
            dict(base, paged_kv=paged), f"mesh_tp2_{name}",
            results[ref]["greedy_outputs"], False, seed, results,
            profile=paged and not int8)
    tp1, tp2 = results["mesh_tp1_paged"], results["mesh_tp2_paged"]
    log(f"39b: paged tp 2 against tp 1 (both on one card): "
        f"{tp2['tokens_per_s']:.1f} vs {tp1['tokens_per_s']:.1f} tok/s; "
        f"device idle share {tp2.get('device_idle_share')} vs "
        f"{tp1.get('device_idle_share')}; tick capture "
        f"{tp2['capture_s']:.2f} vs {tp1['capture_s']:.2f}s, reserved "
        f"after warmup {tp2['reserved_after_warmup']} vs "
        f"{tp1['reserved_after_warmup']}, params {tp2['params_bytes']} vs "
        f"{tp1['params_bytes']} B")
    return by_path


def phase_mesh_small(torch, llama, generate, mods, cfg, params, seed,
                     results):
    """Phase 39c: ``small`` (head_dim 64, phase 20's weights and burst) at
    tp 2 (Hq 8 / Hkv 8 a rank, the ``d64`` body at group 1) and at dp 2 ×
    tp 1, dense, every shard on the card. Returns launches by path."""
    log("== phase 39c: small (D 64) at tp 2 and at dp 2 x tp 1, dense, "
        "shards on cuda:0")
    by_path = {}
    for axes, name in (({"tp": 2}, "mesh_small_tp2"),
                       ({"dp": 2, "tp": 1}, "mesh_small_dp2")):
        teacher_forced(torch, llama, cfg, params, axes, False, seed,
                       f"{name}_logits", results)
        by_path[name] = mesh_burst(
            torch, generate, mods, cfg, params, axes, SMALL_ENGINE, name,
            results["small"]["greedy_outputs"], False, seed, results)
    return by_path


def identity_case(torch, ragged_mod, timer, geom, rung, what):
    """One ragged decode over an identity table at ``geom``, rung
    ``rung``: held to its plain version, timed with the bound and one
    SDPA call over the dense cache (``identity_sdpa_ms``)."""
    from gofr_tpu_torch.models import llama

    args, reach = dense_scenario(torch, llama, False, rung, 1, 31, geom)
    out = ragged_mod.ragged_paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite")
    err, row_err = check_ragged(torch, out, ref, what)
    ms = timer(lambda: ragged_mod.ragged_paged_decode_attention(*args),
               iters=20)
    plain_ms = timer(lambda: ragged_mod.ragged_paged_decode_attention_plain(
        *args), iters=3)
    lib_ms, lib_diff = identity_sdpa_ms(torch, timer, args, reach, geom,
                                        rung, out.float())
    nbytes, flops = paged_cost(reach, 1, args[3].numel(), False, geom)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(rung=rung, G=1, head_dim=geom.head_dim, q_heads=geom.q_heads,
               kv_heads=geom.kv_heads, max_abs_err=err, row_rel_l2=row_err,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_max_abs_diff=lib_diff, sdpa_ratio=ms / lib_ms,
               bound_ms=bound * 1e3,
               bound_by=("operations" if flops / BF16_FLOP_PER_S
                         >= nbytes / HBM_BYTES_PER_S else "bytes"))
    log(f"{what} err={err:.3e} row={row_err:.3e} kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
        f"({ms / lib_ms:.3f}x sdpa) bound={row['bound_ms']:.4f}ms")
    return row


def phase_mesh_kernels(torch, mods, results):
    """Phase 39d: each kernel of the sharded paths at a tp rank's shapes
    against its plain version, timed with its bound (and SDPA where one
    call computes the same: flash, identity tables)."""
    flash_mod, ragged_mod, _ = mods
    log("== phase 39d: the kernels at a tp rank's shapes (llama3-8b tp 2: "
        "Hq 16 / Hkv 4; tp 4: 8 / 2; small tp 2: 8 / 8)")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(39)
    out = {}
    fills = [0, 1, 31, 32, 33, 700, 2047, 512]
    for tag, geom in (("llama3_tp2", LLAMA3_TP2), ("llama3_tp4", LLAMA3_TP4)):
        out[f"{tag}_ragged"] = ragged_case(
            torch, ragged_mod, timer, False, fills, 1, 2,
            f"39d {tag} ragged paged decode", geom)
        out[f"{tag}_identity"] = [
            identity_case(torch, ragged_mod, timer, geom, rung,
                          f"39d {tag} identity decode rung {rung or 2048}")
            for rung in (128, 512, None)]
    out["llama3_tp2_ragged_int8"] = ragged_case(
        torch, ragged_mod, timer, True, fills, 1, 2,
        "39d llama3_tp2 ragged paged decode int8", LLAMA3_TP2)
    out["llama3_tp2_flash"] = flash_case(torch, flash_mod, timer, gen, 4, 512,
                                         LLAMA3_TP2)
    last = SMALL_TP2.width * 32 - 1
    out["small_tp2_ragged"] = ragged_case(
        torch, ragged_mod, timer, False, [0, 1, 31, 32, 33, 500, last, 512],
        1, 40, "39d small_tp2 ragged paged decode (d64 body)", SMALL_TP2)
    out["small_tp2_identity"] = [
        identity_case(torch, ragged_mod, timer, SMALL_TP2, rung,
                      f"39d small_tp2 identity decode rung {rung or 1024}")
        for rung in (128, 512, None)]
    out["small_tp2_flash"] = flash_case(torch, flash_mod, timer, gen, 4, 512,
                                        SMALL_TP2)
    results["mesh_kernels"] = out
    del timer
    torch.cuda.empty_cache()
    return out


def phase_mesh_ring(torch, llama, results):
    """Phase 39e: ring attention at sp 4 on the card (every ring rank on
    cuda:0), B 1, S 8192, llama3-8b heads, bf16, against the plain dense
    causal attention."""
    from gofr_tpu_torch.ops.attention import prefill_attention
    from gofr_tpu_torch.parallel import make_mesh, ring_attention

    log(f"== phase 39e: ring attention sp 4 on the card, B 1, S {RING_SEQ}, "
        f"Hq 32 / Hkv 8 / D 128, bf16, against the plain causal attention")
    gen = torch.Generator(device="cuda").manual_seed(395)
    q = torch.randn((1, RING_SEQ, 32, 128), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((1, RING_SEQ, 8, 128), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    mesh = make_mesh({"sp": 4}, [torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = ring_attention(q, k, v, mesh)
    torch.cuda.synchronize()
    ring_s = time.monotonic() - t0
    ref = prefill_attention(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    log(f"39e: ring {ring_s:.3f}s (host clock, first call); max|ring - "
        f"plain| {err:.3e} (gate {RING_TOL})")
    results["mesh_ring"] = dict(seq=RING_SEQ, sp=4, max_abs_err=err,
                                ring_s=ring_s, tol=RING_TOL)
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    if not err <= RING_TOL:
        raise AssertionError(f"39e: ring attention off by {err}")


def phase_mesh_pp(torch, llama, params, cfg, results):
    """Phase 39f: the pp 2 forward (GPipe, 4 microbatches) of ``small``
    (phase 20's weights) against the unsharded forward, both through the
    plain attention."""
    from gofr_tpu_torch.parallel import make_mesh, make_pp_forward

    c = dataclasses.replace(cfg, use_flash=False)
    log(f"== phase 39f: pp 2 forward of small ({c.n_layers} layers), 4 "
        f"microbatches, B 8 S 128, against the unsharded forward")
    tokens = torch.randint(0, c.vocab_size, (8, 128), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(396))
    mesh = make_mesh({"pp": 2}, [torch.device("cuda", 0)] * 2)
    got = make_pp_forward(c, mesh, n_microbatches=4)(params, tokens)
    want = llama.forward(params, c, tokens)
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    same = bool(torch.equal(got, want))
    log(f"39f: max|pp - unsharded| {err:.3e}, relative L2 {rel:.3e} (gate "
        f"{PP_TOL}); bits equal {same}; finite "
        f"{bool(torch.isfinite(got).all())}")
    results["mesh_pp"] = dict(max_abs_err=err, rel_l2=rel, bits_equal=same,
                              tol=PP_TOL)
    if not (torch.isfinite(got).all() and rel <= PP_TOL):
        raise AssertionError(f"39f: pp forward off by {rel}")


def phase_mesh_executor(torch, executor_mod, resnet, seed, results):
    """Phase 39g: ResNet-50 through the Executor over a dp 2 mesh (both
    shards on the card, one graph a bucket running each shard's half),
    B 32, against dp 1 on the same weights."""
    import numpy as np

    from gofr_tpu_torch.parallel import make_mesh

    log("== phase 39g: ResNet-50 through the Executor at dp 2 (both shards "
        "on cuda:0), B 32, against dp 1")
    rcfg = resnet.config("50")
    rparams = resnet.init(rcfg, seed + 41, device="cuda")

    def fn(p, x):
        return resnet.apply(p, rcfg, x)

    rng = np.random.default_rng(seed + 397)
    x = rng.standard_normal((32, rcfg.image_size, rcfg.image_size, 3)) \
        .astype(np.float32)
    outs, times = {}, {}
    for dp in (1, 2):
        mesh = make_mesh({"dp": dp}, [torch.device("cuda", 0)] * 2)
        ex = executor_mod.Executor(None, None, mesh=mesh, device="cuda")
        ex.register("resnet", fn, rparams, buckets=(32,))
        ex.warmup("resnet", x[0])
        outs[dp] = ex.predict("resnet", x)
        t0 = time.monotonic()
        for _ in range(5):
            ex.predict("resnet", x)
        times[dp] = (time.monotonic() - t0) / 5
        ex.close()
    err = rel_err(outs[2], outs[1])
    log(f"39g: dp 2 against dp 1: max rel err {err:.3e} (gate "
        f"{EXEC_REL_TOL}); predict B 32 {times[2] * 1e3:.3f} ms vs "
        f"{times[1] * 1e3:.3f} ms (host clock)")
    results["mesh_executor"] = dict(max_rel_err=err, tol=EXEC_REL_TOL,
                                    predict_s={str(k): v
                                               for k, v in times.items()})
    if not (np.isfinite(outs[2]).all() and err <= EXEC_REL_TOL):
        raise AssertionError(f"39g: dp 2 outputs off by {err}")


def phase_mesh_app(torch, results):
    """Phase 39h: the example with ``MESH=1`` (dp 1 × tp 1 over the card)
    serves ``/generate``; ``MESH=tp:2`` fails at build with one card."""
    from gofr_tpu_torch.examples import llama_generate

    log("== phase 39h: the example's MESH: MESH=1 serves /generate, "
        "MESH=tp:2 fails at build on one card")
    env = dict(LLAMA_PRESET="small", MESH="1", GENERATE_SLOTS="2",
               STEPS_PER_TICK="4")
    with app_environment(env):
        app = llama_generate.build_app(device="cuda")
    body = {"prompt": "the mesh of one card", "max_new_tokens": 8}

    async def main():
        await app.start()
        try:
            return await http_call(app.bound_http_port, "POST", "/generate",
                                   body)
        finally:
            await app.stop()
    status, _, payload = asyncio.run(main())
    tokens = json.loads(payload)["data"]["tokens"] if status == 201 else []
    mesh = app.engine.stats()["mesh"]
    with app_environment(dict(env, MESH="tp:2")):
        try:
            llama_generate.build_app(device="cuda")
            refused = None
        except ValueError as err:
            refused = str(err)
    log(f"39h: MESH=1 -> mesh {mesh}, POST /generate {status}, "
        f"{len(tokens)} tokens; MESH=tp:2 refused at build: {refused!r}")
    results["mesh_app"] = dict(status=status, tokens=len(tokens), mesh=mesh,
                               refused=refused)
    del app
    torch.cuda.empty_cache()
    if status != 201 or len(tokens) != 8 or mesh != {"dp": 1, "tp": 1} \
            or not refused or "needs 2 devices" not in refused:
        raise AssertionError("39h: the example's MESH knob misbehaved")


def phase_mesh_dist(torch, results):
    """Phase 39i: ``initialize_distributed`` at world size 1 over NCCL
    (one all-reduce), then ``dcn_check``'s two processes on the card,
    reporting the backend that served; then the distinct-card route
    (39-multicard) when there are several cards."""
    from gofr_tpu_torch.parallel import collectives, multihost
    from gofr_tpu_torch.parallel.dcn_check import (_free_port,
                                                   run_two_process_check)

    import torch.distributed as dist

    log("== phase 39i: initialize_distributed at world size 1 (NCCL), "
        "dcn_check's two processes on the card")
    saved = {k: os.environ.get(k) for k in (
        "JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    os.environ.update(JAX_COORDINATOR=f"127.0.0.1:{_free_port()}",
                      JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    try:
        started = multihost.initialize_distributed()
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        backend = dist.get_backend()
        info = multihost.process_info()
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"39i: started {started}, backend {backend}, all_reduce "
        f"{x.tolist()}, process_info {info}")
    reports = run_two_process_check(local_devices=2, timeout=300,
                                    device="cuda", backend="gloo")
    for r in reports:
        log(f"39i dcn_check: {json.dumps(r)}")
    results["mesh_dist"] = dict(world1_backend=backend, process_info=info,
                                dcn=reports)
    if not started or backend != "nccl" or x.tolist() != [0, 1, 2, 3] \
            or not all(r["ok"] for r in reports):
        raise AssertionError("39i: the distributed runtime misbehaved")
    n = torch.cuda.device_count()
    if n < 2:
        print(json.dumps({"phase": "39-multicard", "skipped": "1 card"}),
              flush=True)
        results["mesh_multicard"] = {"skipped": "1 card"}
        return
    log(f"== phase 39-multicard: collectives across {n} cards (peer copies)")
    devs = [torch.device("cuda", i) for i in range(n)]
    parts = [torch.full((1024,), float(i + 1), device=d)
             for i, d in enumerate(devs)]
    summed = collectives.all_reduce(parts, devs)
    gathered = collectives.all_gather(parts, devs, dim=0)
    moved = collectives.ppermute(parts, devs)
    total = float(sum(range(1, n + 1)))
    ok = all(t.device == d and bool((t == total).all())
             for t, d in zip(summed, devs)) \
        and all(t.shape[0] == 1024 * n for t in gathered) \
        and all(float(m[0]) == float((i - 1) % n + 1)
                for i, m in enumerate(moved))
    results["mesh_multicard"] = dict(cards=n, ok=ok)
    log(f"39-multicard: all_reduce, all_gather, ppermute over {n} cards: "
        f"{ok}")
    if not ok:
        raise AssertionError("39-multicard: a collective across cards is "
                             "wrong")


# -- phase 40: training over a device mesh ------------------------------------
# (a) small at full width and depth over dp 2 x tp 2 x sp 2 with use_sp,
# (b) llama3-8b's width at BIG_LAYERS over tp 2 and tp 4, (c) moe-small
# over ep 2 (float32) and ep 2 x tp 2, (d) checkpoints of (a)'s state:
# every shard on cuda:0; 40-multicard: dp 2 over two cards, where a host
# has two. Phase 36's weights, batches and gates.
TRAIN_MESH = {"dp": 2, "tp": 2, "sp": 2}
MESH_TRAIN_STEPS = 3
# 40a, 40c at float32: the mesh's loss against one device's, relative,
# and each gradient, first moment and second moment leaf within
# MESH_F32_TOL of that leaf's largest element (the sums run in other
# orders: the tp ranks' partial products, the ring's online softmax).
# Params after one step: within MESH_F32_TOL of the leaf's largest where
# the first moment is settled (|mu| > 1e-2 of its leaf's largest), and
# within 2·lr elsewhere: Adam's first step is ±lr wherever |g| >> eps, so
# a gradient at its rounding noise may take either sign (the CPU parity
# tests' rule, tests/test_torch_train.py)
MESH_F32_LOSS_RTOL = 1e-5
MESH_F32_TOL = 1e-4


def mesh_devices(torch, device, n):
    """``n`` mesh entries, every one the card (cuda:0) or the CPU."""
    dev = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)
    return [dev] * n


def full_leaves(sharding, tree_util, tree):
    """Every leaf of ``tree`` as one tensor (a sharded leaf gathered),
    by key."""
    return {key: leaf.gather() if isinstance(leaf, sharding.Sharded)
            else leaf for key, leaf in tree_util.flatten(tree).items()}


def rel_to_max(got, want):
    """max |got - want| over max |want|, leaf by leaf (dicts by key)."""
    return {key: ((got[key].float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30)).item()
            for key, w in want.items()}


def past_step_gate(got, want, mu, lr):
    """The leaves of params ``got`` past 40a's gate against ``want``
    after one step (``mu``: ``want``'s first moments): (worst settled
    difference over the leaf's largest, worst difference anywhere)."""
    out = {}
    for key, w in want.items():
        d = (got[key].float() - w.float()).abs()
        m = mu[key].float().abs()
        tight = m > 1e-2 * m.max()
        scale = w.float().abs().max().item()
        settled_d = d[tight].max().item() / scale if bool(tight.any()) \
            else 0.0
        if settled_d > MESH_F32_TOL or d.max().item() > 2 * lr:
            out[key] = (settled_d, d.max().item())
    return out


def grad_cosines(torch, got, want):
    return {key: torch.nn.functional.cosine_similarity(
        got[key].float().flatten(), w.float().flatten(), dim=0).item()
        for key, w in want.items()}


def phase_train_mesh(torch, llama, moe, train, checkpoint, mods, seed,
                     results, device="cuda", small_cfg=None, moe_cfg=None,
                     big_cfg=None, batches=(TRAIN_BATCH, MOE_BATCH,
                                            BIG_BATCH)):
    """Phase 40 (after phase 39): training over a device mesh, every
    shard on the one card. Returns the launches of 40b's eval through
    the flash kernel, by path."""
    from gofr_tpu_torch.parallel import sharding
    from gofr_tpu_torch.utils import tree as tree_util

    t_phase = time.monotonic()
    out = results.setdefault("train_mesh", {})
    kit = (torch, train, sharding, tree_util)
    phase_mesh_train_small(kit, llama, checkpoint, small_cfg
                           or llama.config("small"), batches[0], seed, out,
                           device)
    one = results.get("train", {}).get("small")
    if one:
        mine = out["small"]
        log(f"40a against 36a in this run: {mine['step_ms_mean_2_3']:.3f} ms "
            f"a mesh step, {one['step_ms_median']:.3f} ms on one device; "
            f"idle share {mine['idle_share']} against {one['idle_share']}")
    free_device(torch, device)
    by_path = phase_mesh_train_big(kit, llama, mods, big_cfg or llama.config(
        "llama3-8b", n_layers=BIG_LAYERS), batches[2], seed, out, device)
    free_device(torch, device)
    phase_mesh_train_moe(kit, moe, moe_cfg or moe.config("small"),
                         batches[1], seed, out, device)
    free_device(torch, device)
    if device == "cuda":
        phase_mesh_train_multicard(kit, llama, seed, out)
    results["phase40_s"] = time.monotonic() - t_phase
    log(f"phase 40: {results['phase40_s']:.1f}s ({card_label(device)})")
    return by_path


def phase_mesh_train_small(kit, llama, checkpoint, cfg, batch, seed, out,
                           device):
    """40a and 40d on ``cfg`` (``small`` whole) at ``batch`` over
    TRAIN_MESH with ``use_sp``."""
    import tempfile

    torch, train, sharding, tree_util = kit
    from gofr_tpu_torch.parallel import make_mesh

    card = card_label(device)
    mesh = make_mesh(TRAIN_MESH, mesh_devices(torch, device, 8))
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 1,
                                  device)
    log(f"== phase 40a: train small ({cfg.n_layers} layers, dim {cfg.dim}, "
        f"D {cfg.head_dim}, vocab {cfg.vocab_size}) at B {batch[0]} x S "
        f"{batch[1]} over {TRAIN_MESH} with use_sp, every shard on "
        f"{mesh.devices.flat[0]}; {card}")
    full = lambda tree: full_leaves(sharding, tree_util, tree)  # noqa: E731

    # one float32 step from the state of the unsharded float32 step
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    init32, step32 = train.make_train_step(cfg32, device=device)
    _, mstep32 = train.make_train_step(cfg32, mesh, use_sp=True,
                                       device=device)
    state = init32(seed)
    mstate = train.shard_train_state(state, mesh)
    loss_u, grads_u = train.value_and_grad(
        lambda p, t, y: llama.loss_fn(p, cfg32, t, y), state.params, tokens,
        targets)
    loss_m, grads_m = train.value_and_grad(
        lambda p, t, y: llama.loss_fn(p, cfg32, t, y, mesh=mesh),
        mstate.params, tokens, targets)
    loss_rel = abs(loss_m.item() - loss_u.item()) / abs(loss_u.item())
    grad_rel = rel_to_max(full(grads_m), full(grads_u))
    del grads_u, grads_m
    step32(state, tokens, targets)
    mstep32(mstate, tokens, targets)
    got, want = full(mstate), full(state)
    mu_key = ".opt_state/0/.mu/"
    moment_keys = [k for k in want if "/.mu/" in k or "/.nu/" in k]
    moments = rel_to_max({k: got[k] for k in moment_keys},
                         {k: want[k] for k in moment_keys})
    params = {k[len(".params/"):]: got[k] for k in got
              if k.startswith(".params/")}
    ref = {k[len(".params/"):]: want[k] for k in want
           if k.startswith(".params/")}
    mu = {k: want[mu_key + k] for k in ref}
    past = past_step_gate(params, ref, mu, 3e-4)
    log(f"40a float32: loss {loss_m.item():.7f} over the mesh, "
        f"{loss_u.item():.7f} on one device (rel {loss_rel:.3e}); worst "
        f"gradient leaf {max(grad_rel.values()):.3e} of its largest "
        f"({grad_rel}); worst moment leaf {max(moments.values()):.3e}; "
        f"params past the gate {past}")
    out["f32"] = dict(loss_mesh=loss_m.item(), loss_one=loss_u.item(),
                      loss_rel=loss_rel, grad_rel=grad_rel,
                      moment_rel=moments, params_past=past)
    if loss_rel > MESH_F32_LOSS_RTOL or max(grad_rel.values()) > \
            MESH_F32_TOL or max(moments.values()) > MESH_F32_TOL or past:
        raise AssertionError(f"phase 40a: the float32 mesh step left its "
                             f"gates: loss rel {loss_rel}, gradients "
                             f"{grad_rel}, moments {moments}, params {past}")
    del state, mstate, got, want, params, ref, mu

    # three bf16 steps from 36a's state; the checkpoint at step 2 (40d)
    init_fn, init_step = train.make_train_step(cfg, device=device)
    _, mstep = train.make_train_step(cfg, mesh, use_sp=True, device=device)
    state0 = init_fn(seed)
    mstate = train.shard_train_state(state0, mesh)
    loss_u, grads_u = train.value_and_grad(
        lambda p, t, y: llama.loss_fn(p, cfg, t, y), state0.params, tokens,
        targets)
    _, grads_m = train.value_and_grad(
        lambda p, t, y: llama.loss_fn(p, cfg, t, y, mesh=mesh),
        mstate.params, tokens, targets)
    cosines = grad_cosines(torch, full(grads_m), full(grads_u))
    del grads_u, grads_m
    # the unsharded step in this call, for the ratio (a copy of state0)
    one = sharding.clone_tree(state0)
    (one_ms, _), one_peak = peak_bytes(torch, lambda: timed_steps(
        torch, lambda: init_step(one, tokens, targets)[1], 3, device),
        device)
    del one
    free_device(torch, device)
    (ms, losses), peak = peak_bytes(torch, lambda: timed_steps(
        torch, lambda: mstep(mstate, tokens, targets)[1], 2, device),
        device)
    with tempfile.TemporaryDirectory(prefix="gofr_mesh_ckpt_") as tmp:
        t0 = time.monotonic()
        checkpoint.save_checkpoint(tmp, mstate, step=2,
                                   metadata={"preset": "small",
                                             "mesh": TRAIN_MESH})
        save_s = time.monotonic() - t0
        saved = sharding.clone_tree(mstate)
        again = sharding.clone_tree(mstate)
        ms3, loss3 = timed_steps(torch, lambda: mstep(
            mstate, tokens, targets)[1], 1, device)
        ms, losses = ms + ms3, [l.item() for l in losses + loss3]
        _, loss_again = mstep(again, tokens, targets)
        t0 = time.monotonic()
        restored = checkpoint.restore_checkpoint(
            tmp, mstate, sharding=tree_util.tree_map(
                lambda leaf: leaf.sharding, mstate))
        restore_s = time.monotonic() - t0
        plain = checkpoint.restore_checkpoint(tmp, state0, device=device)
    del state0
    restored_bits = same_bits(torch, tree_util, full(restored), full(saved))
    plain_bits = same_bits(torch, tree_util, plain, full(saved))
    specs_kept = all(
        leaf.spec == ref_leaf.spec and leaf.mesh is mesh
        for leaf, ref_leaf in zip(tree_util.flatten(restored).values(),
                                  tree_util.flatten(mstate).values()))
    del plain, saved
    _, loss_resumed = mstep(restored, tokens, targets)
    straight = full(mstate)
    spread = leaf_diffs(tree_util, full(again), straight)
    resumed = leaf_diffs(tree_util, full(restored), straight)
    outside = within_spread(resumed, spread, leaf_scales(tree_util,
                                                         straight))
    loss_rel = abs(losses[0] - loss_u.item()) / abs(loss_u.item())
    step_ms = sum(ms[1:]) / len(ms[1:])
    one_step_ms = sum(one_ms[1:]) / len(one_ms[1:])
    log(f"40a bf16 {card}: losses {[round(l, 5) for l in losses]} over the "
        f"mesh, the unsharded step's first {loss_u.item():.5f} (rel "
        f"{loss_rel:.3e}); gradient cosines, worst "
        f"{min(cosines.values()):.5f} ({cosines}); step ms "
        f"{[round(m, 3) for m in ms]} (mean of steps 2-3 {step_ms:.3f}), "
        f"on one device in this call {[round(m, 3) for m in one_ms]} "
        f"({one_step_ms:.3f}: {step_ms / one_step_ms:.2f}x); peak bytes "
        f"{peak} over the mesh, {one_peak} on one device")
    log(f"== phase 40d: save {save_s:.2f}s, restore with sharding= "
        f"{restore_s:.2f}s; restored bits equal {restored_bits}, specs and "
        f"mesh kept {specs_kept}; restored with device= equal to the "
        f"gathered shards {plain_bits}; step 3 loss {losses[2]:.6f} "
        f"straight, {loss_again.item():.6f} again, "
        f"{loss_resumed.item():.6f} resumed; leaves differing run to run "
        f"{ {k: v for k, v in spread.items() if v} }; resumed past the "
        f"spread {outside}")
    if not (losses[-1] < losses[0] and loss_rel <= F32_LOSS_RTOL
            and min(cosines.values()) >= F32_GRAD_COS):
        raise AssertionError(f"phase 40a: bf16 losses {losses} (one "
                             f"device {loss_u.item()}), cosines {cosines}")
    if not (restored_bits and plain_bits and specs_kept) or outside or (
            loss_resumed.item() != losses[2]
            and loss_again.item() == losses[2]):
        raise AssertionError(f"phase 40d: the restored run left the "
                             f"straight run: {outside}")
    del restored, again, straight

    # the device's idle share of one more step
    idle, top, profile = None, [], {}
    if device == "cuda":
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mstep(mstate, tokens, targets)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kernel, calls = device_times(torch, prof)
        busy = sum(by_kernel.values())
        idle = 1.0 - busy / wall
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        gemm_s = sum(sec for name, sec in by_kernel.items() if any(
            tag in name.lower()
            for tag in ("gemm", "cutlass", "xmma", "nvjet")))
        log(f"40a one mesh step profiled: {wall * 1e3:.3f} ms wall, device "
            f"busy {busy * 1e3:.3f} ms over {sum(calls.values())} device "
            f"events, of it GEMMs {gemm_s * 1e3:.3f} ms; idle share "
            f"{idle:.3f}; top kernels (s) {top}")
        profile = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                       gemm_ms=gemm_s * 1e3, events=sum(calls.values()))
    out["small"] = dict(card=card, mesh=TRAIN_MESH, batch=list(batch),
                        losses=losses, first_loss_one_device=loss_u.item(),
                        loss_rel=loss_rel, grad_cos=cosines, step_ms=ms,
                        step_ms_mean_2_3=step_ms, one_device_ms=one_ms,
                        one_device_ms_mean_2_3=one_step_ms,
                        peak_bytes=peak, one_device_peak_bytes=one_peak,
                        idle_share=idle, profile=profile,
                        top_kernels=[[k, v] for k, v in top])
    out["checkpoint"] = dict(save_s=save_s, restore_s=restore_s,
                             restored_bits=restored_bits,
                             device_restore_bits=plain_bits,
                             spread=spread, resumed_diff=resumed,
                             loss_straight=losses[2],
                             loss_again=loss_again.item(),
                             loss_resumed=loss_resumed.item())
    del mstate


def phase_mesh_train_big(kit, llama, mods, cfg, batch, seed, out, device):
    """40b: ``llama3-8b``'s width at ``cfg.n_layers`` layers, remat, at
    ``batch``: tp 2 (three steps from 36f's state), tp 4 (one step), the
    eval over tp 2 through the flash kernel."""
    torch, train, sharding, tree_util = kit
    from gofr_tpu_torch.parallel import make_mesh

    card = card_label(device)
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 3,
                                  device)
    log(f"== phase 40b: llama3-8b width (GQA {cfg.n_heads}:{cfg.n_kv_heads}, "
        f"D {cfg.head_dim}, vocab {cfg.vocab_size}) at {cfg.n_layers} "
        f"layers, bf16, remat, B {batch[0]} x S {batch[1]}; {card}")
    init_fn, step_fn = train.make_train_step(cfg, remat=True, device=device)
    state = init_fn(seed)
    mesh2 = make_mesh({"tp": 2}, mesh_devices(torch, device, 2))
    mstate = train.shard_train_state(state, mesh2)
    (one_ms, one_losses), one_peak = peak_bytes(torch, lambda: timed_steps(
        torch, lambda: step_fn(state, tokens, targets)[1], 2, device),
        device)
    loss_one = one_losses[0].item()
    del state
    free_device(torch, device)
    _, mstep = train.make_train_step(cfg, mesh2, remat=True, device=device)
    (ms, losses), peak = peak_bytes(torch, lambda: timed_steps(
        torch, lambda: mstep(mstate, tokens, targets)[1], MESH_TRAIN_STEPS,
        device), device)
    losses = [l.item() for l in losses]
    rel = abs(losses[0] - loss_one) / abs(loss_one)
    log(f"40b tp 2 (Hq {cfg.n_heads // 2} / Hkv {cfg.n_kv_heads // 2} a "
        f"rank): losses {[round(l, 5) for l in losses]}, tp 1's first "
        f"{loss_one:.5f} (rel {rel:.3e}); step ms "
        f"{[round(m, 3) for m in ms]} against tp 1's "
        f"{[round(m, 3) for m in one_ms]} in this call; peak bytes {peak} "
        f"(tp 1: {one_peak}, the tp 2 state held beside it)")
    if not (losses[-1] < losses[0] and rel <= F32_LOSS_RTOL):
        raise AssertionError(f"phase 40b: tp 2 losses {losses} against tp "
                             f"1's {loss_one}")

    # the eval over tp 2 through the flash kernel, against tp 1's
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    mesh_eval = train.make_eval_step(flash_cfg, mesh2, device=device)
    for mod in mods:
        mod.reset_launches()
    mesh_loss = mesh_eval(mstate.params, tokens, targets).item()
    launches = read_launches(mods)
    plain_params = sharding.gather_pytree(mstate.params)
    one_loss = train.make_eval_step(flash_cfg, device=device)(
        plain_params, tokens, targets).item()
    del plain_params
    want = dict.fromkeys(launches, 0)
    want["flash"] = cfg.n_layers * 2
    if device == "cuda":
        check_launches(launches, want, "train_eval_mesh_llama3")
    eval_rel = abs(mesh_loss - one_loss) / abs(one_loss)
    eval_ms, _ = timed_steps(torch, lambda: mesh_eval(
        mstate.params, tokens, targets), 3, device)
    for mod in mods:
        mod.reset_launches()
    log(f"40b eval over tp 2 through the flash kernel: loss {mesh_loss:.6f}"
        f", tp 1's flash eval {one_loss:.6f} (rel {eval_rel:.3e}); "
        f"launches {launches}; eval ms {[round(m, 3) for m in eval_ms]}")
    if eval_rel > EVAL_FLASH_RTOL:
        raise AssertionError(f"phase 40b: the tp 2 flash eval rel {eval_rel}")
    del mstate
    free_device(torch, device)

    # tp 4: 8:2 heads a rank (dry-run phase 7's tp 4 over GQA)
    mesh4 = make_mesh({"tp": 4}, mesh_devices(torch, device, 4))
    init4, step4 = train.make_train_step(cfg, mesh4, remat=True,
                                         device=device)
    state4 = init4(seed)
    ms4, loss4 = timed_steps(torch, lambda: step4(state4, tokens,
                                                  targets)[1], 1, device)
    loss4 = loss4[0].item()
    ln_v = math.log(cfg.vocab_size)
    log(f"40b tp 4 (Hq {cfg.n_heads // 4} / Hkv {cfg.n_kv_heads // 4} a "
        f"rank): one step, loss {loss4:.5f} (ln V {ln_v:.5f}), "
        f"{ms4[0]:.3f} ms")
    if not (math.isfinite(loss4) and abs(loss4 - ln_v) <= 0.1 * ln_v):
        raise AssertionError(f"phase 40b: tp 4 loss {loss4}")
    out["llama3_8b"] = dict(
        card=card, layers=cfg.n_layers, batch=list(batch), tp2_losses=losses,
        tp1_first_loss=loss_one, tp2_loss_rel=rel, tp2_step_ms=ms,
        tp2_peak_bytes=peak, tp1_step_ms=one_ms, tp1_peak_bytes=one_peak,
        eval_mesh_loss=mesh_loss, eval_one_loss=one_loss,
        eval_rel=eval_rel, eval_launches=launches, eval_ms=eval_ms,
        tp4_loss=loss4, tp4_step_ms=ms4[0])
    del state4
    return {"train_eval_mesh_llama3": launches}


def phase_mesh_train_moe(kit, moe, cfg, batch, seed, out, device):
    """40c: ``moe-small`` at ``batch``: ep 2 x tp 1 at float32 against
    the unsharded model (drops layer by layer, loss, gradients); ep 2 x
    tp 2 at bf16, three AdamW steps."""
    torch, train, sharding, tree_util = kit
    from gofr_tpu_torch.parallel import make_mesh

    card = card_label(device)
    tokens, targets = train_batch(torch, cfg.vocab_size, batch, seed + 2,
                                  device)
    full = lambda tree: full_leaves(sharding, tree_util, tree)  # noqa: E731
    log(f"== phase 40c: moe-small ({cfg.n_experts} experts) at B {batch[0]}"
        f" x S {batch[1]}: ep 2 at float32, ep 2 x tp 2 at bf16; {card}")
    cfg32 = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, dtype=torch.float32))
    params = moe.init(cfg32, seed, device=device)
    mesh = make_mesh({"ep": 2}, mesh_devices(torch, device, 2))
    specs = sharding.prune_specs(sharding.moe_param_specs(), mesh)
    sharded = sharding.shard_pytree(params, mesh, specs)
    drops_one, drops_mesh = [], []
    loss_u, grads_u = train.value_and_grad(
        lambda p, t, y: moe.loss_fn(p, cfg32, t, y, drops_one), params,
        tokens, targets)
    loss_m, grads_m = train.value_and_grad(
        lambda p, t, y: moe.loss_fn(p, cfg32, t, y, drops_mesh), sharded,
        tokens, targets)
    drops_one = [d.item() for d in drops_one]
    drops_mesh = [d.item() for d in drops_mesh]
    loss_rel = abs(loss_m.item() - loss_u.item()) / abs(loss_u.item())
    grad_rel = rel_to_max(full(grads_m), full(grads_u))
    log(f"40c ep 2 float32: dropped tokens a layer {drops_mesh} (one device "
        f"{drops_one}, of {batch[0] * batch[1]}); loss {loss_m.item():.7f} "
        f"against {loss_u.item():.7f} (rel {loss_rel:.3e}); gradients, "
        f"worst leaf {max(grad_rel.values()):.3e} of its largest, router "
        f"{grad_rel['layers/router']:.3e}")
    if drops_mesh != drops_one or loss_rel > MESH_F32_LOSS_RTOL or \
            max(grad_rel.values()) > MESH_F32_TOL:
        raise AssertionError(f"phase 40c: ep 2 float32: drops {drops_mesh} "
                             f"against {drops_one}, loss rel {loss_rel}, "
                             f"gradients {grad_rel}")
    del params, sharded, grads_u, grads_m
    free_device(torch, device)

    params = moe.init(cfg, seed, device=device)
    mesh = make_mesh({"ep": 2, "tp": 2}, mesh_devices(torch, device, 4))
    sharded = sharding.shard_pytree(
        params, mesh, sharding.prune_specs(sharding.moe_param_specs(), mesh))
    del params
    opt_state = train.adamw_init(sharded)
    record = []

    def step():
        drops = []
        loss, grads = train.value_and_grad(
            lambda p, t, y: moe.loss_fn(p, cfg, t, y, drops), sharded,
            tokens, targets)
        router = grads["layers"]["router"].gather()
        train.adamw_update(grads, opt_state, sharded)
        record.append((router.abs().max(), torch.isfinite(router).all(),
                       torch.stack(drops)))
        return loss

    ms, losses = timed_steps(torch, step, MESH_TRAIN_STEPS, device)
    losses = [l.item() for l in losses]
    router_max = [r.item() for r, _, _ in record]
    finite = all(f.item() for _, f, _ in record)
    drops = [d.tolist() for _, _, d in record]
    log(f"40c ep 2 x tp 2 bf16: losses {[round(l, 5) for l in losses]}; "
        f"router grad max {router_max}, finite {finite}; dropped a layer "
        f"{drops}; step ms {[round(m, 3) for m in ms]}")
    if not (losses[-1] < losses[0] and finite and min(router_max) > 0):
        raise AssertionError(f"phase 40c: ep 2 x tp 2 losses {losses}, "
                             f"router grads {router_max}, finite {finite}")
    out["moe"] = dict(card=card, batch=list(batch), f32_drops=drops_mesh,
                      f32_drops_one=drops_one, f32_loss_rel=loss_rel,
                      f32_grad_rel=grad_rel, losses=losses,
                      router_grad_max=router_max, dropped=drops, step_ms=ms)
    del sharded, opt_state


def phase_mesh_train_multicard(kit, llama, seed, out):
    """40-multicard: dp 2 over two distinct cards, where the host has two
    (``small`` at CUT_SMALL_LAYERS, float32, B 4 x S 256): one step's loss
    against one card's, the two cards' replicas bit-equal after it."""
    torch, train, sharding, tree_util = kit
    from gofr_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        print(json.dumps({"phase": "40-multicard", "skipped": "1 card"}),
              flush=True)
        out["multicard"] = {"skipped": "1 card"}
        return
    log(f"== phase 40-multicard: dp 2 training over cuda:0 and cuda:1")
    cfg = llama.config("small", n_layers=CUT_SMALL_LAYERS,
                       dtype=torch.float32)
    mesh = make_mesh({"dp": 2}, [torch.device("cuda", i) for i in (0, 1)])
    tokens, targets = train_batch(torch, cfg.vocab_size, (4, 256), seed + 4,
                                  "cuda")
    init_fn, step_fn = train.make_train_step(cfg, device="cuda")
    state = init_fn(seed)
    mstate = train.shard_train_state(state, mesh)
    _, loss_one = step_fn(state, tokens, targets)
    _, loss_mesh = train.make_train_step(cfg, mesh, device="cuda")[1](
        mstate, tokens, targets)
    rel = abs(loss_mesh.item() - loss_one.item()) / abs(loss_one.item())
    equal = all(
        all(torch.equal(t.cpu(), leaf.distinct_shards()[0].cpu())
            for t in leaf.distinct_shards())
        for leaf in tree_util.flatten(mstate).values())
    log(f"40-multicard: loss {loss_mesh.item():.7f} against one card's "
        f"{loss_one.item():.7f} (rel {rel:.3e}); replicas bit-equal {equal}")
    out["multicard"] = dict(cards=n, loss_rel=rel, replicas_equal=equal)
    if rel > MESH_F32_LOSS_RTOL or not equal:
        raise AssertionError("40-multicard: dp 2 across cards diverged")


# -- phase 41: the datasources on the card ---------------------------------------

LANE_WIRE_JOBS, LANE_WIRE_MQTT_JOBS, LANE_WIRE_NEW = 16, 8, 64
LANE_WIRE_TOPICS = dict(BATCH_LANE_TOPIC="lane-jobs",
                        BATCH_LANE_RESULT_TOPIC="lane-results",
                        BATCH_LANE_DEAD_TOPIC="lane-dead")
LANE_WIRE_GROUP = "llama-lane"
PATH_KERNELS.update({"phase41_lane_kafka": ("flash", "ragged"),
                     "phase41_lane_mqtt": ("flash", "ragged")})


def lane_wire_migrations(calls):
    """One migration through SQL, one through Redis; ``calls`` counts
    the runs."""
    def jobs_table(ds):
        calls.append(1)
        ds.sql.execute("CREATE TABLE lane_jobs (id TEXT PRIMARY KEY, "
                       "tokens INTEGER)")

    def lane_config(ds):
        calls.append(2)
        ds.redis.set("lane:max_new_tokens", str(LANE_WIRE_NEW))

    return {1: jobs_table, 2: lane_config}


def lane_wire_jobs(cfg, seed, n, lo=64, hi=257, new_tokens=LANE_WIRE_NEW):
    import numpy as np

    rng = np.random.default_rng(seed + 41)
    return [dict(id=f"job-{i}",
                 prompt_ids=rng.integers(0, cfg.vocab_size, int(k)).tolist(),
                 max_new_tokens=new_tokens)
            for i, k in enumerate(rng.integers(lo, hi, n))]


async def read_topic(client, topic, count, timeout=120.0):
    """``count`` JSON messages of ``topic`` through a pub/sub client."""
    out = []
    for _ in range(count):
        message = await asyncio.wait_for(client.subscribe(topic), timeout)
        out.append(json.loads(message.value.decode()))
        message.commit()
    return out


async def until(predicate, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 41: timed out waiting for {what}")
        await asyncio.sleep(0.005)


def commit_regressions(commits, group, topic):
    """Times the group's committed offset on ``topic`` moved back."""
    offsets = [o for g, t, _, o in commits if (g, t) == (group, topic)]
    return sum(b < a for a, b in zip(offsets, offsets[1:]))


def phase_lane_wire(torch, generate, mods, seed, results, device="cuda",
                    env=None, sizes=APP_PROMPT_BYTES, n_jobs=LANE_WIRE_JOBS,
                    n_mqtt=LANE_WIRE_MQTT_JOBS, prompt_range=(64, 257),
                    new_tokens=LANE_WIRE_NEW, budget=APP_BUDGET):
    """Phase 41: the example app at its defaults with its datasources
    configured, its batch lane fed over Kafka, then a lane over MQTT on
    the same engine. Returns launches by path. A CPU rehearsal passes
    ``device="cpu"``, ``env`` (e.g. ``{"LLAMA_PRESET": "tiny"}``), prompt
    ``sizes``, fewer jobs, a ``prompt_range``, ``new_tokens`` and an HTTP
    ``budget`` that fit its cache and time, with ``check_launches``
    stubbed."""
    import tempfile

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.pubsub.kafka import KafkaClient
    from gofr_tpu_torch.datasource.pubsub.mqtt import MQTTClient
    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.logging import new_silent_logger
    from gofr_tpu_torch.tpu import batch_lane as lane_mod
    from scripts.wire_brokers import KafkaLog, MQTTBroker, RESPServer

    t_phase = time.monotonic()
    cuda = device == "cuda"
    kafka, mqtt, resp = KafkaLog(), MQTTBroker(), RESPServer()
    tmp = tempfile.TemporaryDirectory(prefix="phase41-")
    topic = LANE_WIRE_TOPICS["BATCH_LANE_TOPIC"]
    result_topic = LANE_WIRE_TOPICS["BATCH_LANE_RESULT_TOPIC"]
    dead_topic = LANE_WIRE_TOPICS["BATCH_LANE_DEAD_TOPIC"]
    broker_addr = f"127.0.0.1:{kafka.port}"
    lane_env = dict(
        LANE_WIRE_TOPICS, PUBSUB_BACKEND="KAFKA", KAFKA_BROKER=broker_addr,
        CONSUMER_ID=LANE_WIRE_GROUP, BATCH_LANE_MAX_INFLIGHT="16",
        BATCH_LANE_PAUSE_DEPTH="4", BATCH_LANE_RESUME_DEPTH="1",
        BATCH_LANE_POLL_S="0.005",
        DB_DIALECT="sqlite", DB_NAME=str(Path(tmp.name) / "lane.db"),
        REDIS_HOST="127.0.0.1", REDIS_PORT=str(resp.port))
    out = {}
    log_ = new_silent_logger()

    def client(cls, values):
        return cls(MapConfig(values), log_, metrics)

    with app_environment(dict(lane_env, **(env or {}))):
        app = llama_generate.build_app(device=device)
        engine = app.engine
        cfg = engine.cfg
        metrics = app.container.metrics
        log(f"== phase 41: the datasources on the card: the example app "
            f"(dim {cfg.dim}, {cfg.n_layers} layers, head_dim "
            f"{cfg.head_dim}, {engine.max_slots} slots, max_len "
            f"{engine.max_len}) with KAFKA at {broker_addr}, sqlite on a "
            f"file, Redis over RESP2 at :{resp.port}; {n_jobs} Kafka jobs "
            f"beside an HTTP burst, {n_mqtt} MQTT jobs")
        calls = []
        migrations = lane_wire_migrations(calls)
        app.migrate(migrations)
        app.migrate(migrations)
        out["migrations"] = dict(
            calls=list(calls),
            journal=app.container.sql.select(
                "SELECT version, method FROM gofr_migrations"),
            redis_journal=sorted(app.container.redis.hgetall(
                "gofr_migrations")),
            redis_value=app.container.redis.get("lane:max_new_tokens"))
        jobs = lane_wire_jobs(cfg, seed, n_jobs, *prompt_range, new_tokens)
        mqtt_jobs = lane_wire_jobs(cfg, seed + 1, n_mqtt, *prompt_range,
                                   new_tokens)
        prompts = app_corpus(seed, sizes)
        bodies = app_bodies(prompts, seed, budget)

        async def main():
            t0 = time.monotonic()
            await app.start()
            out["start_s"] = time.monotonic() - t0
            lane = app.container.batch_lane
            # another service: it publishes the jobs and reads the
            # results; a reader of its own (a group of one) reads the
            # dead letters
            producer = client(KafkaClient, dict(
                KAFKA_BROKER=broker_addr, CONSUMER_ID="lane-results-reader",
                APP_NAME="lane-producer"))
            dead_reader = client(KafkaClient, dict(
                KAFKA_BROKER=broker_addr, CONSUMER_ID="lane-dead-reader",
                APP_NAME="lane-dead-reader"))
            try:
                await engine.generate(jobs[0]["prompt_ids"][:8], 8)
                status, _, body = await http_call(
                    app.bound_http_port, "GET", "/.well-known/health")
                out["health"] = (status, json.loads(body))
                # the Kafka turn: jobs from another service beside the
                # HTTP burst
                for mod in mods:
                    mod.reset_launches()
                before = run_counters(engine)
                wire0 = kafka.wire_bytes()
                t_lane = time.monotonic()
                for job in jobs:
                    producer.publish(topic, json.dumps(job).encode())
                http = asyncio.ensure_future(http_turn(app.bound_http_port,
                                                       bodies))
                got = await read_topic(producer, result_topic, n_jobs)
                out["kafka_wall_s"] = time.monotonic() - t_lane
                out["kafka_wire_bytes"] = kafka.wire_bytes() - wire0
                out["http"] = await http
                await until(lambda: not lane._jobs, "the lane to settle")
                out["launches"] = read_launches(mods)
                after = run_counters(engine)
                out["counters"] = {k: after[k] - before[k] for k in after}
                out["kafka_results"] = got
                out["results_on_topic"] = len(kafka.messages(result_topic))
                # a malformed job, then the committed offset
                producer.publish(topic, b"not json \xff")
                out["dead"] = await read_topic(dead_reader, dead_topic, 1)
                await until(lambda: kafka.offsets.get(
                    (LANE_WIRE_GROUP, topic, 0)) == n_jobs + 1,
                    "the malformed job's commit", 10.0)
                out["committed"] = kafka.offsets[(LANE_WIRE_GROUP, topic, 0)]
                out["commit_regressions"] = commit_regressions(
                    kafka.commits, LANE_WIRE_GROUP, topic)
                out["lane"] = lane.stats()
                out["paused_total"] = metrics.value(
                    "app_pubsub_consumer_paused_total", topic=topic,
                    reason=lane_mod.PAUSE_ADMISSION) or 0.0
                # the app's lane stops and leaves the group; a lane on a
                # new client of the group starts from the committed offset
                await lane.stop()
                app.container.pubsub.close()
                fresh = client(KafkaClient, dict(
                    KAFKA_BROKER=broker_addr, CONSUMER_ID=LANE_WIRE_GROUP,
                    APP_NAME="lane-restarted"))
                restarted = lane_mod.BatchLane(
                    engine, fresh, topic, result_topic=result_topic,
                    dead_letter_topic=dead_topic, poll_s=0.005,
                    metrics=metrics, logger=log_)
                await restarted.start()
                group = kafka.groups[LANE_WIRE_GROUP]
                generation = group["generation"]
                await until(lambda: group["generation"] > generation
                            and group["state"] == "stable",
                            "the restarted member's join")
                fetches = kafka.fetches
                await until(lambda: kafka.fetches >= fetches + 2,
                            "the restarted member's fetches")
                out["restarted"] = dict(
                    ok=restarted.jobs_ok, dead=restarted.jobs_dead_lettered,
                    results_on_topic=len(kafka.messages(result_topic)),
                    committed=kafka.offsets[(LANE_WIRE_GROUP, topic, 0)])
                await restarted.stop()
                fresh.close()
                out["direct"] = await asyncio.gather(*[
                    engine.generate(j["prompt_ids"], new_tokens)
                    for j in jobs])
                # the MQTT turn on the same engine
                mqtt_values = dict(MQTT_HOST="127.0.0.1",
                                   MQTT_PORT=str(mqtt.port), MQTT_QOS="1")
                lane_client = client(MQTTClient, dict(
                    mqtt_values, MQTT_CLIENT_ID="lane"))
                mqtt_producer = client(MQTTClient, dict(
                    mqtt_values, MQTT_CLIENT_ID="producer"))
                mqtt_lane = lane_mod.BatchLane(
                    engine, lane_client, "mqtt-jobs",
                    result_topic="mqtt-results", poll_s=0.005,
                    metrics=metrics, logger=log_)
                try:
                    reader = asyncio.ensure_future(read_topic(
                        mqtt_producer, "mqtt-results", n_mqtt))
                    await mqtt_lane.start()
                    await until(lambda: mqtt.subscribers("mqtt-jobs")
                                and mqtt.subscribers("mqtt-results"),
                                "the MQTT subscriptions")
                    for mod in mods:
                        mod.reset_launches()
                    before = run_counters(engine)
                    graphs0 = engine.stats()["graphs"]["captured"]
                    wire0 = mqtt.wire_bytes()
                    t_mqtt = time.monotonic()
                    for job in mqtt_jobs:
                        mqtt_producer.publish("mqtt-jobs",
                                              json.dumps(job).encode())
                    out["mqtt_results"] = await reader
                    out["mqtt_wall_s"] = time.monotonic() - t_mqtt
                    out["mqtt_wire_bytes"] = mqtt.wire_bytes() - wire0
                    await until(lambda: not mqtt_lane._jobs,
                                "the MQTT lane to settle")
                    out["mqtt_launches"] = read_launches(mods)
                    after = run_counters(engine)
                    out["mqtt_counters"] = {k: after[k] - before[k]
                                            for k in after}
                    out["mqtt_new_graphs"] = \
                        engine.stats()["graphs"]["captured"] - graphs0
                finally:
                    await mqtt_lane.stop()
                    lane_client.close()
                    mqtt_producer.close()
                out["mqtt_direct"] = await asyncio.gather(*[
                    engine.generate(j["prompt_ids"], new_tokens)
                    for j in mqtt_jobs])
            finally:
                producer.close()
                dead_reader.close()
                await app.stop()

        try:
            asyncio.run(main())
        finally:
            for server in (kafka, mqtt, resp):
                server.stop()
            tmp.cleanup()
    # gates
    mig = out["migrations"]
    if mig["calls"] != [1, 2] or [r["version"] for r in mig["journal"]] \
            != [1, 2] or mig["redis_journal"] != ["1", "2"] \
            or mig["redis_value"] != str(LANE_WIRE_NEW):
        raise AssertionError(f"phase 41: migrations {mig}")
    status, health = out["health"]
    ups = {name: health.get(name, {}).get("status")
           for name in ("sql", "redis", "pubsub", "tpu")}
    if status != 200 or health["status"] != "UP" \
            or set(ups.values()) != {"UP"}:
        raise AssertionError(f"phase 41: health {status} {ups}, status "
                             f"{health['status']}")
    direct = {j["id"]: toks for j, toks in zip(jobs, out["direct"])}
    got = {r["id"]: r["tokens"] for r in out["kafka_results"]}
    equal = sum(got.get(k) == v for k, v in direct.items())
    if len(out["kafka_results"]) != n_jobs or equal != n_jobs \
            or out["results_on_topic"] != n_jobs:
        raise AssertionError(f"phase 41: {equal} of {n_jobs} Kafka jobs "
                             f"equal direct generation; "
                             f"{len(got)} distinct ids, "
                             f"{out['results_on_topic']} results on the "
                             f"topic")
    dead = out["dead"][0]
    if dead["error"]["type"] != "JobError":
        raise AssertionError(f"phase 41: dead letter {dead}")
    if out["committed"] != n_jobs + 1:
        raise AssertionError(f"phase 41: committed offset "
                             f"{out['committed']}, expected {n_jobs + 1}")
    r = out["restarted"]
    if (r["ok"], r["dead"], r["results_on_topic"], r["committed"]) \
            != (0, 0, n_jobs, n_jobs + 1):
        raise AssertionError(f"phase 41: the restarted lane {r}")
    if out["paused_total"] < 1 or out["lane"]["pauses"] < 1:
        raise AssertionError(f"phase 41: the Kafka consumer never paused: "
                             f"counted {out['paused_total']}, lane "
                             f"{out['lane']}")
    c = out["counters"]
    if cuda and (c["lazy_captures"] or c["prefill_lazy"]
                 or c["replays"] != c["ticks"] + c["spec_ticks"]):
        raise AssertionError(f"phase 41: a tick was not a replay: {c}")
    check_launches(out["launches"], expected_launches(cfg, c),
                   "phase41_lane_kafka")
    mdirect = {j["id"]: t for j, t in zip(mqtt_jobs, out["mqtt_direct"])}
    mgot = {r["id"]: r["tokens"] for r in out["mqtt_results"]}
    mequal = sum(mgot.get(k) == v for k, v in mdirect.items())
    if mequal != n_mqtt or len(out["mqtt_results"]) != n_mqtt:
        raise AssertionError(f"phase 41: {mequal} of {n_mqtt} MQTT jobs "
                             f"equal direct generation")
    mc = out["mqtt_counters"]
    if out["mqtt_new_graphs"] or mc["lazy_captures"] or mc["prefill_lazy"]:
        raise AssertionError(f"phase 41: the MQTT turn captured a graph: "
                             f"{out['mqtt_new_graphs']} new, {mc}")
    check_launches(out["mqtt_launches"], expected_launches(cfg, mc),
                   "phase41_lane_mqtt")
    kafka_tokens = sum(len(t) for t in got.values())
    mqtt_tokens = sum(len(t) for t in mgot.values())
    row = dict(
        start_s=out["start_s"], migrations=mig, health_keys=sorted(health),
        kafka_tokens_per_s=kafka_tokens / out["kafka_wall_s"],
        kafka_wall_s=out["kafka_wall_s"],
        kafka_wire_bytes_per_job=out["kafka_wire_bytes"] / n_jobs,
        mqtt_tokens_per_s=mqtt_tokens / out["mqtt_wall_s"],
        mqtt_wall_s=out["mqtt_wall_s"],
        mqtt_wire_bytes_per_job=out["mqtt_wire_bytes"] / n_mqtt,
        memory_lane_tokens_per_s=[
            t["lane_tokens_per_s"] for t in results.get(
                "lane_small", {}).get("turns", []) if t.get("lane")],
        committed=out["committed"],
        commit_regressions=out["commit_regressions"],
        paused_total=out["paused_total"], lane=out["lane"],
        restarted=r, dead_letter=dead["error"], launches=out["launches"],
        counters=c, mqtt_launches=out["mqtt_launches"],
        mqtt_counters=mc, http_wall_s=out["http"][1],
        phase_s=time.monotonic() - t_phase)
    results["lane_wire"] = row
    log(f"phase 41: app started in {row['start_s']:.2f}s; migrations "
        f"applied once ({mig['calls']}); health {ups}; Kafka lane "
        f"{equal}/{n_jobs} equal to direct, {row['kafka_tokens_per_s']:.1f} "
        f"tok/s ({row['kafka_wall_s']:.3f}s, "
        f"{row['kafka_wire_bytes_per_job']:.0f} wire bytes a job) beside "
        f"the HTTP burst ({row['http_wall_s']:.3f}s); paused "
        f"{row['paused_total']:.0f} (lane pauses {out['lane']['pauses']}, "
        f"resumes {out['lane']['resumes']}); dead letter "
        f"{dead['error']['type']}; committed {out['committed']} "
        f"(moved back {out['commit_regressions']} times on the way); "
        f"restarted lane consumed {r['ok'] + r['dead']}; launches "
        f"{out['launches']}")
    log(f"phase 41: MQTT lane {mequal}/{n_mqtt} equal to direct, "
        f"{row['mqtt_tokens_per_s']:.1f} tok/s "
        f"({row['mqtt_wire_bytes_per_job']:.0f} wire bytes a job), no new "
        f"graph; in-memory lane (phase 35a, {CUT_SMALL_LAYERS} layers) "
        f"{row['memory_lane_tokens_per_s']} tok/s; phase 41 "
        f"{row['phase_s']:.1f}s")
    del engine, app
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"phase41_lane_kafka": out["launches"],
            "phase41_lane_mqtt": out["mqtt_launches"]}


# -- phase 42: the examples on the card at their own defaults ------------------

# every port 0, the logs at WARN; the knobs the examples read are unset
# but these, so each runs at its own defaults
EXAMPLE_ENV = dict(HTTP_PORT="0", METRICS_PORT="0", GRPC_PORT="0",
                   LOG_LEVEL="WARN")
EXAMPLE_UNSET = ("RESNET_PRESET", "BERT_PRESET", "PUBSUB_BACKEND",
                 "PUBSUB_BROKER", "KAFKA_BROKER", "CONSUMER_ID",
                 "DB_DIALECT", "DB_NAME", "DB_HOST", "REDIS_HOST",
                 "REDIS_PORT", "FACTS_URL", "CMD_LOGS_FILE", "TPU_MESH",
                 "MESH", "TPU_ENABLED", "APP_NAME", "REQUEST_TIMEOUT",
                 "FAULT_PLAN", "TRACE_EXPORTER", "BATCH_LANE_TOPIC",
                 "REMOTE_LOG_URL", "TPU_MAX_BATCH", "TPU_BATCH_DELAY_MS")
CLASSIFY_REQUESTS, CLASSIFY_INFLIGHT = 64, 16
EMBED_CALLS, EMBED_INFLIGHT = 32, 8
SUBSCRIBER_IMAGES = 32
WS_ROUND_TRIPS = 50
# a served logit against the eager forward of the same params on the card
# for that image alone, as a share of the forward's largest |logit|: a
# request's bucket (B 1 alone against B 4-64 padded) changes cuDNN's
# algorithm, so the bf16 bits need not match; a label is held only where
# the forward's top-two margin exceeds this tolerance. Phase 34's limit
# for the executor (bf16 on the card against f32 on the CPU).
EXAMPLE_REL_TOL = 2e-2
EXAMPLE_TURNS = ("direct", "http", "http", "direct")
PHASE42_LIMIT_S = 90.0

# the JAX example's answers: each (method, path, body, status, JSON body);
# tests/test_torch_examples.py holds every table to JAX's example on the
# CPU
EX_HTTP_SERVER = [
    ("GET", "/hello?name=H100", None, 200,
     {"data": {"message": "Hello H100!"}}),
    ("GET", "/user/1", None, 200, {"data": {"id": 1, "name": "ada"}}),
    ("GET", "/user/2", None, 404,
     {"error": {"message": "No entity found with id: 2"}}),
    ("POST", "/user", {"name": "ada", "age": 36}, 201,
     {"data": {"name": "ada", "age": 36}}),
    ("GET", "/nowhere", None, 404,
     {"error": {"message": "route not registered"}}),
    ("POST", "/hello", None, 405,
     {"error": {"message": "method not allowed"}}),
]
EX_CRUD = [
    ("POST", "/user", {"id": 1, "name": "ada", "age": 36,
                       "is_employed": True}, 201,
     {"data": "User successfully created with id: 1"}),
    ("GET", "/user", None, 200,
     {"data": [{"id": 1, "name": "ada", "age": 36, "is_employed": 1}]}),
    ("PUT", "/user/1", {"id": 1, "name": "ada", "age": 37,
                        "is_employed": True}, 200,
     {"data": "User successfully updated with id: 1"}),
    ("GET", "/user/1", None, 200,
     {"data": {"id": 1, "name": "ada", "age": 37, "is_employed": 1}}),
    ("DELETE", "/user/1", None, 204,
     {"data": "User successfully deleted with id: 1"}),
    ("GET", "/user/1", None, 404,
     {"error": {"message": "No entity found with id: 1"}}),
]
EX_MIGRATIONS = [
    ("GET", "/employee", None, 200,
     {"data": [{"id": 1, "name": "ada", "department": "compute"}]}),
    ("POST", "/employee", {"id": 2, "name": "bo", "department": "ops"}, 201,
     {"data": "Employee successfully created with id: 2"}),
    ("PUT", "/employee/2", {"id": 2, "name": "bo", "department": "infra"},
     200, {"data": "Employee successfully updated with id: 2"}),
    ("GET", "/employee/2", None, 200,
     {"data": {"id": 2, "name": "bo", "department": "infra"}}),
    ("DELETE", "/employee/2", None, 204,
     {"data": "Employee successfully deleted with id: 2"}),
]
EX_REDIS = [
    ("POST", "/redis", {"greeting": "hello", "count": "2"}, 201,
     {"data": "Successful"}),
    ("GET", "/redis/greeting", None, 200, {"data": {"greeting": "hello"}}),
    ("GET", "/redis/nope", None, 404,
     {"error": {"message": "No entity found with key: nope"}}),
    ("GET", "/redis-pipeline", None, 200,
     {"data": {"testKey1": "testValue1"}}),
]
EX_PUBLISHER = [
    ("POST", "/publish-order", {"orderId": "o1", "status": "pending"}, 201,
     {"data": "Published"}),
    ("POST", "/publish-product", {"productId": "p1", "price": "9"}, 201,
     {"data": "Published"}),
    ("POST", "/publish-product", {"productId": "p1"}, 400,
     {"error": {"message": "'1' invalid parameter(s): price"}}),
]
EX_TRANSACTIONS = [
    ("POST", "/transaction", {"amount": 120, "stock_left": 7}, 201,
     {"data": "transaction successful"}),
    ("POST", "/transaction", {"amount": 80, "stock_left": 7}, 201,
     {"data": "transaction successful"}),
    ("POST", "/return", {"amount": 50}, 201, {"data": "return successful"}),
    ("POST", "/transaction", {}, 400,
     {"error": {"message": "'1' invalid parameter(s): amount"}}),
]
EX_SERIES = {"transaction_success": 2.0, "total_credit_day_sale": 150.0,
             "product_stock": 7.0, "transaction_time_count": 2.0}
EX_FACT = {"fact": "cats nap a lot", "length": 14}
EX_ZIP_MEMBERS = [("a.txt", b"alpha"), ("b/b.txt", b"beta")]
EX_BOMB = (500, {"error": {"message": "some unexpected error has occurred"}})
EX_SPEC = {"openapi": "3.0.0", "info": {"title": "examples", "version": "1"},
           "paths": {"/hello": {"get": {"summary": "greet"}}}}


class example_environment(app_environment):
    """An example's environment for one step, restored after it."""

    base, unset = EXAMPLE_ENV, EXAMPLE_UNSET


@dataclasses.dataclass
class ExampleKit:
    """What phase 42's steps share: the device, the presets (None: each
    example's default), the sizes of the request sets, the scratch
    directory and the phase's figures (``out``)."""
    torch: object
    device: str
    seed: int
    tmp: str
    resnet_preset: str = None
    bert_preset: str = None
    n_classify: int = CLASSIFY_REQUESTS
    classify_inflight: int = CLASSIFY_INFLIGHT
    n_embed: int = EMBED_CALLS
    embed_inflight: int = EMBED_INFLIGHT
    n_images: int = SUBSCRIBER_IMAGES
    ws_round_trips: int = WS_ROUND_TRIPS
    out: dict = dataclasses.field(default_factory=dict)
    cmd_procs: dict = dataclasses.field(default_factory=dict)

    @property
    def cuda(self):
        return self.device == "cuda"

    def env(self, **extra):
        env = {}
        if self.resnet_preset:
            env["RESNET_PRESET"] = self.resnet_preset
        if self.bert_preset:
            env["BERT_PRESET"] = self.bert_preset
        return example_environment(dict(env, **extra))


async def check_answers(port, table, what):
    """Each request of ``table`` against its (status, JSON body)."""
    wrong = []
    for method, path, body, status, want in table:
        got_status, _, payload = await http_call(port, method, path, body)
        got = json.loads(payload) if payload else None
        if (got_status, got) != (status, want):
            wrong.append((method, path, got_status, got, status, want))
    if wrong:
        raise AssertionError(f"phase 42 {what}: answers differ from the "
                             f"JAX example's: {wrong}")
    return len(table)


def example_images(seed, n, size):
    """``n`` seeded images with two decimals (short JSON) as float32, and
    each one's ``/classify`` body."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = np.round(rng.uniform(-2.0, 2.0, (n, size, size, 3)), 2)
    return images.astype(np.float32), [
        json.dumps({"image": image.tolist()}).encode() for image in images]


def eager_forward(torch, fn, inputs, device):
    """``fn`` of each input alone (a batch of one) on ``device``, float32
    numpy rows."""
    import numpy as np

    rows = []
    with torch.no_grad():
        for example in inputs:
            args = [torch.from_numpy(np.asarray(leaf)[None]).to(device)
                    for leaf in (example if isinstance(example, tuple)
                                 else (example,))]
            rows.append(fn(*args).float().cpu().numpy()[0])
    if device == "cuda":
        torch.cuda.synchronize()
    return np.stack(rows)


def check_labels(labels, scores, ref, what):
    """Each served label equals the eager forward's wherever the forward's
    top-two margin exceeds the tolerance; each served score (None: not
    held) is within it of the forward's logit for that label. Returns the
    figures."""
    import numpy as np

    scale = np.abs(ref).max(axis=-1)
    tol = EXAMPLE_REL_TOL * scale
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > tol
    want = ref.argmax(axis=-1)
    wrong = [i for i in range(len(labels))
             if decided[i] and labels[i] != want[i]]
    score_err = [abs(s - ref[i, labels[i]]) / scale[i]
                 for i, s in enumerate(scores) if s is not None]
    far = [i for i, s in enumerate(scores)
           if s is not None and abs(s - ref[i, labels[i]]) > tol[i]]
    if wrong or far or not np.isfinite(ref).all():
        raise AssertionError(f"phase 42 {what}: labels {wrong} differ from "
                             f"the eager forward's where its margin exceeds "
                             f"{EXAMPLE_REL_TOL} of its largest |logit|; "
                             f"scores {far} beyond it")
    return dict(n=len(labels), decided=int(decided.sum()),
                equal=int(sum(int(a) == int(b)
                              for a, b in zip(labels, want))),
                max_score_rel_err=float(max(score_err)) if score_err
                else None,
                tol=EXAMPLE_REL_TOL)


def percentile(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def ledger_captures(executor):
    """{bucket: seconds} of each capture (compile) the ledger holds."""
    return {e["bucket"]: e["duration_s"]
            for e in executor.ledger.snapshot()["recent"]}


def ex_http_server(kit):
    """42a: ``http_server`` at its defaults (ResNet-50 at 224 x 224,
    buckets 1/4/16/32): its routes, then ``/classify`` and the app's own
    batcher in turns (direct, HTTP, HTTP, direct) at
    ``classify_inflight``; every HTTP label held to the eager forward."""
    import numpy as np

    from gofr_tpu_torch.examples import http_server
    from gofr_tpu_torch.models import resnet

    torch = kit.torch
    with kit.env():
        t0 = time.monotonic()
        app = http_server.build_app(device=kit.device)
        build_s = time.monotonic() - t0
        cfg = resnet.config(kit.resnet_preset or "50")
    executor = app.container.tpu
    params = executor._models["resnet50"].params
    log(f"== phase 42a: http_server (ResNet-{sum(cfg.stage_sizes) * 3 + 2} "
        f"at {cfg.image_size}^2, buckets {http_server.BUCKETS}): "
        f"{kit.n_classify} /classify at {kit.classify_inflight} in flight, "
        f"turns {EXAMPLE_TURNS}")
    images, bodies = example_images(kit.seed + 42, kit.n_classify,
                                    cfg.image_size)
    out = {}

    async def direct_turn_():
        sem = asyncio.Semaphore(kit.classify_inflight)
        seconds = [0.0] * len(images)

        async def one(i):
            async with sem:
                t = time.perf_counter()
                logits = await app.container.tpu_batcher.predict(
                    "resnet50", images[i])
                seconds[i] = time.perf_counter() - t
                return int(np.argmax(logits)), float(np.max(logits))

        t = time.perf_counter()
        got = await asyncio.gather(*[one(i) for i in range(len(images))])
        return got, seconds, time.perf_counter() - t

    async def http_turn_(port):
        sem = asyncio.Semaphore(kit.classify_inflight)
        seconds = [0.0] * len(images)

        async def one(i):
            async with sem:
                t = time.perf_counter()
                status, _, body = await http_call(port, "POST", "/classify",
                                                  bodies[i])
                seconds[i] = time.perf_counter() - t
                if status != 201:
                    raise AssertionError(f"phase 42a: /classify answered "
                                         f"{status} {body[:200]!r}")
                data = json.loads(body)["data"]
                return data["label"], data["score"]

        t = time.perf_counter()
        got = await asyncio.gather(*[one(i) for i in range(len(images))])
        return got, seconds, time.perf_counter() - t

    async def main():
        t = time.monotonic()
        await app.start()
        out["start_s"] = time.monotonic() - t
        try:
            port = app.bound_http_port
            out["routes"] = await check_answers(port, EX_HTTP_SERVER,
                                                "http_server")
            compiles = executor.ledger.total()
            turns = []
            for kind in EXAMPLE_TURNS:
                got, seconds, wall = await (direct_turn_() if kind == "direct"
                                            else http_turn_(port))
                turns.append(dict(kind=kind, got=got, wall_s=wall,
                                  requests_per_s=len(got) / wall,
                                  p50_s=percentile(seconds, 0.5),
                                  p99_s=percentile(seconds, 0.99)))
            out["turns"] = turns
            out["burst_captures"] = executor.ledger.total() - compiles
        finally:
            await app.stop()

    asyncio.run(main())
    out["captures_s"] = ledger_captures(executor)
    # the handler's host work on one body, off the loop: the JSON parse
    # and the float32 array (the loop runs both for every request)
    parse = []
    for body in bodies[:8]:
        t = time.perf_counter()
        np.asarray(json.loads(body)["image"], np.float32)
        parse.append(time.perf_counter() - t)
    ref = eager_forward(torch, lambda x: resnet.apply(params, cfg, x),
                        images, kit.device)
    figures = []
    for turn in out["turns"]:
        labels = [g[0] for g in turn["got"]]
        scores = [g[1] for g in turn["got"]]
        figures.append(check_labels(labels, scores, ref,
                                    f"http_server {turn['kind']} turn"))
        del turn["got"]
    if out["burst_captures"] or sorted(out["captures_s"]) \
            != list(http_server.BUCKETS):
        raise AssertionError(f"phase 42a: captures {out['captures_s']}, "
                             f"{out['burst_captures']} in the turns")
    row = dict(build_s=build_s, start_s=out["start_s"],
               captures_s=out["captures_s"],
               capture_s=sum(out["captures_s"].values()),
               routes_checked=out["routes"], turns=out["turns"],
               labels=figures, in_flight=kit.classify_inflight,
               requests=kit.n_classify,
               body_bytes=sum(map(len, bodies)) / len(bodies),
               body_parse_s=percentile(parse, 0.5),
               phase34_replay=kit.out.get("phase34_resnet_buckets"))
    kit.out["http_server"] = row
    for t in row["turns"]:
        log(f"42a {t['kind']}: {t['requests_per_s']:.1f} requests/s, p50 "
            f"{t['p50_s'] * 1e3:.2f} ms, p99 {t['p99_s'] * 1e3:.2f} ms")
    log(f"42a: built in {build_s:.2f}s, started in {row['start_s']:.2f}s "
        f"(captures {row['capture_s']:.2f}s: {row['captures_s']}); "
        f"{out['routes']} routes as JAX's; labels {figures[1]}; a "
        f"{row['body_bytes'] / 1e6:.2f} MB body's parse "
        f"{row['body_parse_s'] * 1e3:.1f} ms (median of 8)")
    del app, executor, params
    return row


def ex_grpc_server(kit):
    """42b: ``grpc_server`` at its defaults (BERT-base, 64 tokens, buckets
    1/4/16/32): ``Embeddings/embed`` over gRPC at ``embed_inflight``,
    each held to the eager forward."""
    import grpc
    import numpy as np

    from gofr_tpu_torch.examples import grpc_server
    from gofr_tpu_torch.models import bert

    torch = kit.torch
    with kit.env():
        t0 = time.monotonic()
        app = grpc_server.build_app(device=kit.device)
        build_s = time.monotonic() - t0
        cfg = bert.config(kit.bert_preset or "base",
                          max_len=grpc_server.MAX_LEN)
    if not app._grpc_services:
        raise AssertionError("phase 42b: the example registered no gRPC "
                             "route")
    executor = app.container.tpu
    params = executor._models["bert"].params
    log(f"== phase 42b: grpc_server (BERT {cfg.n_layers} layers, dim "
        f"{cfg.dim}, {grpc_server.MAX_LEN} tokens): {kit.n_embed} calls at "
        f"{kit.embed_inflight} in flight")
    rng = np.random.default_rng(kit.seed + 43)
    tokens = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
              for n in rng.integers(5, grpc_server.MAX_LEN + 1, kit.n_embed)]
    out = {}

    async def main():
        t = time.monotonic()
        await app.start()
        out["start_s"] = time.monotonic() - t
        try:
            sem = asyncio.Semaphore(kit.embed_inflight)
            seconds = [0.0] * len(tokens)
            target = f"127.0.0.1:{app.bound_grpc_port}"
            async with grpc.aio.insecure_channel(target) as channel:
                method = channel.unary_unary("/gofr.Embeddings/embed")

                async def one(i):
                    async with sem:
                        t = time.perf_counter()
                        raw = await method(json.dumps(
                            {"token_ids": tokens[i]}).encode())
                        seconds[i] = time.perf_counter() - t
                        return json.loads(raw)["data"]["embedding"]

                t = time.perf_counter()
                out["got"] = await asyncio.gather(*[
                    one(i) for i in range(len(tokens))])
                out["wall_s"] = time.perf_counter() - t
            out["seconds"] = seconds
        finally:
            await app.stop()

    asyncio.run(main())
    captures = ledger_captures(executor)
    inputs = []
    for toks in tokens:
        ids = np.zeros((grpc_server.MAX_LEN,), np.int32)
        mask = np.zeros((grpc_server.MAX_LEN,), np.int32)
        ids[:len(toks)], mask[:len(toks)] = toks, 1
        inputs.append((ids, mask))
    ref = eager_forward(torch, lambda i, m: bert.apply(params, cfg, i,
                                                       m)["mean"],
                        inputs, kit.device)
    got = np.asarray(out["got"], np.float32)
    err = float(np.abs(got - ref).max(axis=-1).max()
                / np.abs(ref).max())
    cos = float(((got * ref).sum(-1) / np.linalg.norm(got, axis=-1)
                 / np.linalg.norm(ref, axis=-1)).min())
    if got.shape != ref.shape or not np.isfinite(got).all() \
            or err > EXAMPLE_REL_TOL or cos < BERT_COS_MIN:
        raise AssertionError(f"phase 42b: embeddings {got.shape} against "
                             f"the eager forward: max rel err {err} (limit "
                             f"{EXAMPLE_REL_TOL}), min cosine {cos} (limit "
                             f"{BERT_COS_MIN})")
    row = dict(build_s=build_s, start_s=out["start_s"], captures_s=captures,
               capture_s=sum(captures.values()), calls=len(tokens),
               in_flight=kit.embed_inflight, wall_s=out["wall_s"],
               calls_per_s=len(tokens) / out["wall_s"],
               p50_s=percentile(out["seconds"], 0.5),
               p99_s=percentile(out["seconds"], 0.99), max_rel_err=err,
               min_cosine=cos)
    kit.out["grpc_server"] = row
    log(f"42b: built in {build_s:.2f}s, started in {row['start_s']:.2f}s "
        f"(captures {row['capture_s']:.2f}s); {len(tokens)} embeds in "
        f"{row['wall_s']:.3f}s, p50 {row['p50_s'] * 1e3:.2f} ms, p99 "
        f"{row['p99_s'] * 1e3:.2f} ms; max rel err {err:.3e}, min cosine "
        f"{cos:.6f}")
    del app, executor, params
    return row


def ex_subscriber(kit):
    """42c: ``using_subscriber`` at its defaults (ResNet-50, buckets
    8/32/64) over Kafka: another client publishes images to ``images``,
    the labels come back on ``labels``, the group's offset is
    committed."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.pubsub.kafka import KafkaClient
    from gofr_tpu_torch.examples import using_subscriber
    from gofr_tpu_torch.logging import new_silent_logger
    from gofr_tpu_torch.models import resnet
    from scripts.wire_brokers import KafkaLog

    torch = kit.torch
    kafka = KafkaLog()
    broker = f"127.0.0.1:{kafka.port}"
    group = "image-classifier"
    out = {}
    try:
        with kit.env(PUBSUB_BACKEND="KAFKA", KAFKA_BROKER=broker,
                     CONSUMER_ID=group):
            t0 = time.monotonic()
            app = using_subscriber.build_app(device=kit.device)
            build_s = time.monotonic() - t0
            cfg = resnet.config(kit.resnet_preset or "50")
        executor = app.container.tpu
        params = executor._models["resnet50"].params
        log(f"== phase 42c: using_subscriber (ResNet at {cfg.image_size}^2, "
            f"buckets {using_subscriber.BUCKETS}) over Kafka at {broker}: "
            f"{kit.n_images} images")
        images, _ = example_images(kit.seed + 44, kit.n_images,
                                   cfg.image_size)
        messages = [json.dumps({"id": f"img-{i}", "image": image.tolist()})
                    .encode() for i, image in enumerate(images)]

        async def main():
            t = time.monotonic()
            await app.start()
            out["start_s"] = time.monotonic() - t
            producer = KafkaClient(MapConfig(dict(
                KAFKA_BROKER=broker, CONSUMER_ID="labels-reader",
                APP_NAME="image-producer")), new_silent_logger(),
                app.container.metrics)
            try:
                t = time.monotonic()
                for message in messages:
                    producer.publish("images", message)
                out["labels"] = await read_topic(producer, "labels",
                                                 len(messages))
                out["wall_s"] = time.monotonic() - t
                deadline = time.monotonic() + 30
                while kafka.offsets.get((group, "images", 0)) \
                        != len(messages):
                    if time.monotonic() > deadline:
                        break
                    await asyncio.sleep(0.01)
                out["committed"] = kafka.offsets.get((group, "images", 0))
            finally:
                producer.close()
                await app.stop()

        asyncio.run(main())
    finally:
        kafka.stop()
    by_id = {r["id"]: r["label"] for r in out["labels"]}
    labels = [by_id.get(f"img-{i}", -1) for i in range(len(images))]
    ref = eager_forward(torch, lambda x: resnet.apply(params, cfg, x),
                        images, kit.device)
    figures = check_labels(labels, [None] * len(labels), ref,
                           "using_subscriber")
    if len(by_id) != len(images) or out["committed"] != len(images):
        raise AssertionError(f"phase 42c: {len(by_id)} labels for "
                             f"{len(images)} images; committed offset "
                             f"{out['committed']}")
    captures = ledger_captures(executor)
    row = dict(build_s=build_s, start_s=out["start_s"], captures_s=captures,
               capture_s=sum(captures.values()), images=len(images),
               wall_s=out["wall_s"], images_per_s=len(images) / out["wall_s"],
               committed=out["committed"], labels=figures)
    kit.out["using_subscriber"] = row
    log(f"42c: built in {build_s:.2f}s, started in {row['start_s']:.2f}s "
        f"(captures {row['capture_s']:.2f}s); {len(images)} labels back in "
        f"{row['wall_s']:.3f}s; committed offset {out['committed']}; "
        f"labels {figures}")
    del app, executor, params
    return row


CMD_RUNS = {"classify": ["classify"], "hello": ["hello", "-name=H100"],
            "nosuch": ["nosuch"]}


def start_cmd_runs(kit):
    """The ``cmd`` example's runs, each a process of its own started now
    (read by :func:`ex_cmd`); on the CPU ``classify`` runs in process
    instead (the example's module-level app is on the card)."""
    env = {k: v for k, v in os.environ.items() if k not in EXAMPLE_UNSET}
    env["CMD_LOGS_FILE"] = os.path.join(kit.tmp, "cmd.log")
    for name, argv in CMD_RUNS.items():
        if name == "classify" and not kit.cuda:
            continue
        kit.cmd_procs[name] = (time.monotonic(), subprocess.Popen(
            [sys.executable, "-m", "gofr_tpu_torch.examples.cmd", *argv],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


def ex_cmd(kit):
    """42d: the ``cmd`` example in processes of its own: ``classify`` on
    the card exits 0 with the tiny ResNet's label of its seeded image (the
    eager forward's where its margin exceeds the tolerance), ``hello
    -name=H100`` greets, ``nosuch`` exits 2; the logs go to
    ``CMD_LOGS_FILE``."""
    import io

    import numpy as np

    from gofr_tpu_torch.models import resnet

    log("== phase 42d: the cmd example: classify, hello, nosuch")
    if not kit.cmd_procs:
        start_cmd_runs(kit)
    runs = {}
    for name, (t0, proc) in kit.cmd_procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        runs[name] = dict(rc=proc.returncode, stdout=stdout, stderr=stderr,
                          seconds=time.monotonic() - t0)
    kit.cmd_procs.clear()
    if "classify" not in runs:
        from gofr_tpu_torch.cli import run_cli
        from gofr_tpu_torch.examples import cmd
        stdout = io.StringIO()
        t0 = time.monotonic()
        rc = run_cli(cmd.build_app(device=kit.device), ["classify"],
                     stdout=stdout, stderr=io.StringIO())
        runs["classify"] = dict(rc=rc, stdout=stdout.getvalue(), stderr="",
                                seconds=time.monotonic() - t0)
    cfg = resnet.config("tiny")
    image = np.random.default_rng(0).standard_normal(
        (cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    params = resnet.init(cfg, 0, device=kit.device)
    ref = eager_forward(kit.torch, lambda x: resnet.apply(params, cfg, x),
                        [image], kit.device)
    c, h, n = runs["classify"], runs["hello"], runs["nosuch"]
    try:
        label = json.loads(c["stdout"])["label"]
    except (ValueError, KeyError, TypeError):
        label = None
    if c["rc"] != 0 or label is None:
        raise AssertionError(f"phase 42d: classify exited {c['rc']}, "
                             f"stdout {c['stdout'][-500:]!r}, stderr "
                             f"{c['stderr'][-2000:]!r}")
    figures = check_labels([label], [None], ref, "cmd classify")
    if (h["rc"], h["stdout"]) != (0, "Hello H100!\n"):
        raise AssertionError(f"phase 42d: hello exited {h['rc']} with "
                             f"{h['stdout']!r} {h['stderr'][-500:]!r}")
    if n["rc"] != 2 or "unknown command: 'nosuch'" not in n["stderr"] \
            or n["stdout"]:
        raise AssertionError(f"phase 42d: nosuch exited {n['rc']} with "
                             f"{n['stdout']!r} {n['stderr'][-500:]!r}")
    logged = ""
    if kit.cuda:
        with open(os.path.join(kit.tmp, "cmd.log")) as handle:
            logged = handle.read()
        if "tpu: model resnet registered" not in logged:
            raise AssertionError(f"phase 42d: CMD_LOGS_FILE holds "
                                 f"{logged[-500:]!r}")
    row = dict(classify=dict(rc=c["rc"], label=label, labels=figures,
                             seconds=c["seconds"]),
               hello=dict(rc=h["rc"], seconds=h["seconds"]),
               nosuch=dict(rc=n["rc"], seconds=n["seconds"]),
               log_lines=logged.splitlines())
    kit.out["cmd"] = row
    log(f"42d: classify exited 0 with label {label} ({c['seconds']:.1f}s "
        f"from its start), hello {h['stdout'].strip()!r}, nosuch exited "
        f"{n['rc']}; CMD_LOGS_FILE: {row['log_lines']}")
    return row


async def ws_open(port, key):
    """A websocket client over asyncio streams: the upgrade, its 101 and
    accept key checked. (reader, writer, bytes past the handshake)."""
    from gofr_tpu_torch.websocket.frames import accept_key

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((
        "GET /chat HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
    if b" 101 " not in head.split(b"\r\n")[0] \
            or accept_key(key).encode() not in head:
        raise AssertionError(f"phase 42e: handshake answered {head!r}")
    return [reader, writer, b""]


async def ws_next(client):
    """The next frame a client gets: (opcode, payload); None at EOF."""
    from gofr_tpu_torch.websocket.frames import decode_frame

    while True:
        frame = decode_frame(client[2])
        if frame is not None:
            client[2] = client[2][frame[3]:]
            return frame[0], frame[2]
        chunk = await asyncio.wait_for(client[0].read(65536), 10)
        if not chunk:
            return None
        client[2] += chunk


def ex_websocket(kit):
    """42e: ``websocket_chat``: two clients (masked frames) each get the
    welcome, a message from one reaches both, ping gets pong, the round
    trip's p50 over ``ws_round_trips`` broadcasts, the close handshake
    answers 1000 and an unmasked frame closes with 1002."""
    import base64

    from gofr_tpu_torch.examples import websocket_chat
    from gofr_tpu_torch.websocket import frames, hub

    log("== phase 42e: websocket_chat: two clients")
    with kit.env():
        app = websocket_chat.build_app(device=kit.device)
    out = {}

    def text(message):
        return frames.encode_frame(frames.OP_TEXT, message.encode(),
                                   mask=True)

    async def main():
        await app.start()
        try:
            port = app.bound_http_port
            c1 = await ws_open(port, base64.b64encode(b"1" * 16).decode())
            c2 = await ws_open(port, base64.b64encode(b"2" * 16).decode())
            welcome = {"system": "welcome"}
            got = [await ws_next(c) for c in (c1, c2)]
            if any(g is None or json.loads(g[1]) != welcome for g in got):
                raise AssertionError(f"phase 42e: welcome {got}")
            c1[1].write(text("hello from 1"))
            got = [await ws_next(c) for c in (c1, c2)]
            if any(g is None or json.loads(g[1])
                   != {"message": "hello from 1"} for g in got):
                raise AssertionError(f"phase 42e: broadcast {got}")
            c1[1].write(frames.encode_frame(frames.OP_PING, b"p", mask=True))
            pong = await ws_next(c1)
            if pong != (frames.OP_PONG, b"p"):
                raise AssertionError(f"phase 42e: ping answered {pong}")
            seconds = []
            for i in range(kit.ws_round_trips):
                t = time.perf_counter()
                c1[1].write(text(f"m{i}"))
                got = await ws_next(c1)
                seconds.append(time.perf_counter() - t)
                if got is None or json.loads(got[1]) != {"message": f"m{i}"}:
                    raise AssertionError(f"phase 42e: round trip {i}: {got}")
            for i in range(kit.ws_round_trips):
                got = await ws_next(c2)
                if got is None or json.loads(got[1]) != {"message": f"m{i}"}:
                    raise AssertionError(f"phase 42e: c2's {i}: {got}")
            out["seconds"] = seconds
            c2[1].write(frames.encode_frame(frames.OP_CLOSE, b"\x03\xe8",
                                            mask=True))
            close = await ws_next(c2)
            eof = await ws_next(c2)
            out["close"] = (close[0], int.from_bytes(close[1][:2], "big"),
                            eof)
            c1[1].write(frames.encode_frame(frames.OP_TEXT, b"bare",
                                            mask=False))
            fail = await ws_next(c1)
            out["unmasked"] = (fail[0], int.from_bytes(fail[1][:2], "big"),
                               await ws_next(c1))
            for c in (c1, c2):
                c[1].close()
            deadline = time.monotonic() + 10
            while hub().all() and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            out["hub_left"] = len(hub().all())
        finally:
            await app.stop()

    asyncio.run(main())
    if out["close"] != (frames.OP_CLOSE, 1000, None):
        raise AssertionError(f"phase 42e: close handshake {out['close']}")
    if out["unmasked"] != (frames.OP_CLOSE, frames.CLOSE_PROTOCOL_ERROR,
                           None):
        raise AssertionError(f"phase 42e: an unmasked frame gave "
                             f"{out['unmasked']}")
    if out["hub_left"]:
        raise AssertionError(f"phase 42e: {out['hub_left']} connections "
                             f"left in the hub")
    row = dict(round_trips=len(out["seconds"]),
               p50_s=percentile(out["seconds"], 0.5),
               p99_s=percentile(out["seconds"], 0.99),
               close_code=out["close"][1], unmasked_code=out["unmasked"][1])
    kit.out["websocket_chat"] = row
    log(f"42e: welcome and broadcast to both, pong, round trip p50 "
        f"{row['p50_s'] * 1e3:.3f} ms p99 {row['p99_s'] * 1e3:.3f} ms over "
        f"{row['round_trips']}; close 1000, unmasked 1002; hub empty")
    return row


def serve(app, body):
    """Start ``app``, await ``body(port)``, stop; its result."""
    async def main():
        await app.start()
        try:
            return await body(app.bound_http_port)
        finally:
            await app.stop()
    return asyncio.run(main())


def ex_framework(kit):
    """42f: the framework examples at their defaults, one app at a time:
    CRUD and migrations on sqlite files, a zip upload and a declared bomb,
    Redis over RESP2, the publisher over Kafka, the outbound service up
    and degraded, the custom metrics' series, both cron jobs, and the
    OpenAPI routes from a working directory holding a spec."""
    import io
    import zipfile

    from gofr_tpu_torch import new_app
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.datasource.pubsub.base import decode_trace_envelope
    from gofr_tpu_torch.examples import (http_server_using_redis,
                                         using_add_rest_handlers, using_cron,
                                         using_custom_metrics,
                                         using_file_bind, using_http_service,
                                         using_migrations, using_publisher)
    from scripts.wire_brokers import KafkaLog, RESPServer

    log("== phase 42f: the framework examples")
    row = {}
    t = time.monotonic()
    db = os.path.join(kit.tmp, "users.db")
    with kit.env(DB_DIALECT="sqlite", DB_NAME=db):
        app = using_add_rest_handlers.build_app(device=kit.device)
    row["crud"] = serve(app, lambda port: check_answers(
        port, EX_CRUD, "using_add_rest_handlers"))

    with kit.env(DB_DIALECT="sqlite",
                 DB_NAME=os.path.join(kit.tmp, "employees.db"),
                 REDIS_HOST="memory"):
        app = using_migrations.build_app(device=kit.device)
    seeded = app.container.redis.get("employee:seeded")
    row["migrations"] = serve(app, lambda port: check_answers(
        port, EX_MIGRATIONS, "using_migrations"))
    if seeded != "true":
        raise AssertionError(f"phase 42f: migration 2 left {seeded!r}")

    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as archive:
        for name, content in EX_ZIP_MEMBERS:
            archive.writestr(name, content)
    bodies = [upload_body("data.zip", buffer.getvalue()),
              upload_body("bomb.zip", declared_bomb_zip())]
    with kit.env():
        app = using_file_bind.build_app(device=kit.device)

    async def uploads(port):
        return [await http_call(port, "POST", "/upload", body, {
            "Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
            for body in bodies]
    (s1, _, b1), (s2, _, b2) = serve(app, uploads)
    members = json.loads(b1)["data"] if s1 == 201 else None
    if s1 != 201 or members["zip_members"] != [n for n, _ in EX_ZIP_MEMBERS] \
            or (s2, json.loads(b2)) != EX_BOMB:
        raise AssertionError(f"phase 42f: uploads {s1} {b1[:300]!r}, bomb "
                             f"{s2} {b2[:300]!r}")
    row["file_bind"] = dict(members=members["zip_members"], bomb=s2)

    resp = RESPServer()
    try:
        with kit.env(REDIS_HOST="127.0.0.1", REDIS_PORT=str(resp.port)):
            app = http_server_using_redis.build_app(device=kit.device)
        row["redis"] = serve(app, lambda port: check_answers(
            port, EX_REDIS, "http_server_using_redis"))
        ttl = app.container.redis.ttl("greeting")
    finally:
        resp.stop()
    if not 0 < ttl <= 300:
        raise AssertionError(f"phase 42f: Redis TTL {ttl}")

    kafka = KafkaLog()
    try:
        with kit.env(PUBSUB_BACKEND="KAFKA",
                     KAFKA_BROKER=f"127.0.0.1:{kafka.port}"):
            app = using_publisher.build_app(device=kit.device)
        row["publisher"] = serve(app, lambda port: check_answers(
            port, EX_PUBLISHER, "using_publisher"))
        logged = {topic: [json.loads(decode_trace_envelope(m)[1])
                          for m in kafka.messages(topic)]
                  for topic in ("order-logs", "products")}
    finally:
        kafka.stop()
    if logged != {"order-logs": [EX_PUBLISHER[0][2]],
                  "products": [EX_PUBLISHER[1][2]]}:
        raise AssertionError(f"phase 42f: the Kafka log holds {logged}")

    upstream = App(config=MapConfig({}),
                   container=new_mock_container(device="cpu"))
    upstream.http_port = upstream.metrics_port = 0
    upstream.get("/fact", lambda ctx: EX_FACT)
    upstream.get("/breeds", lambda ctx: {"ok": True})

    async def service_turns():
        await upstream.start()
        with kit.env(FACTS_URL=f"http://127.0.0.1:"
                               f"{upstream.bound_http_port}"):
            app = using_http_service.build_app(device=kit.device)
        await app.start()
        try:
            port = app.bound_http_port
            turns = []
            for up in (True, False):
                if not up:
                    await upstream.stop()
                status, _, body = await http_call(port, "GET", "/fact")
                _, _, health = await http_call(port, "GET",
                                               "/.well-known/health")
                health = json.loads(health)
                turns.append((status, json.loads(body),
                              {k: v["status"] for k, v in
                               health["services"].items()},
                              health["status"]))
            return turns
        finally:
            await app.stop()

    up, down = asyncio.run(service_turns())
    if up != (200, {"data": EX_FACT}, {"cat-facts": "UP",
                                       "fact-checker": "DOWN"}, "DEGRADED") \
            or down[0] < 500 or down[2]["cat-facts"] != "DOWN" \
            or down[3] != "DEGRADED":
        raise AssertionError(f"phase 42f: the outbound service up {up}, "
                             f"down {down}")
    row["http_service"] = dict(up=up[0], down=down[0])

    with kit.env():
        app = using_custom_metrics.build_app(device=kit.device)

    async def metrics_turn(port):
        await check_answers(port, EX_TRANSACTIONS, "using_custom_metrics")
        _, _, text = await http_call(app.bound_metrics_port, "GET",
                                     "/metrics")
        return text.decode()
    series = {}
    for line in serve(app, metrics_turn).splitlines():
        name, _, value = line.replace("{}", "").partition(" ")
        if name in EX_SERIES:
            series[name] = float(value)
    if series != EX_SERIES:
        raise AssertionError(f"phase 42f: custom series {series}")
    row["custom_metrics"] = series

    with kit.env():
        app = using_cron.build_app(device=kit.device)

    async def fire():
        for job in app.crontab.jobs:
            await app.crontab._run_job(job)
    asyncio.run(fire())
    runs = {job.name: app.container.metrics.value(
        "app_cron_runs_total", job=job.name, result="success")
        for job in app.crontab.jobs}
    if runs != {"heartbeat": 1.0, "tpu-health": 1.0}:
        raise AssertionError(f"phase 42f: cron runs {runs}")
    row["cron"] = runs

    row["openapi"] = openapi_turn(kit, new_app)
    row["seconds"] = time.monotonic() - t
    kit.out["framework"] = row
    log(f"42f: every framework example answered as JAX's in "
        f"{row['seconds']:.2f}s: {row}")
    return row


BOUNDARY = "phase42"


def upload_body(filename, blob):
    return (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"name\""
            f"\r\n\r\nphase42\r\n--{BOUNDARY}\r\nContent-Disposition: "
            f"form-data; name=\"upload\"; filename=\"{filename}\"\r\n"
            f"Content-Type: application/zip\r\n\r\n").encode() + blob + \
        f"\r\n--{BOUNDARY}--\r\n".encode()


def declared_bomb_zip():
    """A stored one-member zip whose headers declare 200 MB."""
    import io
    import struct
    import zipfile

    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w", zipfile.ZIP_STORED) as archive:
        archive.writestr("x", b"y" * 64)
    data = bytearray(buffer.getvalue())
    size = 200 * 1024 * 1024
    struct.pack_into("<II", data, data.index(b"PK\x03\x04") + 18, size, size)
    struct.pack_into("<II", data, data.index(b"PK\x01\x02") + 20, size, size)
    return bytes(data)


def openapi_turn(kit, new_app):
    """An app started in a working directory holding
    ``static/openapi.json``: the spec as written, the swagger page, and
    both assets as the package's bytes."""
    import gofr_tpu_torch

    static = Path(gofr_tpu_torch.__file__).resolve().parent / "static"
    work = Path(kit.tmp) / "openapi"
    (work / "static").mkdir(parents=True, exist_ok=True)
    spec = json.dumps(EX_SPEC).encode()
    (work / "static" / "openapi.json").write_bytes(spec)
    here = os.getcwd()
    os.chdir(work)
    try:
        with kit.env():
            app = new_app(str(work / "configs"), device=kit.device)

        async def fetch(port):
            return [await http_call(port, "GET", f"/.well-known/{path}")
                    for path in ("openapi.json", "swagger",
                                 "swagger/swagger-ui-bundle.js",
                                 "swagger/swagger-ui.css")]
        got = serve(app, fetch)
    finally:
        os.chdir(here)
    want = [spec, None, (static / "swagger-ui-bundle.js").read_bytes(),
            (static / "swagger-ui.css").read_bytes()]
    if [s for s, _, _ in got] != [200] * 4 or got[0][2] != want[0] \
            or b"SwaggerUIBundle" not in got[1][2] \
            or got[2][2] != want[2] or got[3][2] != want[3]:
        raise AssertionError(f"phase 42f: OpenAPI answered "
                             f"{[(s, len(b)) for s, _, b in got]}")
    return dict(asset_bytes=[len(b) for _, _, b in got[2:]])


EXAMPLE_STEPS = (("http_server", ex_http_server),
                 ("grpc_server", ex_grpc_server),
                 ("using_subscriber", ex_subscriber),
                 ("cmd", ex_cmd),
                 ("websocket_chat", ex_websocket),
                 ("framework", ex_framework))


def example_kit(torch, seed, tmp, device="cuda", tiny=False):
    """Phase 42's kit: the examples' defaults on the card, or (``tiny``)
    a CPU rehearsal's tiny presets and small request sets."""
    if not tiny:
        return ExampleKit(torch, device, seed, tmp)
    return ExampleKit(torch, device, seed, tmp, resnet_preset="tiny",
                      bert_preset="tiny", n_classify=8, classify_inflight=4,
                      n_embed=4, embed_inflight=2, n_images=4,
                      ws_round_trips=5)


def phase_examples(torch, seed, results, device="cuda", tiny=False,
                   mods=None):
    """Phase 42: the examples at their own defaults on the card, one after
    the other, each app (and its websockets) closed before the next; the
    ``cmd`` runs start first, in processes of their own. ``mods`` (the
    kernel modules) records the launches of the three kernels, which no
    example path takes."""
    import tempfile

    t_phase = time.monotonic()
    log(f"== phase 42: the examples on the {device} at their own defaults"
        + (" (tiny presets)" if tiny else ""))
    with tempfile.TemporaryDirectory(prefix="phase42-") as tmp:
        kit = example_kit(torch, seed, tmp, device, tiny)
        resnet_row = results.get("exec_resnet50", {})
        kit.out["phase34_resnet_buckets"] = resnet_row.get("buckets")
        if mods is not None:
            for mod in mods:
                mod.reset_launches()
        start_cmd_runs(kit)
        try:
            for _, step in EXAMPLE_STEPS:
                step(kit)
                gc.collect()
                if kit.cuda:
                    torch.cuda.empty_cache()
        finally:
            for _, proc in kit.cmd_procs.values():
                proc.kill()
                proc.wait()
        if mods is not None:
            kit.out["launches"] = read_launches(mods)
    kit.out["phase_s"] = time.monotonic() - t_phase
    results["examples"] = kit.out
    http = kit.out["http_server"]
    turns = {t["kind"]: t for t in http["turns"]}
    log(f"phase 42: every example passed in {kit.out['phase_s']:.1f}s; "
        f"/classify over HTTP {turns['http']['requests_per_s']:.1f}/s "
        f"against direct {turns['direct']['requests_per_s']:.1f}/s (last "
        f"turn of each); gRPC embed p50 "
        f"{kit.out['grpc_server']['p50_s'] * 1e3:.2f} ms; websocket round "
        f"trip p50 {kit.out['websocket_chat']['p50_s'] * 1e3:.3f} ms; "
        f"launches {kit.out.get('launches')}")
    if kit.out["phase_s"] > PHASE42_LIMIT_S and not tiny:
        raise AssertionError(f"phase 42 took {kit.out['phase_s']:.1f}s, "
                             f"over its {PHASE42_LIMIT_S}s")
    return kit.out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=8,
                        help="depth of the llama3-8b engines (of 32; width "
                             "is always full)")
    parser.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.datasource import pubsub
    from gofr_tpu_torch.models import bert, llama, moe, resnet
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch import slo
    from gofr_tpu_torch.parallel import train
    from gofr_tpu_torch.utils import checkpoint
    from gofr_tpu_torch.tpu import (autotune, batch_lane, batcher, cluster,
                                    constrain, executor, faults, fleet,
                                    generate, kv_wire, page_pool, registry,
                                    sched)

    results = {}
    log("== phase 1: card")
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    results["card"] = card

    log("== phase 2: build")
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    log(f"built {list(_build.KERNELS)} in {build_s:.1f}s")
    results["build_s"] = build_s
    # clusters of 8 blocks each ragged instantiation keeps resident at
    # the engine's table (llama3-8b: 64 columns of 32 positions; small:
    # 32), verify at G 5
    occupancy = {
        f"D {geom.head_dim} group {group} {'verify' if verify else 'decode'} "
        f"{'int8' if int8 else 'bf16'}":
            ragged_mod.cluster_occupancy(group, verify, int8,
                                         SPEC_GAMMA + 1 if verify else 1,
                                         table_width=geom.width,
                                         head_dim=geom.head_dim)
        for geom in (LLAMA3, SMALL)
        for group in ragged_mod.SUPPORTED_GROUPS
        for verify in (False, True) for int8 in (False, True)}
    log(f"ragged kernel clusters resident: {occupancy}")
    results["ragged_cluster_occupancy"] = occupancy
    results["ragged_d64_waves"] = d64_waves(ragged_mod)

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)
    flash_err = phase_flash(torch, flash_mod, timer, results)
    ragged = {int8: phase_ragged(torch, ragged_mod, timer, results, int8)
              for int8 in (False, True)}
    verify = {int8: phase_verify(torch, ragged_mod, timer, results, int8)
              for int8 in (False, True)}
    flash_decode = phase_flash_decode(torch, decode_mod, timer, results)
    del timer
    torch.cuda.empty_cache()
    phase_model(torch, llama, args.seed, results)
    mods = (flash_mod, ragged_mod, decode_mod)
    phase_perfect_draft(torch, llama, generate, mods, args.seed, results)

    # this slice: the example's default preset (head_dim 64) and prefix
    # reuse; launches by path, each run counted from 0
    timer = Timer(torch)
    d64 = phase_d64_kernels(torch, mods, timer, results)
    del timer
    small_params, by_path_d64 = phase_small_engines(
        torch, llama, generate, mods, args.seed, results)
    small_cfg = llama.config("small", use_flash=True)
    # every small phase but the app's (37, 38) at CUT_SMALL_LAYERS
    cut_cfg = dataclasses.replace(small_cfg, n_layers=CUT_SMALL_LAYERS)
    cut_params = small_params
    log(f"NOTE: phases 20-24 (small), 26-31, 32d, 33e and 35 run small "
        f"cut to {CUT_SMALL_LAYERS} of {small_cfg.n_layers} layers (width "
        f"unchanged); 37 and 38 run the example at its whole depth")
    for path, c, kw in (
            ("prefix_small", cut_cfg, {}),
            ("prefix_small_paged", cut_cfg, dict(paged_kv=True,
                                                 kv_page=32)),
            ("prefix_small_int8", dataclasses.replace(cut_cfg,
                                                      kv_int8=True), {})):
        by_path_d64[path] = phase_prefix(torch, llama, generate, mods, c,
                                         cut_params, dict(SMALL_ENGINE,
                                                            **kw),
                                         path, args.seed, results)
    # this slice: the kv_int8 draft
    by_path_d64.update(phase_int8_draft(torch, llama, generate, mods,
                                        cut_params, args.seed, results))
    # this slice: every engine argument the example app passes
    by_path_d64.update(phase_engine_args(torch, llama, moe, generate,
                                         page_pool, mods, small_params,
                                         args.seed, results))
    # this slice: operating points and the telemetry plane
    by_path_d64.update(phase_op_planes(torch, llama, generate, mods,
                                       cut_params, args.seed, results))
    # this slice: the model registry over a shared pool (phase 32d)
    by_path_d64.update(phase_registry(torch, generate, page_pool, registry,
                                      mods, cut_cfg, cut_params,
                                      args.seed, results))
    # this slice: the operating-point auto-tuner (phase 33e)
    by_path_d64.update(phase_autotune(torch, generate, autotune, faults,
                                      mods, cut_cfg, cut_params,
                                      args.seed, results))
    # this slice: the executor path (phase 34), then the batch lane beside
    # interactive traffic and the pool wedge on phase 20's weights (35)
    phase_executor(torch, executor, batcher, resnet, bert, args.seed,
                   results)
    by_path_d64.update(phase_batch_lane(torch, generate, batch_lane, pubsub,
                                        slo, sched, mods, cut_cfg,
                                        cut_params, args.seed, results))
    by_path_d64.update(phase_wedge(torch, llama, generate, mods, cut_cfg,
                                   cut_params, args.seed, results))
    # this slice: small over a mesh (39c) and its pp forward (39f)
    by_path_d64.update(phase_mesh_small(torch, llama, generate, mods,
                                        cut_cfg, cut_params, args.seed,
                                        results))
    phase_mesh_pp(torch, llama, cut_params, cut_cfg, results)
    del small_params, cut_params
    torch.cuda.empty_cache()
    # this slice: training on one card (phase 36)
    by_path_d64.update(phase_train(torch, llama, moe, train, checkpoint,
                                   mods, args.seed, results))
    # this slice: the example's own model (``small`` over its byte-level
    # vocabulary) serving constrained requests, then admission
    example_cfg = llama.config("small", vocab_size=EXAMPLE_VOCAB,
                               use_flash=True, n_layers=CUT_SMALL_LAYERS)
    example_params = llama.init(example_cfg, args.seed + 3, device="cuda")
    by_path_d64.update(phase_constrained(
        torch, generate, constrain, mods, example_cfg, example_params,
        SMALL_ENGINE, "constrained_small", args.seed, results,
        n_constrained=4, paged_check=True))
    by_path_d64.update(phase_admission(
        torch, llama, generate, slo, sched, constrain, mods, example_cfg,
        example_params, args.seed, results))
    del example_params
    torch.cuda.empty_cache()
    # this slice: the engine's telemetry and the SLO control loop
    by_path_d64.update(phase_telemetry(torch, llama, generate, slo, faults,
                                       mods, args.seed, results))
    # this slice: the app framework serving the example (phase 37)
    by_path_d64.update(phase_app(torch, generate, mods, args.seed, results))
    # this slice: the debug pages and a remote prefill replica (phase 38)
    by_path_d64.update(phase_disagg_app(generate, cluster, kv_wire, mods,
                                        args.seed, results))
    # this slice: the datasources and the lane over Kafka and MQTT (41)
    by_path_d64.update(phase_lane_wire(torch, generate, mods, args.seed,
                                       results))
    # this slice: the examples at their own defaults (phase 42); no
    # example path takes a hand-written kernel
    phase_examples(torch, args.seed, results, mods=mods)
    torch.cuda.empty_cache()

    cfg = llama.config("llama3-8b", n_layers=args.layers, use_flash=True)
    if args.layers != 32:
        log(f"NOTE: llama3-8b depth cut to {args.layers} of 32 layers "
            f"(width unchanged)")
    t0 = time.monotonic()
    params = llama.init(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"random weights ({sum(_numel(params)) / 1e9:.2f} B params) in "
        f"{time.monotonic() - t0:.1f}s")
    # one set of weights serves the eight engines: paged (phases 9-12),
    # then dense (15-18), each bf16 then kv_int8, then prefix reuse on the
    # dense engine (phase 24)
    by_path = {}
    for paged in (True, False):
        if not paged:
            timer = Timer(torch)
            phase_identity_ragged(torch, ragged_mod, timer, results)
            phase_window_flash_decode(torch, decode_mod, timer, results)
            del timer
            torch.cuda.empty_cache()
        for int8 in (False, True):
            c = dataclasses.replace(cfg, kv_int8=int8)
            by_path[engine_kind(c, paged, False)[0]] = phase_engine(
                torch, generate, mods, c, params, args.seed, results, paged)
            by_path[engine_kind(c, paged, True)[0]] = phase_spec_engine(
                torch, llama, generate, mods, c, params, args.seed, results,
                paged)
    by_path.update(phase_telemetry_llama3(torch, generate, mods, cfg, params,
                                          args.seed, results))
    by_path.update(phase_op_llama3(torch, generate, mods, cfg, params,
                                   args.seed, results))
    # phase 26 at llama3-8b width: the 4.1 MB bias slab each tick
    by_path.update(phase_constrained(
        torch, generate, constrain, mods, cfg, params,
        dict(max_slots=8, max_len=2048, prompt_buckets=(32, 128, 512),
             steps_per_tick=4), "constrained_llama3", args.seed, results,
        n_constrained=2, warm_first=False))
    by_path["prefix_llama3"] = phase_prefix(
        torch, llama, generate, mods, cfg, params,
        dict(max_slots=8, max_len=2048, steps_per_tick=4), "prefix_llama3",
        args.seed, results)
    # this slice: disaggregated serving (phase 32 a-c)
    by_path.update(phase_disagg(torch, generate, cluster, kv_wire, faults,
                                mods, cfg, params, args.seed, results))
    # this slice: the fleet control plane (phase 33 a-d)
    by_path.update(phase_fleet(torch, generate, cluster, fleet, faults, mods,
                               cfg, params, args.seed, results))
    # this slice: serving over a device mesh (phase 39)
    by_path.update(phase_mesh_llama3(torch, llama, generate, mods, cfg,
                                     params, args.seed, results))
    phase_mesh_kernels(torch, mods, results)
    phase_mesh_ring(torch, llama, results)
    phase_mesh_executor(torch, executor, resnet, args.seed, results)
    phase_mesh_app(torch, results)
    phase_mesh_dist(torch, results)
    del params
    torch.cuda.empty_cache()
    # this slice: training over a device mesh (phase 40)
    by_path.update(phase_train_mesh(torch, llama, moe, train, checkpoint,
                                    mods, args.seed, results))
    # launches on the main paths: each run counted from 0, llama3-8b's
    # (head_dim 128) and the small preset's (head_dim 64) apart
    counts = {name: sum(run[name] for run in by_path.values())
              for name in by_path["engine"]}
    counts_d64 = {name: sum(run[name] for run in by_path_d64.values())
                  for name in by_path["engine"]}

    flash_main = next(r for r in results["flash"]
                      if r["B"] == 4 and r["S"] == 512)

    def row(name, source, replaces, launches, case, err=None):
        return dict(name=name, route="cuda",
                    source=f"gofr_tpu_torch/csrc/{source}",
                    replaces=f"gofr_tpu/ops/pallas/{replaces}",
                    launches=launches,
                    max_abs_err=case["max_abs_err"] if err is None else err,
                    ms=case["ms"], plain_ms=case["plain_ms"],
                    bound_ms=case["bound_ms"], bound_by=case["bound_by"],
                    library_ms=case["library_ms"])

    flash = ("flash_attention.cu", "flash_attention.py:107")
    ragged_src = ("ragged_paged_attention.cu",
                  "ragged_paged_attention.py:315")
    decode = ("decode_attention.cu", "decode_attention.py:158")

    def verify_main(rows):
        return next(r for r in rows if r["G"] == SPEC_GAMMA + 1)

    kernels = [
        row("flash_attention", *flash, counts["flash"], flash_main,
            flash_err),
        row("ragged_paged_decode_attention", *ragged_src, counts["ragged"],
            ragged[False]),
        row("ragged_paged_verify_attention", *ragged_src, counts["verify"],
            verify_main(verify[False]),
            max(r["max_abs_err"] for r in verify[False])),
        row("flash_decode_attention", *decode, counts["flash_decode"],
            flash_decode),
        row("ragged_paged_decode_attention_int8", *ragged_src,
            counts["int8"], ragged[True]),
        row("ragged_paged_verify_attention_int8", *ragged_src,
            counts["int8_verify"], verify_main(verify[True]),
            max(r["max_abs_err"] for r in verify[True])),
        row("flash_attention_d64", *flash, counts_d64["flash"], d64["flash"]),
        row("ragged_paged_decode_attention_d64", *ragged_src,
            counts_d64["ragged"], d64["ragged_bf16"]),
        row("ragged_paged_verify_attention_d64", *ragged_src,
            counts_d64["verify"], d64["verify_bf16"]),
        row("flash_decode_attention_d64", *decode,
            counts_d64["flash_decode"], d64["flash_decode"]),
        row("ragged_paged_decode_attention_int8_d64", *ragged_src,
            counts_d64["int8"], d64["ragged_int8"]),
        row("ragged_paged_verify_attention_int8_d64", *ragged_src,
            counts_d64["int8_verify"], d64["verify_int8"]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: "
                             f"{idle}")
    results["kernels"] = kernels
    results["launches_by_path"] = dict(by_path, **by_path_d64)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results["total_s"] = time.monotonic() - T0
    log(f"chip_smoke: every phase passed in {results['total_s']:.1f}s")
    out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Llama ``/generate`` served by the port (counterpart of
``examples/llama-generate/main.py``): continuous batching on one card,
the byte-level BPE tokenizer, HTTP, Server-Sent Events and gRPC.

Routes and bodies are the JAX example's:

- ``POST /generate`` ``{"prompt": "...", "max_new_tokens": 32,
  "temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 1,
  "response_format": {...}}`` → ``{"completion", "tokens", "model",
  "engine"}``; ``POST /generate/stream``, the same body, one SSE
  ``data:`` frame a token, then ``[DONE]``; gRPC server stream
  ``/gofr.Llama/generate``, one JSON message a token;
- ``POST /v1/{model}/generate[/stream]`` through a ``ModelRegistry``
  when ``MODELS=name=preset[>fallback],...`` is set;
- the disaggregated plane: ``CLUSTER_ROLE=prefill|decode|both`` tags this
  replica, ``CLUSTER_PEERS=name=role@url[#grpc_host:port],...`` registers
  remote replicas, each behind an ``HTTPTransport`` (its circuit breaker;
  the KV blob over gRPC ``/gofr.Disagg/fetch`` when the entry names a
  gRPC target, over HTTP otherwise); ``/disagg/prefill``,
  ``/disagg/fetch`` (and gRPC ``/gofr.Disagg/fetch``), ``/disagg/adopt``,
  ``/disagg/adopt_session``, ``/disagg/generate`` (the router: prefill on
  a prefill replica, the KV handoff, decode on a decode replica),
  ``/disagg/drain``; ``FLEET_ROUTING=1`` upgrades the router to the fleet
  control plane, ``FLEET_AUTOSCALE=<cron spec>`` adds its autoscaler;
- the debug pages, as JAX's example enables them: ``/debug/`` (the
  index), ``statusz``, ``varz``, ``xlaz``, ``hbmz``, ``timez``,
  ``workloadz``, ``sloz``, ``whyz/{trace_id}``, ``tunez``, ``clusterz``,
  ``tracez/{trace_id}`` and ``POST /debug/profiler/start|stop`` (a
  ``torch.profiler`` capture written as ``<dir>/trace.json``);
- ``BATCH_LANE_TOPIC`` feeds batch jobs (text prompts or token ids,
  decoded text back) into the engine from the broker ``PUBSUB_BACKEND``
  names: ``INMEM``, ``KAFKA``, ``MQTT`` or ``GOOGLE``.

The environment knobs and engine arguments are the JAX example's
(``LLAMA_PRESET`` default ``small``, ``GENERATE_SLOTS``, ``STEPS_PER_TICK``,
``INFLIGHT_TICKS``, ``LLAMA_KV_INT8``, ``GENERATE_PAGED_KV``,
``GENERATE_DRAFT_MODEL``, ...). Where they differ:

- the model prefills through the flash-attention kernel (``use_flash``)
  and decodes through the ragged kernel, as the port's engine does;
- ``MESH`` / ``TPU_MESH`` (JAX's forms: ``tp:2``, ``dp:2,tp:4``, a bare
  ``8``, ``auto``, ``off``) lay the llama engines and the shared page
  pool over ``parallel/mesh.device_mesh``: the visible cards, or on the
  CPU as many CPU devices as the spec needs; a mesh needing more cards
  than there are raises JAX's "needs N devices, have M" at build. A
  card engine's shards share one card (``tpu/generate._MeshPlan``), so
  on the card these knobs serve ``{dp: 1, tp: 1}`` only, and a mesh over
  distinct cards is refused at build. For the same reason JAX's default
  for the 7B-class presets, tp over every device where there are
  several, is not taken: with no knob they serve unsharded;
- where ``grpcio`` is not installed the gRPC routes are not registered,
  and the app logs at start that gRPC is off;
- warm-up runs in ``on_startup``, before the server binds, and takes
  every prompt count (JAX's: 1 and ``GENERATE_SLOTS``), so no graph is
  captured inside a burst; the app's close stops the engine.

``build_app(device="cuda")`` runs on the card and raises without CUDA;
``device="cpu"`` runs the plain path on the CPU. ``params_fn(module, cfg,
seed)`` replaces the weight source (default ``module.init(cfg, seed,
device)``). Run it with ``python -m gofr_tpu_torch.examples.llama_generate``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
from typing import Any, Callable, Optional

from gofr_tpu_torch import App, new_app, resolve_device
from gofr_tpu_torch.grpcx import grpc_available
from gofr_tpu_torch.http.errors import HTTPError
from gofr_tpu_torch.http.response import FileResponse, Stream
from gofr_tpu_torch.tokenizer import Tokenizer


class BadRequest(HTTPError):
    status_code = 400


class Unavailable(HTTPError):
    status_code = 503


class HandoffGone(HTTPError):
    status_code = 410


def mesh_from_config(config, device):
    """The mesh of ``MESH`` / ``TPU_MESH`` for an engine on ``device``
    (JAX's example): off or unset is no mesh."""
    from gofr_tpu_torch.parallel import parse_mesh_spec
    from gofr_tpu_torch.parallel.mesh import device_mesh
    mesh_spec = (os.environ.get("MESH") or config.get("TPU_MESH")
                 or "").strip()
    if mesh_spec.lower() == "off":
        return None
    axes = parse_mesh_spec(mesh_spec)
    return device_mesh(axes, device) if axes is not None else None


def build_app(device="cuda",
              params_fn: Optional[Callable[[Any, Any, int], Any]] = None
              ) -> App:
    from gofr_tpu_torch.models import llama, moe
    from gofr_tpu_torch.tpu import kv_wire
    from gofr_tpu_torch.tpu.cluster import (ClusterRegistry, DisaggRouter,
                                            HandoffExpired, HandoffTable,
                                            HTTPTransport, InProcTransport,
                                            NoReplicaAvailable, parse_peers)
    from gofr_tpu_torch.tpu.constrain import token_byte_table
    from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling
    from gofr_tpu_torch.tpu.page_pool import PagePool
    from gofr_tpu_torch.tpu.registry import ModelRegistry, ModelUnavailable
    from gofr_tpu_torch.tpu.sched import role_class_weights

    dev = resolve_device(device)
    app = new_app(device=dev)
    if params_fn is None:
        def params_fn(module, cfg, seed):
            return module.init(cfg, seed, device=dev)

    kv_int8 = os.environ.get("LLAMA_KV_INT8") == "1"
    paged_kv = os.environ.get("GENERATE_PAGED_KV") == "1"
    kv_page = int(os.environ.get("GENERATE_KV_PAGE", "32"))
    # auto and on: the ragged kernel; off: the gather formulation
    ragged_attn = (os.environ.get("GENERATE_RAGGED_ATTN", "auto")
                   .strip().lower() or "auto")
    cluster_role = os.environ.get("CLUSTER_ROLE", "both").strip() or "both"
    # the remote replicas: a malformed entry raises here, at build
    cluster_peers = parse_peers(os.environ.get("CLUSTER_PEERS"))
    # SLO-class weighted-fair scheduling, seeded from the replica role
    class_weights = role_class_weights(
        cluster_role, os.environ.get("SLO_CLASS_WEIGHTS"))
    # speculative decode: a draft proposes GENERATE_SPEC_GAMMA tokens a
    # tick, the target verifies them in one batched forward
    draft_preset = os.environ.get("GENERATE_DRAFT_MODEL")
    spec_gamma = int(os.environ.get("GENERATE_SPEC_GAMMA", "4"))
    default_preset = os.environ.get("LLAMA_PRESET", "small")
    mesh = mesh_from_config(app.config, dev)

    def model_config(preset):
        """``moe``/``moe-<preset>`` → the MoE variant, anything else a llama
        preset; the byte-level vocabulary either way."""
        if preset == "moe" or preset.startswith("moe-"):
            base = preset[4:] if preset.startswith("moe-") else "tiny"
            return moe, moe.config(base=llama.config(
                base, vocab_size=256, kv_int8=kv_int8, use_flash=True))
        return llama, llama.config(preset, vocab_size=256, kv_int8=kv_int8,
                                   use_flash=True)

    tokenizer = Tokenizer(logger=app.logger)  # byte-level; load() a vocab

    def make_engine(preset, name, seed, with_draft, page_pool=None):
        module, cfg = model_config(preset)
        params = params_fn(module, cfg, seed)
        draft_cfg = draft_params = None
        if with_draft and module is llama and draft_preset:
            draft_cfg = llama.config(draft_preset, vocab_size=256)
            draft_params = params_fn(llama, draft_cfg, seed + 1)
        return GenerationEngine(
            cfg, params, mesh=mesh if module is llama else None,
            max_slots=int(os.environ.get("GENERATE_SLOTS", "8")),
            max_len=min(cfg.max_seq_len, 1024),
            # fused decode steps a tick (one host round trip)
            steps_per_tick=int(os.environ.get("STEPS_PER_TICK", "16")),
            # decode ticks in flight before the oldest fetch must land
            max_inflight_ticks=int(os.environ.get("INFLIGHT_TICKS", "4")),
            prefix_cache=(module is llama
                          and os.environ.get("GENERATE_PREFIX_CACHE") == "1"),
            prefix_cache_bytes=int(os.environ.get(
                "GENERATE_PREFIX_CACHE_BYTES", str(64 << 20))),
            paged_kv=paged_kv and module is llama,
            kv_page=kv_page,
            ragged_attn=(ragged_attn if paged_kv and module is llama
                         else "auto"),
            kv_pool_bytes=(int(os.environ["GENERATE_KV_POOL_BYTES"])
                           if "GENERATE_KV_POOL_BYTES" in os.environ
                           and page_pool is None else None),
            page_pool=page_pool,
            model_module=None if module is llama else module,
            model_name=name,
            draft_cfg=draft_cfg, draft_params=draft_params,
            spec_gamma=spec_gamma,
            class_weights=class_weights,
            coalesce_uploads=(
                os.environ.get("GENERATE_COALESCE_UPLOADS") == "1"),
            coalesce_stream=(
                os.environ.get("GENERATE_COALESCE_STREAM") == "1"),
            # grammar masks from this tokenizer's byte table, so they match
            # what decode() renders
            token_table=token_byte_table(tokenizer,
                                         vocab_size=cfg.vocab_size),
            grammar_cache_entries=int(os.environ.get(
                "GENERATE_CONSTRAIN_CACHE", "32")),
            logger=app.logger, metrics=app.container.metrics,
            tracer=app.container.tracer, slo=app.container.slo,
            device=dev)

    models_spec = os.environ.get("MODELS", "").strip()
    registry = None
    if models_spec:
        # "name=preset[>fallback]" entries, comma-separated, first=default
        registry = ModelRegistry(
            watchdog=getattr(app.container, "watchdog", None),
            logger=app.logger, metrics=app.container.metrics)
        parsed = []
        for part in models_spec.split(","):
            name, _, rest = part.strip().partition("=")
            preset, _, fallback = rest.partition(">")
            parsed.append((name.strip(), (preset or "small").strip(),
                           fallback.strip() or None))
        shared_pool = None
        if paged_kv:
            # co-resident llama engines share one page pool
            _, pool_cfg = model_config(parsed[0][1])
            shared_pool = PagePool(
                pool_cfg, page=kv_page, device=dev, mesh=mesh,
                budget_bytes=int(os.environ.get(
                    "GENERATE_KV_POOL_BYTES", str(256 << 20))),
                metrics=app.container.metrics)
            registry.page_pool = shared_pool
        for seed, (name, preset, fallback) in enumerate(parsed):
            module, _ = model_config(preset)
            pool = shared_pool if module is llama else None
            eng = make_engine(preset, name, seed * 2, seed == 0,
                              page_pool=pool)
            registry.register(name, eng, fallback=fallback,
                              default=(seed == 0), role=cluster_role)
        engine = registry.engine()
        app.container.tpu = registry
    else:
        engine = make_engine(default_preset, "generate", 0, True)
        app.container.tpu = engine  # engine health at /.well-known/health
    app.enable_statusz()        # live queue/slot/KV-cache/timeline snapshot
    app.enable_varz()           # windowed SLO/goodput/saturation numbers
    app.enable_xlaz()           # compile ledger + prompt-bucket fit view
    app.enable_hbmz()           # device-memory attribution + watchdog HBM
    app.enable_timez()          # multi-res series + anomalies + tick anatomy
    app.enable_workloadz()      # traffic-shape ring + trace export + roofline
    app.enable_sloz()           # error-budget burn rates + worst offenders
    app.enable_whyz()           # per-trace slow-request root-cause verdicts
    app.enable_tunez()          # operating point + auto-tuner candidate ledger
    app.enable_profiler()       # duration-capped on-demand device traces

    grpc_on = grpc_available()

    @app.on_startup
    async def warm_engine():
        # capture every tick graph and the full prefill of every prompt
        # count before the first request (JAX's example compiles counts 1
        # and max_slots), so no capture lands inside a burst
        if not grpc_on:
            app.logger.info("gRPC is off: grpcio is not installed on this "
                            "host; /gofr.Llama/generate and "
                            "/gofr.Disagg/fetch are not served")
        if registry is not None:
            for name in registry.models():
                eng = registry.engine(name)
                await registry.warmup(
                    name, prompt_counts=tuple(range(1, eng.max_slots + 1)))
            await registry.start()
        else:
            await engine.warmup(
                prompt_counts=tuple(range(1, engine.max_slots + 1)))
            await engine.start()

    @app.on_shutdown
    async def log_suggested_ladder():
        # the padding-optimal prompt ladder for the traffic this process
        # saw, for the next deploy's prompt_buckets
        fit = engine.xlaz()["models"]["prompt"]
        if fit["suggested_ladder"]:
            app.logger.info(
                "prompt-bucket fit at shutdown: configured=%s observed=%s "
                "suggested=%s", fit["ladder"],
                fit["observed_batch_sizes"], fit["suggested_ladder"])

    def resolve_engine(ctx=None):
        """The default engine, or the registry's route for /v1/{model}."""
        name = ctx.path_param("model") if ctx is not None else None
        if registry is None:
            if name:
                raise BadRequest(
                    "multi-model routing is off (set MODELS to enable)")
            return engine
        try:
            return registry.route(name or None)
        except KeyError as exc:
            raise BadRequest(str(exc)) from exc
        except ModelUnavailable as exc:
            raise Unavailable(str(exc)) from exc

    def parse_request(data):
        try:
            prompt_ids = tokenizer.encode(data["prompt"])[-512:]
            max_new = int(data.get("max_new_tokens", 32))
            seed = data.get("seed")
            # no seed: fresh entropy a request; a seed reproduces
            sampling = Sampling(
                temperature=float(data.get("temperature", 0.0)),
                top_k=int(data.get("top_k", 0)),
                top_p=float(data.get("top_p", 1.0)),
                seed=int(seed) if seed is not None else None)
        except KeyError as exc:
            raise BadRequest(f"missing field: {exc}") from exc
        except (TypeError, ValueError) as exc:
            raise BadRequest(f"bad field value: {exc}") from exc
        response_format = data.get("response_format")
        if response_format is not None and not isinstance(response_format,
                                                          dict):
            raise BadRequest("response_format must be an object")
        return prompt_ids, max_new, sampling, response_format

    async def start_stream(eng, data):
        """Validate and admit first, so a bad request is a 400 before any
        stream byte is written."""
        prompt_ids, max_new, sampling, response_format = parse_request(data)
        try:
            return await eng.generate_stream(
                prompt_ids, max_new_tokens=max_new, sampling=sampling,
                response_format=response_format)
        except ValueError as exc:
            raise BadRequest(str(exc)) from exc

    async def generate(ctx):
        eng = resolve_engine(ctx)
        await eng.start()  # idempotent; binds to the serving loop
        prompt_ids, max_new, sampling, response_format = \
            parse_request(ctx.bind())
        try:
            out = await eng.generate(prompt_ids, max_new_tokens=max_new,
                                     sampling=sampling,
                                     response_format=response_format)
        except ValueError as exc:
            raise BadRequest(str(exc)) from exc
        return {"completion": tokenizer.decode(out),
                "tokens": out, "model": eng.model_name,
                "engine": eng.stats()}

    async def generate_stream(ctx):
        eng = resolve_engine(ctx)
        await eng.start()
        stream = await start_stream(eng, ctx.bind())

        async def frames():
            try:
                async for token in stream:
                    yield json.dumps({"token": token,
                                      "text": tokenizer.decode([token])})
                yield "[DONE]"
            finally:
                # a client disconnect closes frames(): the slot stops
                await stream.aclose()

        # on_close covers a client gone before frames() ever started
        return Stream(frames(), sse=True, on_close=stream.cancel)

    async def generate_grpc_stream(ctx):
        eng = resolve_engine()
        await eng.start()
        stream = await start_stream(eng, ctx.request.payload)

        async def tokens():
            try:
                async for token in stream:
                    yield {"token": token,
                           "text": tokenizer.decode([token])}
            finally:
                await stream.aclose()   # RPC cancelled → free the slot

        return tokens()

    # -- the disaggregated plane: the local engine under its CLUSTER_ROLE
    # and every CLUSTER_PEERS entry behind a circuit breaker ---------------
    kv_wire.resolve_codec(os.environ.get("KV_WIRE_CODEC", "auto"),
                          engine.cfg)
    handoffs = HandoffTable(
        capacity=int(os.environ.get("DISAGG_HANDOFF_CAPACITY", "64")),
        ttl_s=float(os.environ.get("DISAGG_HANDOFF_TTL_S", "120")),
        logger=app.logger, metrics=app.container.metrics)
    cluster = ClusterRegistry(logger=app.logger,
                              metrics=app.container.metrics)
    cluster.register("local", cluster_role, InProcTransport(engine))
    for peer_name, peer_role, peer_url, peer_grpc in cluster_peers:
        cluster.register(
            peer_name, peer_role,
            HTTPTransport(peer_url, grpc_target=peer_grpc,
                          logger=app.logger,
                          metrics=app.container.metrics,
                          tracer=app.container.tracer))
    app.container.cluster = cluster  # role-aware readiness in health()
    fleet_routing = os.environ.get("FLEET_ROUTING", "").strip() in (
        "1", "true", "on", "yes")
    if fleet_routing:
        from gofr_tpu_torch.tpu.fleet import Autoscaler, FleetRouter
        router = FleetRouter(
            cluster, logger=app.logger,
            metrics=app.container.metrics,
            tracer=app.container.tracer,
            digest_entries=int(
                os.environ.get("FLEET_DIGEST_ENTRIES", "512")))
    else:
        router = DisaggRouter(cluster, logger=app.logger,
                              metrics=app.container.metrics,
                              tracer=app.container.tracer)
    app.container.cluster_router = router  # clusterz/tracez discovery
    app.enable_clusterz()       # fleet rollup over the replica registry
    app.enable_tracez()         # stitched per-trace_id disagg timelines

    if fleet_routing:
        # one digest sweep a minute; a firing skips while the last one
        # still runs
        refresh_state = {"busy": False}

        async def fleet_refresh(ctx=None):
            if refresh_state["busy"]:
                return
            refresh_state["busy"] = True
            try:
                await router.refresh()
            finally:
                refresh_state["busy"] = False

        app.add_cron_job("* * * * *", "fleet-refresh", fleet_refresh)

        autoscale_spec = os.environ.get("FLEET_AUTOSCALE", "").strip()
        if autoscale_spec:
            def request_capacity():
                app.logger.info(
                    "fleet autoscaler: scale-up requested — wire your "
                    "orchestrator (spawn a replica, resize the "
                    "deployment) here")

            autoscaler = Autoscaler(
                cluster,
                scale_up=request_capacity,
                scale_down=lambda name: router.drain(name),
                router=router,
                metrics=app.container.metrics, logger=app.logger,
                container=app.container,
                compile_ledger=getattr(app.container.tpu, "ledger",
                                       None),
                min_decode=int(os.environ.get("FLEET_MIN_DECODE", "1")),
                max_decode=int(os.environ.get("FLEET_MAX_DECODE", "4")),
                queue_high=int(os.environ.get("FLEET_QUEUE_HIGH", "8")),
                queue_low=int(os.environ.get("FLEET_QUEUE_LOW", "1")),
                hbm_high=float(os.environ.get("FLEET_HBM_HIGH", "0.85")),
                cooldown_s=float(
                    os.environ.get("FLEET_COOLDOWN_S", "60")))
            router.autoscaler = autoscaler
            app.add_cron_job(autoscale_spec, "fleet-autoscale",
                             autoscaler)

    def parse_sampling(get):
        """Sampling from flat key→value accessors; absent keys: greedy."""
        seed = get("seed")
        return Sampling(
            temperature=float(get("temperature") or 0.0),
            top_k=int(get("top_k") or 0),
            top_p=float(get("top_p") or 1.0),
            seed=int(seed) if seed not in (None, "") else None)

    async def disagg_prefill(ctx):
        # prefill here, pack off the loop, park for pickup
        await engine.start()
        data = ctx.bind()
        try:
            prompt_ids = [int(t) for t in data["prompt"]]
            sampling = parse_sampling((data.get("sampling") or {}).get)
            payload = await engine.prefill_export(
                prompt_ids, sampling=sampling,
                traceparent=ctx.header("traceparent") or None)
        except KeyError as exc:
            raise BadRequest(f"missing field: {exc}") from exc
        except (TypeError, ValueError) as exc:
            raise BadRequest(str(exc)) from exc
        loop = asyncio.get_running_loop()
        blob = await loop.run_in_executor(None, kv_wire.pack, payload)
        return {"handoff": handoffs.put(blob), "bytes": len(blob),
                "payload": payload.describe()}

    async def disagg_fetch(ctx):
        try:
            blob = handoffs.get(ctx.param("handoff"))
        except HandoffExpired as exc:
            # the id was real, its TTL lapsed: re-prefill
            raise HandoffGone(str(exc)) from exc
        except KeyError as exc:
            raise BadRequest(str(exc)) from exc
        return FileResponse(content=blob)

    async def disagg_fetch_grpc(ctx):
        blob = handoffs.get(ctx.request.payload["handoff"])

        async def chunks():
            for chunk in kv_wire.iter_chunks(blob):
                yield {"chunk": base64.b64encode(chunk).decode("ascii")}

        return chunks()

    async def disagg_adopt(ctx):
        # admit shipped KV (no local prefill), decode to the budget,
        # return the whole completion
        await engine.start()
        blob = ctx.request.body
        try:
            max_new = int(ctx.param("max_new_tokens") or 32)
            eos_raw = ctx.param("eos_id")
            sampling = parse_sampling(
                lambda key: ctx.param(key) or None)
            loop = asyncio.get_running_loop()
            payload = await loop.run_in_executor(None, kv_wire.unpack, blob)
            stream = await engine.adopt_kv(
                payload, max_new, eos_id=int(eos_raw) if eos_raw else None,
                sampling=sampling,
                traceparent=ctx.header("traceparent") or None,
                transfer_bytes=len(blob))
        except kv_wire.KVWireError as exc:
            raise BadRequest(str(exc)) from exc
        except (TypeError, ValueError) as exc:
            raise BadRequest(str(exc)) from exc
        tokens = [token async for token in stream]
        return {"tokens": tokens, "model": engine.model_name}

    async def disagg_adopt_session(ctx):
        # the target half of a live migration: a peer's session snapshot,
        # no re-prefill; the rest of the completion is the response
        await engine.start()
        blob = ctx.request.body
        try:
            remaining = int(ctx.param("remaining") or 0)
            eos_raw = ctx.param("eos_id")
            sampling = parse_sampling(
                lambda key: ctx.param(key) or None)
            loop = asyncio.get_running_loop()
            payload = await loop.run_in_executor(None, kv_wire.unpack, blob)
            stream = await engine.adopt_session(
                payload, remaining,
                eos_id=int(eos_raw) if eos_raw else None,
                sampling=sampling,
                traceparent=ctx.header("traceparent") or None,
                transfer_bytes=len(blob))
        except kv_wire.KVWireError as exc:
            raise BadRequest(str(exc)) from exc
        except (TypeError, ValueError) as exc:
            raise BadRequest(str(exc)) from exc
        tokens = [token async for token in stream]
        return {"tokens": tokens, "model": engine.model_name}

    async def disagg_generate(ctx):
        # the router: prefill replica → KV handoff → decode replica
        await engine.start()
        prompt_ids, max_new, sampling, _ = parse_request(ctx.bind())
        try:
            out = await router.generate(prompt_ids, max_new,
                                        sampling=sampling)
        except NoReplicaAvailable as exc:
            raise Unavailable(str(exc)) from exc
        except kv_wire.KVWireError as exc:
            raise BadRequest(str(exc)) from exc
        except ValueError as exc:
            raise BadRequest(str(exc)) from exc
        return {"completion": tokenizer.decode(out), "tokens": out,
                "router": router.stats()}

    async def disagg_drain(ctx):
        name = (ctx.bind() or {}).get("replica", "local")
        try:
            # the fleet router drains by migrating sessions first; the
            # registry's drain waits out the streams in flight
            fleet_drain = getattr(router, "drain", None)
            if fleet_drain is not None:
                drained = await fleet_drain(name)
            else:
                drained = await cluster.drain(name)
        except KeyError as exc:
            raise BadRequest(str(exc)) from exc
        return {"replica": name, "drained": drained,
                "cluster": cluster.stats()}

    # the batch lane with this tokenizer's hooks: jobs carry text prompts,
    # results carry decoded text
    if app.config.get("BATCH_LANE_TOPIC") \
            and app.container.pubsub is not None:
        from gofr_tpu_torch.tpu.batch_lane import new_batch_lane
        app.container.batch_lane = new_batch_lane(
            app.config, app.container.tpu, app.container,
            encode=lambda text: tokenizer.encode(text)[-512:],
            decode=tokenizer.decode)

    app.post("/generate", generate)
    app.post("/generate/stream", generate_stream)
    app.post("/v1/{model}/generate", generate)
    app.post("/v1/{model}/generate/stream", generate_stream)
    if grpc_on:
        app.register_grpc_stream("Llama", "generate", generate_grpc_stream)
    app.post("/disagg/prefill", disagg_prefill)
    app.get("/disagg/fetch", disagg_fetch)
    app.post("/disagg/adopt", disagg_adopt)
    app.post("/disagg/adopt_session", disagg_adopt_session)
    app.post("/disagg/generate", disagg_generate)
    app.post("/disagg/drain", disagg_drain)
    if grpc_on:
        app.register_grpc_stream("Disagg", "fetch", disagg_fetch_grpc)
    app.engine = engine
    app.registry = registry
    app.tokenizer = tokenizer
    app.grpc_on = grpc_on
    return app


if __name__ == "__main__":
    build_app().run()

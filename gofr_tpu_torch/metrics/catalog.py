"""The metric names the port's serving code emits, with the kinds and
histogram buckets the app's catalog registers them under
(``gofr_tpu/container.py``'s ``register_framework_metrics``; documented in
``docs/quick-start/observability.md``). The port adds no name: this is
the slice of that catalog the engine, its page pool, the SLO tracker,
the watchdog, the brownout ladder, the fault plane, the telemetry store,
the error-budget plane, the traffic recorder, the background-task
spawner, the model registry, the disaggregated cluster, the fleet
router and autoscaler, the operating-point auto-tuner, the executor,
the dynamic batcher, the batch lane and the in-memory broker write, so a
:class:`~gofr_tpu_torch.metrics.manager.Manager` of the port's own can
take every call they make. :data:`FRAMEWORK_METRICS` is the rest of that
catalog (the runtime gauges, HTTP, cron, the datasources), which the
app's container registers beside it, so its scrape lists JAX's names.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

__all__ = ["ENGINE_METRICS", "FRAMEWORK_METRICS",
           "register_engine_metrics", "register_framework_metrics"]

_SECONDS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)

# (name, kind, buckets or None, description)
ENGINE_METRICS: Tuple[Tuple[str, str, Optional[tuple], str], ...] = (
    ("app_tpu_h2d_bytes_total", "updown_counter", None,
     "host-to-device bytes shipped, per path"),
    ("app_tpu_h2d_seconds", "histogram",
     (0.00003, 0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1),
     "host-to-device transfer wall time, per path"),
    ("app_tpu_ttft", "histogram", _SECONDS,
     "time to first generated token (s)"),
    ("app_tpu_batch_size", "histogram", (1, 2, 4, 8, 16, 32, 64, 128, 256),
     "slots a decode or spec tick served"),
    ("app_tpu_attention_window", "gauge", None,
     "decode attention window rung"),
    ("app_tpu_attn_kernel_total", "counter", None,
     "decode/verify dispatches by attention path"),
    ("app_tpu_kv_ragged_fill_ratio", "gauge", None,
     "live KV tokens / mapped page capacity of a paged tick"),
    ("app_tpu_kv_pages_used", "gauge", None,
     "KV page pool: pages referenced"),
    ("app_tpu_kv_pages_capacity", "gauge", None,
     "KV page pool: pages in the pool"),
    ("app_tpu_kv_pages_written_total", "updown_counter", None,
     "pool page-rows written by prefill scatters"),
    ("app_tpu_kv_pages_stalled_total", "counter", None,
     "page allocations that failed after reclaim"),
    ("app_tpu_spec_proposed_total", "updown_counter", None,
     "draft tokens proposed"),
    ("app_tpu_spec_accepted_total", "updown_counter", None,
     "draft tokens the target accepted"),
    ("app_tpu_spec_acceptance_rate", "gauge", None,
     "windowed speculative acceptance rate"),
    ("app_tpu_spec_gamma", "gauge", None, "gamma of the last spec tick"),
    ("app_tpu_sched_tokens_total", "updown_counter", None,
     "generated tokens by SLO class"),
    ("app_tpu_sched_shed_total", "counter", None,
     "admissions shed by SLO class"),
    ("app_tpu_admission_queue_depth", "gauge", None,
     "queued admissions by SLO class"),
    ("app_tpu_slot_quarantine_total", "counter", None,
     "slots failed alone, by reason"),
    ("app_tpu_engine_compiles_total", "counter", None,
     "engine executables built (graph captures), warmup or serving"),
    ("app_tpu_device_seconds_total", "updown_counter", None,
     "dispatch-to-publish seconds by model and SLO class"),
    ("app_tpu_executable_device_seconds_total", "updown_counter", None,
     "dispatch-to-publish seconds by model and executable family"),
    ("app_tpu_bucket_hits_total", "counter", None,
     "prompts per bucket"),
    ("app_tpu_slo_total", "counter", None,
     "terminal requests by deadline outcome"),
    ("app_tpu_deadline_violation_seconds", "histogram", _SECONDS,
     "how late past its deadline a violated request finished (s)"),
    ("app_tpu_tokens_per_s", "gauge", None,
     "raw generated tokens/s over the window"),
    ("app_tpu_goodput_tokens_per_s", "gauge", None,
     "tokens/s of requests that met their deadline"),
    ("app_tpu_slo_attainment", "gauge", None,
     "fraction of windowed terminal requests that met their deadline"),
    ("app_health_transitions_total", "counter", None,
     "watchdog READY<->DEGRADED flips"),
    ("app_tpu_brownout_level", "gauge", None, "brownout ladder rung"),
    ("app_tpu_fault_injected_total", "counter", None,
     "seeded faults fired, by site"),
    ("app_tpu_workload_events_total", "counter", None,
     "requests admitted into the workload recorder's shape-only ring, per "
     "(model, SLO class) — token lengths and timings only, never token "
     "content"),
    ("app_tpu_anomaly_total", "counter", None,
     "telemetry anomalies raised by the change-point detector, per "
     "(signal, direction) — a goodput cliff or padding spike that "
     "survived the detector's hysteresis"),
    ("app_tpu_slo_burn_rate", "gauge", None,
     "error-budget burn multiple per (model, class, window); 1.0 spends "
     "exactly the budget over the objective period"),
    ("app_tpu_slo_budget_remaining", "gauge", None,
     "fraction of the (model, class) error budget left over the "
     "accounting window"),
    ("app_async_task_failures_total", "counter", None,
     "background asyncio tasks that died with an escaped exception, by "
     "task name"),
    # the model registry and the disaggregated cluster
    ("app_tpu_model_state", "gauge", None,
     "registry lifecycle per model: 0 LOADING, 1 WARMING, 2 READY, "
     "3 DRAINING, 4 UNLOADED"),
    ("app_tpu_model_fallback_total", "counter", None,
     "requests routed to a fallback model (by source model and "
     "fallback taken) — non-zero means degraded or non-READY "
     "routing is active"),
    ("app_tpu_kv_transfer_seconds", "histogram",
     (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10),
     "prefill→decode KV handoff wall time (pack + wire + unpack), "
     "by transport (inproc|http)"),
    ("app_tpu_kv_transfer_bytes_total", "updown_counter", None,
     "KV bytes adopted from remote prefill, per model"),
    ("app_tpu_kv_adoptions_total", "counter", None,
     "migrated requests whose KV was admitted as page-table "
     "entries (zero decode-side prefill), per model"),
    ("app_tpu_replica_state", "gauge", None,
     "cluster replica lifecycle per (replica, role): 2 READY, "
     "3 DRAINING — same encoding as app_tpu_model_state"),
    ("app_tpu_replica_inflight", "gauge", None,
     "router-level in-flight requests per replica — what drain "
     "waits on"),
    ("app_tpu_kv_handoff_expired_total", "counter", None,
     "packed KV handoffs dropped unclaimed from the prefill "
     "replica's table, by reason (expired = TTL lapsed, evicted = "
     "capacity pressure) — each one is a wasted prompt forward"),
    ("app_tpu_disagg_retry_total", "counter", None,
     "disaggregated-serving retries by leg (prefill|fetch) — "
     "each one is a transient failure the budget absorbed"),
    ("app_tpu_disagg_hedge_total", "counter", None,
     "hedged backup dispatches by leg — the primary blew the "
     "hedge deadline and an idempotent backup raced it"),
    ("app_tpu_adopt_dedup_total", "counter", None,
     "replayed KV adoptions answered from the dedupe ledger, "
     "per model — a retry/hedge landed twice and was deduped"),
    # the fleet control plane and the operating-point auto-tuner
    ("app_tpu_fleet_route_total", "counter", None,
     "decode routing decisions by result (affinity = longest "
     "resident prefix won, fallback = least-inflight pick)"),
    ("app_tpu_fleet_affinity_pages", "histogram",
     (1, 2, 4, 8, 16, 32, 64),
     "resident-prefix depth (pages) of each affinity-routed "
     "request — how much prefill the fleet index saved"),
    ("app_tpu_fleet_migrations_total", "counter", None,
     "live decode→decode session migrations by result (ok|error)"),
    ("app_tpu_fleet_migration_seconds", "histogram",
     (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10),
     "migration downtime: source export start → target adopt done "
     "(the client stream's splice gap)"),
    ("app_tpu_fleet_autoscale_total", "counter", None,
     "autoscaler decisions by result (up|down|hold|cooldown|"
     "compile_guard|overlap)"),
    ("app_tpu_fleet_decode_replicas", "gauge", None,
     "READY decode-serving replicas the autoscaler last observed"),
    ("app_tpu_fleet_resume_total", "counter", None,
     "mid-stream decode resumes by result (ok|no_ctx|budget|"
     "exhausted|no_replica|error) — ok means the stream was "
     "rebuilt from prompt + emitted tokens on a live replica"),
    ("app_tpu_autotune_total", "counter", None,
     "auto-tuner decisions by result (applied|rejected|"
     "rolled_back|hold|proposed|probation|no_trace|cooldown|"
     "compile_guard|overlap|refused_brownout|refused_fast_burn|"
     "rollback_blocked|probation_ok)"),
    ("app_tpu_autotune_score", "gauge", None,
     "shadow-replay score of the last APPLIED operating point "
     "(deterministic goodput-per-cost proxy over the recorded "
     "trace)"),
    ("app_tpu_autotune_generation", "gauge", None,
     "operating-point generation counter on the engine — bumps "
     "on every guarded apply, including rollbacks"),
    # the executor, its compile ledger and the dynamic batcher
    ("app_tpu_execute", "histogram",
     (0.0005, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1),
     "executor dispatch-to-fetch wall time (s)"),
    ("app_tpu_requests_total", "counter", None, "executor predict steps"),
    ("app_tpu_step_phase_seconds", "histogram",
     (0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3),
     "executor step phases: serialize | stage | upload | enqueue | "
     "device_wait (host_prep replaces the first three, staging off)"),
    ("app_tpu_compile_total", "counter", None,
     "executor graph captures by cause (warmup|serving) and model"),
    ("app_tpu_compile_seconds", "histogram",
     (0.1, 0.3, 1, 3, 10, 30, 100, 300),
     "one executor graph capture's wall time (s)"),
    ("app_tpu_flush_total", "counter", None,
     "dynamic-batcher flushes by cause (full|timer) and model"),
    ("app_tpu_batch_fill", "histogram",
     (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
     "flushed batch size / max_batch per flush"),
    ("app_tpu_duty_cycle", "gauge", None,
     "fraction of the rolling window the device spent executing"),
    ("app_tpu_mfu", "gauge", None,
     "model flops utilization vs TPU_PEAK_FLOPS over the window"),
    ("app_tpu_effective_mfu", "gauge", None,
     "MFU counting only real (non-padding) rows' FLOPs"),
    ("app_tpu_padding_ratio", "gauge", None,
     "fraction of executed device rows that were padding"),
    ("app_tpu_hbm_occupancy", "gauge", None,
     "device bytes in use / bytes in all, per device"),
    ("app_tpu_hbm_bytes_in_use", "gauge", None,
     "device bytes in use, per device"),
    ("app_tpu_device_up", "gauge", None, "per-device liveness 0/1"),
    # the batch lane and the in-memory broker
    ("app_tpu_batch_lane_jobs_total", "counter", None,
     "batch-lane jobs by outcome (ok|dead_letter)"),
    ("app_tpu_batch_lane_inflight", "gauge", None,
     "batch-lane jobs generating, per topic"),
    ("app_tpu_batch_lane_paused", "gauge", None,
     "1 while backpressure has the lane's consumer paused, per topic"),
    ("app_pubsub_consumer_paused_total", "counter", None,
     "consumer pause transitions per (topic, reason)"),
    ("app_pubsub_publish_total_count", "counter", None, "publish attempts"),
    ("app_pubsub_publish_success_count", "counter", None, "publishes ok"),
    ("app_pubsub_subscribe_total_count", "counter", None,
     "receive attempts"),
    ("app_pubsub_subscribe_success_count", "counter", None, "receives ok"),
)


def register_engine_metrics(manager: Any) -> Any:
    """Register :data:`ENGINE_METRICS` on ``manager`` (anything with the
    ``new_*`` registration methods); returns it."""
    return _register(manager, ENGINE_METRICS)


_HTTP_SECONDS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10, 30)

FRAMEWORK_METRICS: Tuple[Tuple[str, str, Optional[tuple], str], ...] = (
    ("app_info", "gauge", None, "application name/version info"),
    ("threads_total", "gauge", None, "live Python threads"),
    ("memory_rss_bytes", "gauge", None, "resident set size"),
    ("gc_objects", "gauge", None, "gen-0 tracked objects"),
    ("uptime_seconds", "gauge", None, "process uptime"),
    ("app_http_response", "histogram", _HTTP_SECONDS,
     "inbound HTTP response time (s)"),
    ("app_http_service_response", "histogram", _HTTP_SECONDS,
     "outbound HTTP call time (s)"),
    ("app_redis_stats", "histogram", (0.00005, 0.0001, 0.0003, 0.001, 0.003),
     "redis op time (s)"),
    ("app_sql_stats", "histogram", (0.00005, 0.0001, 0.0005, 0.001, 0.01),
     "sql query time (s)"),
    ("app_sql_open_connections", "gauge", None, "SQL connection up 0/1"),
    ("app_sql_inuse_connections", "gauge", None,
     "SQL statements currently executing"),
    ("app_tpu_prefix_lookup_total", "counter", None,
     "prefix-cache lookups by result (hit|partial|miss)"),
    ("app_tpu_prefix_tokens_saved_total", "updown_counter", None,
     "prompt tokens served from cached prefix KV instead of prefill"),
    ("app_tpu_prefix_cache_occupancy", "gauge", None,
     "prefix-KV page pool: used pages / total pages"),
    ("app_tpu_hbm_attributed_bytes", "gauge", None,
     "device bytes the serving stack accounts for (params + KV page pool "
     "+ staging slabs)"),
    ("app_tpu_hbm_unattributed_bytes", "gauge", None,
     "device bytes in use minus attributed bytes"),
    ("app_tpu_circuit_state_total", "counter", None,
     "circuit-breaker transitions by state entered "
     "(open|half_open|closed)"),
    ("app_http_inflight", "updown_counter", None,
     "inbound HTTP requests currently in flight"),
    ("app_cron_duration", "histogram", (0.001, 0.01, 0.1, 1, 10, 60, 300),
     "cron job run time (s)"),
    ("app_cron_runs_total", "counter", None,
     "cron job runs by job name and result"),
)


def _register(manager: Any, catalog) -> Any:
    for name, kind, buckets, desc in catalog:
        if kind == "histogram":
            manager.new_histogram(name, desc, buckets)
        else:
            getattr(manager, f"new_{kind}")(name, desc)
    return manager


def register_framework_metrics(manager: Any) -> Any:
    """Register the app's whole catalog, :data:`ENGINE_METRICS` and
    :data:`FRAMEWORK_METRICS`, on ``manager``; returns it."""
    _register(manager, ENGINE_METRICS)
    return _register(manager, FRAMEWORK_METRICS)

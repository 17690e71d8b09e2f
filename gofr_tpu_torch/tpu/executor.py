"""The executor: the generic batched inference backend (counterpart of
``gofr_tpu/tpu/executor.py``), serving any ``fn(params, inputs)`` at a
ladder of batch buckets.

- **One CUDA graph a (model, bucket).** JAX compiles one executable a
  bucket; the port captures one graph a bucket over static input
  buffers (:func:`capture.record`: an eager run first on the process's
  one side stream, under ``set_sync_debug_mode("error")``, so cuDNN and
  cuBLAS choose their algorithms and workspaces outside the capture; the
  capture in the process's one capture turn, which the generation
  engine's captures take too). A batch is padded up to its bucket, so a
  warm bucket serves with one replay and no capture. The capture is a
  compile in the :class:`~gofr_tpu_torch.tpu.compile_ledger.CompileLedger`
  (cause ``warmup`` or ``serving``); a serving one logs at warn and holds
  ``model.lock``, as JAX's does, and ``health_check()["compiling"]``
  shows it while it runs. On the card a failed capture, or a host sync
  inside ``fn``, raises: there is no eager fallback. On the CPU ``fn``
  runs eagerly every batch and nothing is captured; a bucket's first run
  there (its static buffers made, its FLOPs counted) is its compile.
- **Weights resident on the card**: ``register`` moves the params once,
  and nothing reallocates them, since each graph captures their
  addresses.
- **The data plane**: ``dispatch_rows`` writes each request's rows
  straight into a pinned staging slab of the (model, bucket) ring
  (:class:`~gofr_tpu_torch.tpu.staging.StagingPool`), copies the slab
  into the bucket's static inputs, replays the graph and at once queues
  the device-to-host copy of the static output into a pinned fetch slab,
  all on the executor's own stream; the slab goes back to its ring with
  the event behind its copy. ``fetch`` (a worker thread) waits on the
  output copy's event: the batcher dispatches batch N+1 before it
  fetches batch N, and a replay of the same bucket would overwrite a
  static output read later.
- **Saturation**: duty cycle from the dispatch-to-fetch seconds, FLOPs
  per bucket counted once with ``torch.utils.flop_counter.FlopCounterMode``
  on the capture's eager run (JAX reads XLA's ``cost_analysis``), MFU
  against ``TPU_PEAK_FLOPS`` as given, device memory from
  ``torch.cuda.mem_get_info``.

Inputs and outputs are pytrees of dicts, lists and tuples (JAX's leaf
order: dict keys sorted); inputs are numpy arrays or array-likes, 64-bit
types narrowed to 32 as JAX narrows them; outputs come back as numpy
arrays (bfloat16 widened to float32).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.metrics.digest import WindowedCounter
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.tpu import capture
from gofr_tpu_torch.tpu.compile_ledger import (CAUSE_SERVING, CAUSE_WARMUP,
                                               CompileLedger,
                                               ExecutableLedger, ShapeStats,
                                               charge_device_time,
                                               fingerprint_capture,
                                               suggest_ladder)
from gofr_tpu_torch.tpu.staging import StagingPool
from gofr_tpu_torch.trace import current_span

__all__ = ["DEFAULT_BUCKETS", "Executor", "new_executor", "tree_leaves",
           "tree_map", "tree_unflatten"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# JAX's dtype canonicalization (x64 off): the slab holds the bytes the
# static inputs take
_CANON = {np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


def _canon_dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    return _CANON.get(dt, dt)


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


# -- pytree plumbing (JAX's leaf order) ---------------------------------------
def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts (keys sorted), lists and tuples; None
    is an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """``like``'s structure with ``leaves`` in its leaves' places."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, tuple):
            return tuple(build(n) for n in node)
        if isinstance(node, list):
            return [build(n) for n in node]
        if node is None:
            return None
        return next(it)
    return build(like)


def tree_map(fn: Callable, *trees: Any) -> Any:
    return tree_unflatten(trees[0], [fn(*leaves) for leaves in
                                     zip(*[tree_leaves(t) for t in trees])])


def _pad_batch(leaf: np.ndarray, bucket: int) -> np.ndarray:
    """Pad the leading axis up to ``bucket``. A leaf that already fills
    the bucket is returned as-is (same object, no allocation)."""
    n = leaf.shape[0]
    if n == bucket:
        return leaf
    pad = [(0, bucket - n)] + [(0, 0)] * (leaf.ndim - 1)
    return np.pad(leaf, pad)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {key: _to_device(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(val, device) for val in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree)).to(device)


class _Bucket:
    """One (model, bucket) executable: its static inputs (and their
    (shape, dtype) specs), the skeleton of the input tree, on the card its
    graph, static outputs and the launches one replay makes; its FLOPs."""
    __slots__ = ("specs", "skeleton", "inputs", "graph", "out", "launches",
                 "flops")

    def __init__(self, specs, skeleton, inputs):
        self.specs = specs
        self.skeleton = skeleton
        self.inputs = inputs
        self.graph = None
        self.out: Any = None
        self.launches: Dict[str, int] = {}
        self.flops: Optional[float] = None


class _Model:
    def __init__(self, name: str, fn: Callable, params: Any,
                 buckets: Sequence[int]):
        self.name = name
        self.fn = fn
        self.params = params
        self.buckets = tuple(sorted(buckets))
        self.compiled: Dict[int, _Bucket] = {}
        self.lock = threading.Lock()
        # over a mesh: each dp row's params (None: the params serve all)
        self.rows: Optional[List[Any]] = None


class Executor:
    """Owns registered models, their per-bucket graphs, and device health.

    ``fn(params, inputs)`` is a torch function of the port's params and a
    tree of tensors whose leading axis is the batch; it returns a tree of
    tensors with the batch leading. It must not sync the host (on the
    card it is captured)."""

    def __init__(self, logger, metrics, mesh=None, peak_flops: float = 0.0,
                 ledger: Optional[CompileLedger] = None,
                 recorder: Any = None, staging: bool = True,
                 staging_depth: int = 2, device="cuda",
                 batch_axis: str = "dp"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.batch_axis = batch_axis
        if mesh is not None:
            from gofr_tpu_torch.parallel.mesh import check_one_card
            check_one_card(mesh, self.device, "executor")
        self.logger = logger
        self.metrics = metrics
        self._models: Dict[str, _Model] = {}
        self._cuda = self.device.type == "cuda"
        # the executor's own stream: every upload, replay and fetch copy
        # is queued on it, whichever thread dispatches
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._graph_pool = None
        # copy-in, replay and fetch copy of one dispatch are queued as one
        # (the loop thread's warm dispatches and workers' cold predicts)
        self._enqueue_lock = threading.Lock()
        # pinned slabs: the fetch copies' always, the inputs' when staging
        self._slabs = StagingPool(self.device, depth=staging_depth)
        self._staging = self._slabs if staging else None
        self.peak_flops = float(peak_flops)
        self._busy_s = WindowedCounter()
        self._flops_done = WindowedCounter()
        self._flops_useful = WindowedCounter()
        self.ledger = ledger if ledger is not None \
            else CompileLedger(metrics)
        self.shapes = ShapeStats(metrics)
        self.exec_ledger = ExecutableLedger(metrics,
                                            peak_flops=self.peak_flops)
        self.recorder = recorder
        self._compiling: Dict[Tuple[str, int], float] = {}

    # -- registration ---------------------------------------------------------
    def register(self, name: str, fn: Callable, params: Any,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 param_specs: Any = None) -> None:
        """Put the weights on the device once and set up the bucket
        ladder. Over a mesh (dp on ``batch_axis``) the params are held at
        every coordinate (``param_specs``, replicated when None; a spec
        that shards any axis is refused: an arbitrary ``fn`` cannot be
        partitioned without GSPMD), every bucket is rounded up to a
        multiple of dp, and a batch's rows split over the dp rows, each
        row running ``fn`` over its rows and its params."""
        rows = None
        if self.mesh is not None:
            params, rows = self._shard(params, param_specs)
            dp = self.mesh.shape.get(self.batch_axis, 1)
            buckets = sorted({-(-b // dp) * dp for b in buckets})
        else:
            params = _to_device(params, self.device)
        model = _Model(name, fn, params, buckets)
        model.rows = rows
        if self._stream is not None:
            # the params' writes (an init, a copy) are queued on the
            # caller's stream: every capture and replay comes after them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._models[name] = model
        if self.logger is not None:
            self.logger.info("tpu: model %s registered (buckets=%s, "
                             "mesh=%s)", name, list(model.buckets),
                             dict(self.mesh.shape) if self.mesh else None)

    def _shard(self, params: Any, param_specs: Any):
        """The params over the mesh (``parallel/sharding.shard_pytree``)
        and each dp row's tree (its first coordinate's)."""
        from gofr_tpu_torch.parallel.sharding import (
            local_tree, map_specs, replicated_specs, shard_pytree)
        specs = param_specs if param_specs is not None \
            else replicated_specs(params)

        def check(_, spec):
            if any(axis is not None for axis in spec):
                raise ValueError(
                    f"param_specs: {spec!r} shards a parameter; the "
                    f"executor serves data parallelism only (params "
                    f"replicated, the batch on {self.batch_axis!r}): an "
                    f"arbitrary fn is not partitioned without GSPMD")
            return spec
        map_specs(check, params, specs)
        sharded = shard_pytree(params, self.mesh, specs)
        rows = [local_tree(sharded, line[0])
                for line in self.mesh.axis_coords(self.batch_axis)] \
            if self.batch_axis in self.mesh.shape \
            else [local_tree(sharded, self.mesh.coords()[0])]
        return sharded, rows

    def models(self) -> Sequence[str]:
        return list(self._models)

    def warmup(self, name: str, example: Any) -> None:
        """Capture every bucket from one example input (no serving-time
        capture afterwards)."""
        model = self._models[name]
        leaves = [np.asarray(leaf) for leaf in tree_leaves(example)]
        for bucket in model.buckets:
            rows = [np.repeat(leaf[None], bucket, axis=0).astype(
                _canon_dtype(leaf.dtype)) for leaf in leaves]
            specs = [(r.shape, r.dtype.name) for r in rows]
            waits, _, _ = self._enqueue(
                model, example, bucket, specs,
                [torch.from_numpy(r) for r in rows], None, CAUSE_WARMUP)
            for wait in waits:
                wait()

    # -- predict --------------------------------------------------------------
    def _model(self, name: str) -> _Model:
        model = self._models.get(name)
        if model is None:
            raise KeyError(f"tpu model {name!r} not registered "
                           f"(have {list(self._models)})")
        return model

    def predict(self, name: str, inputs: Any) -> Any:
        """Synchronous batched predict: padded up to the next bucket and
        sliced back; a batch past the top bucket is split into chunks of
        it."""
        model = self._model(name)
        leaves = tree_leaves(inputs)
        n = leaves[0].shape[0]
        bucket = next((b for b in model.buckets if b >= n), None)
        if bucket is None:
            bucket = model.buckets[-1]
            outs = [self.predict(name, tree_unflatten(
                inputs, [leaf[i:i + bucket] for leaf in leaves]))
                for i in range(0, n, bucket)]
            return tree_map(lambda *ls: np.concatenate(
                [np.asarray(leaf) for leaf in ls]), *outs)
        return self.fetch(self._dispatch(model, name, inputs, leaves, n,
                                         bucket))

    def is_warm(self, name: str, n: int) -> bool:
        """True when a batch of ``n`` hits an already-captured bucket, so
        ``dispatch`` is cheap enough for the event loop."""
        model = self._models.get(name)
        if model is None:
            return False
        bucket = next((b for b in model.buckets if b >= n), None)
        return bucket is not None and bucket in model.compiled

    def _bucket_for(self, model: _Model, n: int) -> int:
        bucket = next((b for b in model.buckets if b >= n), None)
        if bucket is None:
            raise ValueError(
                f"batch {n} exceeds largest bucket {model.buckets[-1]}; "
                "use predict() which splits oversized batches")
        return bucket

    def dispatch(self, name: str, inputs: Any):
        """Asynchronous half of ``predict``: stage, queue the upload, the
        replay and the output copy; returns the handle ``fetch`` takes."""
        model = self._model(name)
        leaves = tree_leaves(inputs)
        n = leaves[0].shape[0]
        return self._dispatch(model, name, inputs, leaves, n,
                              self._bucket_for(model, n))

    def _dispatch(self, model: _Model, name: str, inputs: Any, leaves,
                  n: int, bucket: int):
        start = time.perf_counter()
        span = current_span()
        arrs = [leaf if isinstance(leaf, np.ndarray) else np.asarray(leaf)
                for leaf in leaves]
        specs = [((bucket,) + a.shape[1:], _canon_dtype(a.dtype).name)
                 for a in arrs]
        if self._staging is None:
            # the unstaged path: pad, then copy from pageable memory
            padded = [torch.from_numpy(np.ascontiguousarray(
                _pad_batch(a.astype(_canon_dtype(a.dtype), copy=False),
                           bucket))) for a in arrs]
            prepped = time.perf_counter()
            waits, like, _ = self._enqueue(model, inputs, bucket, specs,
                                           padded, None, CAUSE_SERVING)
            phases = {"host_prep": prepped - start,
                      "enqueue": time.perf_counter() - prepped}
            return (name, waits, like, n, start, span, bucket, phases)
        serialized = time.perf_counter()
        key = (name, bucket)
        slab = self._staging.acquire(key, specs)
        for buf, arr in zip(slab.buffers, arrs):
            buf[:n] = arr            # converting write, straight into slab
            if n < bucket:
                buf[n:] = 0          # recycled slab: re-zero the pad rows
        staged_at = time.perf_counter()
        return self._finish_staged(model, name, inputs, slab, key, specs, n,
                                   bucket, start, span, serialized,
                                   staged_at, "dispatch")

    def dispatch_rows(self, name: str, examples: Sequence[Any]):
        """Batcher entry point: each request's rows go straight into the
        staging slab (no intermediate stacked batch, no pad copy), then
        dispatch. With staging off: stack, then ``dispatch``."""
        model = self._model(name)
        n = len(examples)
        bucket = self._bucket_for(model, n)
        if self._staging is None:
            batch = tree_map(lambda *rows: np.stack(
                [np.asarray(r) for r in rows]), *examples)
            return self._dispatch(model, name, batch, tree_leaves(batch), n,
                                  bucket)
        start = time.perf_counter()
        span = current_span()
        rows = [[r if isinstance(r, np.ndarray) else np.asarray(r)
                 for r in tree_leaves(e)] for e in examples]
        nleaves = len(rows[0])
        serialized = time.perf_counter()
        # slab specs follow np.stack: equal shapes or raise, dtypes
        # promoted across rows (then canonicalized), so the warm (staged)
        # and cold (stacked) paths agree on the same batch
        for i in range(1, n):
            if len(rows[i]) != nleaves:
                raise ValueError(
                    f"dispatch_rows: example {i} has {len(rows[i])} "
                    f"leaves, example 0 has {nleaves}")
        specs = []
        for j in range(nleaves):
            shape = rows[0][j].shape
            for i in range(1, n):
                if rows[i][j].shape != shape:
                    raise ValueError(
                        f"dispatch_rows: leaf {j} shape mismatch — "
                        f"example {i} is {rows[i][j].shape}, example 0 "
                        f"is {shape} (all rows must stack)")
            dtype = np.result_type(*[r[j].dtype for r in rows])
            specs.append(((bucket,) + shape, _canon_dtype(dtype).name))
        key = (name, bucket)
        slab = self._staging.acquire(key, specs)
        for j, buf in enumerate(slab.buffers):
            for i in range(n):
                buf[i] = rows[i][j]  # value-preserving cast into the slab
            if n < bucket:
                buf[n:] = 0
        staged_at = time.perf_counter()
        return self._finish_staged(model, name, examples[0], slab, key,
                                   specs, n, bucket, start, span, serialized,
                                   staged_at, "rows")

    def _finish_staged(self, model, name, like, slab, key, specs, n, bucket,
                       start, span, serialized, staged_at, path):
        waits, out_like, uploaded = self._enqueue(
            model, like, bucket, specs, slab.tensors, path, CAUSE_SERVING,
            retire=(key, slab))
        enqueued = time.perf_counter()
        self._emit_h2d()
        phases = {"serialize": serialized - start,
                  "stage": staged_at - serialized,
                  "upload": uploaded - staged_at,
                  "enqueue": enqueued - uploaded}
        return (name, waits, out_like, n, start, span, bucket, phases)

    def _emit_h2d(self) -> None:
        metered = self._slabs.drain_meter()
        if self.metrics is None:
            return
        for path, nbytes, seconds in metered:
            self.metrics.delta_updown_counter("app_tpu_h2d_bytes_total",
                                              float(nbytes), path=path)
            self.metrics.record_histogram("app_tpu_h2d_seconds", seconds,
                                          path=path)

    @contextlib.contextmanager
    def _on_stream(self):
        if self._stream is None:
            yield
        else:
            with torch.cuda.stream(self._stream):
                yield

    def _enqueue(self, model: _Model, like: Any, bucket: int, specs,
                 sources: Sequence[torch.Tensor], path: Optional[str],
                 cause: str, retire=None):
        """Capture the bucket if it is new (under ``model.lock``), then on
        the executor's stream: copy ``sources`` into its static inputs
        (metered under ``path`` when given; the slab ``retire`` names goes
        back to its ring with the event behind the copies), replay, and
        queue the copy of every output leaf into a pinned fetch slab.
        Returns the fetch slabs' waits, the output tree's skeleton and the
        instant the uploads were queued."""
        exe = model.compiled.get(bucket)
        if exe is None:
            with model.lock:
                exe = model.compiled.get(bucket)
                if exe is None:
                    exe = self._compile(model, like, bucket, specs, sources,
                                        cause)
        if exe.specs != specs:
            raise ValueError(
                f"tpu model {model.name!r} bucket {bucket}: inputs "
                f"{specs} differ from the captured {exe.specs}")
        with self._enqueue_lock, self._on_stream(), \
                torch.profiler.record_function(f"{model.name}/b{bucket}"):
            for dst, src in zip(exe.inputs, sources):
                t0 = time.perf_counter()
                dst.copy_(src, non_blocking=True)
                if path is not None:
                    self._slabs.note_h2d(src.numel() * src.element_size(),
                                           time.perf_counter() - t0, path)
            if retire is not None:
                event = None
                if self._cuda:
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._slabs.retire(*retire, event)
            uploaded = time.perf_counter()
            if exe.graph is not None:
                exe.graph.replay()
                if any(exe.launches.values()):
                    launch_counts.add(exe.launches)
                out = exe.out
            else:
                out = self._call(model, exe)
            leaves = tree_leaves(out)
            waits = [self._slabs.fetch(leaf) for leaf in leaves]
        return waits, tree_unflatten(out, [0] * len(leaves)), uploaded

    def _call(self, model: _Model, exe: _Bucket) -> Any:
        if model.rows is None:
            return model.fn(model.params, tree_unflatten(exe.skeleton,
                                                         exe.inputs))
        # dp over the batch axis: each row's fn over its rows
        dp = len(model.rows)
        n = exe.inputs[0].shape[0] // dp
        outs = [model.fn(params, tree_unflatten(
                    exe.skeleton, [leaf[d * n:(d + 1) * n]
                                   for leaf in exe.inputs]))
                for d, params in enumerate(model.rows)]
        return tree_map(lambda *parts: torch.cat(parts), *outs)

    def _compile(self, model: _Model, like: Any, bucket: int, specs,
                 sources, cause: str) -> _Bucket:
        """Build the bucket's executable under ``model.lock``: static
        inputs holding this batch, on the card one graph captured after
        an eager run (whose FLOPs are counted); the ledger event with the
        capture's fingerprint. A serving-time capture stalls every request
        for this model behind the lock: it logs at warn."""
        key = (model.name, bucket)
        if cause == CAUSE_SERVING and self.logger is not None:
            self.logger.warn(
                "tpu: serve-time compile of %s bucket=%d started — "
                "requests for this model queue behind model.lock until it "
                "finishes (warm this bucket at startup to avoid it)",
                model.name, bucket)
        self._compiling[key] = time.monotonic()
        try:
            t0 = time.perf_counter()
            with self._on_stream():
                # made and filled on the executor's stream, in its order
                exe = _Bucket(specs, tree_unflatten(like, [0] * len(specs)),
                              [src.to(self.device, _torch_dtype(dtype),
                                      non_blocking=True, copy=True)
                               for src, (_, dtype) in zip(sources, specs)])
            counted = {}

            def eager():
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as counter:
                    self._call(model, exe)
                counted["flops"] = counter.get_total_flops()

            if self._cuda:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                exe.graph, exe.out, exe.launches = capture.record(
                    self.device, self._graph_pool, eager,
                    lambda: self._call(model, exe), after=self._stream)
            else:
                eager()
            duration = time.perf_counter() - t0
        finally:
            self._compiling.pop(key, None)
        exe.flops = float(counted["flops"]) or None
        model.compiled[bucket] = exe
        fingerprint = fingerprint_capture(
            model.fn, bucket, specs,
            [(tuple(t.shape), str(t.dtype))
             for t in tree_leaves(model.params)], exe.launches)
        event = self.ledger.record(model.name, bucket, cause, duration,
                                   fingerprint)
        if self.logger is not None:
            log = (self.logger.warn if cause == CAUSE_SERVING
                   else self.logger.info)
            log("tpu: compiled %s bucket=%d in %.1fs (cause=%s, "
                "fingerprint=%s)", model.name, bucket, duration, cause,
                event.fingerprint)
        return exe

    def fetch(self, handle) -> Any:
        """Wait for a ``dispatch`` handle's output copy, record metrics,
        slice off the padding."""
        name, waits, like, n, start, span, bucket, phases = handle
        wait_start = time.perf_counter()
        values = [wait()[:n] for wait in waits]
        done = time.perf_counter()
        phases = dict(phases, device_wait=done - wait_start)
        elapsed = done - start
        exemplar = ({"trace_id": span.trace_id} if span is not None
                    else None)
        if self.metrics is not None:
            self.metrics.record_histogram("app_tpu_execute", elapsed,
                                          exemplar=exemplar, model=name)
            self.metrics.record_histogram("app_tpu_batch_size", float(n),
                                          model=name)
            self.metrics.increment_counter("app_tpu_requests_total",
                                           model=name)
            for phase, seconds in phases.items():
                self.metrics.record_histogram("app_tpu_step_phase_seconds",
                                              seconds, phase=phase,
                                              model=name)
        self.shapes.record(name, n, bucket)
        if self.recorder is not None:
            self.recorder.record_step(model=name, bucket=bucket, batch=n,
                                      phases=phases)
        self._busy_s.add(elapsed)
        flops = self._bucket_flops(name, bucket)
        if flops:
            self._flops_done.add(flops)
            # only the real rows' share of the padded execute is useful
            self._flops_useful.add(flops * n / bucket)
        charge_device_time(elapsed, name, family=f"b{bucket}",
                           ledger=self.exec_ledger, flops=flops)
        return tree_unflatten(like, values)

    # -- saturation telemetry -------------------------------------------------
    def note_execution(self, seconds: float, flops: float = 0.0) -> None:
        """Device-busy seconds (and FLOPs) executed outside dispatch/fetch,
        counted toward the same duty cycle."""
        if seconds > 0:
            self._busy_s.add(seconds)
        if flops > 0:
            self._flops_done.add(flops)

    def _bucket_flops(self, name: str, bucket: int) -> Optional[float]:
        """FLOPs of one (model, bucket) execution, counted once on its
        capture's eager run; None before it ran."""
        model = self._models.get(name)
        exe = model.compiled.get(bucket) if model is not None else None
        return exe.flops if exe is not None else None

    def _memory(self) -> Tuple[float, float]:
        """(bytes in use, bytes in all) of the device; zeros on the CPU."""
        if not self._cuda:
            return 0.0, 0.0
        free, total = torch.cuda.mem_get_info(self.device)
        return float(total - free), float(total)

    def saturation(self, window_s: float = 60.0) -> Dict[str, Any]:
        """Windowed saturation view (JAX's keys): duty cycle (busy seconds
        per wall second; can pass 1.0 when dispatches overlap), achieved
        FLOP/s, MFU against ``peak_flops``, device memory occupancy."""
        busy = self._busy_s.sum(window_s)
        duty = busy / max(window_s, 1e-9)
        flops_per_s = self._flops_done.rate(window_s)
        useful_per_s = self._flops_useful.rate(window_s)
        mfu = (flops_per_s / self.peak_flops) if self.peak_flops > 0 else None
        effective_mfu = (useful_per_s / self.peak_flops
                         if self.peak_flops > 0 else None)
        padding_ratio = self.shapes.padding_ratio(window_s)
        in_use, limit = self._memory()
        hbm = {"0": {"bytes_in_use": in_use, "bytes_limit": limit,
                     "occupancy": (round(in_use / limit, 4) if limit > 0
                                   else None)}}
        out = {
            "window_s": window_s,
            "busy_s": round(busy, 4),
            "duty_cycle": round(duty, 4),
            "flops_per_s": flops_per_s,
            "useful_flops_per_s": useful_per_s,
            "mfu": round(mfu, 4) if mfu is not None else None,
            "effective_mfu": (round(effective_mfu, 4)
                              if effective_mfu is not None else None),
            "padding_ratio": (round(padding_ratio, 4)
                              if padding_ratio is not None else None),
            "peak_flops": self.peak_flops or None,
            "hbm": hbm,
        }
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_duty_cycle", min(duty, 1.0))
            if mfu is not None:
                self.metrics.set_gauge("app_tpu_mfu", mfu)
            if effective_mfu is not None:
                self.metrics.set_gauge("app_tpu_effective_mfu",
                                       effective_mfu)
            if padding_ratio is not None:
                self.metrics.set_gauge("app_tpu_padding_ratio",
                                       padding_ratio)
            for device_id, entry in hbm.items():
                if entry["occupancy"] is not None:
                    self.metrics.set_gauge("app_tpu_hbm_occupancy",
                                           entry["occupancy"],
                                           device=device_id)
        return out

    # -- compile/shape-plane snapshot ----------------------------------------
    def xlaz(self, recent: int = 64, max_rungs: int = 4) -> Dict[str, Any]:
        """The bucket-tuning view (JAX's keys): the compile ledger, the
        observed batch sizes against each model's ladder, padding waste,
        a padding-optimal suggested ladder, the executables' roofline
        table."""
        # suggestions rounded to the dp multiple over a mesh
        round_to = 1
        if self.mesh is not None and self.batch_axis in self.mesh.shape:
            round_to = self.mesh.shape[self.batch_axis]
        models: Dict[str, Any] = {}
        for name, model in self._models.items():
            observed = self.shapes.distribution(name)
            models[name] = {
                "ladder": list(model.buckets),
                "buckets_compiled": sorted(model.compiled),
                "observed_batch_sizes": {str(k): v for k, v
                                         in sorted(observed.items())},
                "bucket_hits": {str(k): v for k, v in
                                sorted(self.shapes.bucket_hits(name).items())},
                "suggested_ladder": suggest_ladder(
                    observed, max_rungs=max(len(model.buckets), max_rungs),
                    round_to=round_to),
            }
        return {
            "compiles": self.ledger.snapshot(limit=recent),
            "models": models,
            "padding": self.shapes.snapshot(),
            "executables": self.exec_ledger.snapshot(limit=max_rungs * 3),
        }

    def data_plane(self) -> Dict[str, Any]:
        """Staging-slab occupancy and upload totals (JAX's keys). Nothing
        is donated: each batch is copied into its bucket's static inputs,
        which every replay reads."""
        staging = (dict(self._staging.stats(), enabled=True)
                   if self._staging is not None else {"enabled": False})
        return {"staging": staging, "donate_inputs": False}

    # -- health ---------------------------------------------------------------
    def health_check(self) -> Dict[str, Any]:
        details: Dict[str, Any] = {"backend": "gpu" if self._cuda else "cpu",
                                   "devices": {}}
        try:
            in_use, limit = self._memory()
            stats = {"hbm_bytes_in_use": in_use, "hbm_bytes_limit": limit}
            if self.metrics is not None:
                self.metrics.set_gauge("app_tpu_hbm_bytes_in_use", in_use,
                                       device="0")
            up = True
        except RuntimeError as exc:  # the card is unreachable
            stats = {"error": repr(exc)}
            up = False
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_device_up", 1.0 if up else 0.0,
                                   device="0")
        details["devices"]["0"] = {"status": "UP" if up else "DOWN", **stats}
        details["models"] = {
            name: {"buckets_compiled": sorted(m.compiled)}
            for name, m in self._models.items()}
        now = time.monotonic()
        details["compiling"] = [
            {"model": name, "bucket": bucket, "for_s": round(now - since, 3)}
            for (name, bucket), since in list(self._compiling.items())]
        details["status"] = "UP" if up else "DOWN"
        return details

    def close(self) -> None:
        self._models.clear()


def new_executor(config, logger, metrics, device="cuda") -> Executor:
    """Config-driven constructor (JAX ``new_executor``): mesh shape from
    ``TPU_MESH=dp:2,tp:4`` (``parallel/mesh.device_mesh``: the visible
    cards, or on the CPU as many CPU devices as the mesh needs), else no
    mesh; ``TPU_PEAK_FLOPS`` (MFU's denominator,
    0 = unknown), ``EXEC_STAGING`` (default on), ``EXEC_STAGING_DEPTH``
    (slabs a (model, bucket) ring)."""
    mesh = None
    mesh_env = config.get("TPU_MESH") if config else None
    if mesh_env:
        from gofr_tpu_torch.parallel.mesh import device_mesh
        axes = {}
        for part in str(mesh_env).split(","):
            axis, _, size = part.partition(":")
            axes[axis.strip()] = int(size)
        mesh = device_mesh(axes, resolve_device(device))
    peak_flops = config.get_float("TPU_PEAK_FLOPS", 0.0) if config else 0.0
    staging_env = config.get("EXEC_STAGING") if config else None
    staging = str(staging_env).strip().lower() not in (
        "0", "false", "off", "no") if staging_env is not None else True
    depth_env = config.get("EXEC_STAGING_DEPTH") if config else None
    staging_depth = int(depth_env) if depth_env else 2
    return Executor(logger, metrics, mesh=mesh, peak_flops=peak_flops,
                    staging=staging,
                    staging_depth=staging_depth, device=device)

"""Serving engine and its device state (counterpart of ``gofr_tpu/tpu``):
the paged KV pool and the continuous-batching generation engine, the KV
wire codec, the retry policy, the model registry, the disaggregated
cluster (in-process transport), the fleet control plane (prefix-affinity
routing, migration, drain, resumable decode, the autoscaler), the
operating-point auto-tuner, the executor (one CUDA graph a bucket) with
its dynamic batcher, and the pub/sub batch lane."""

from gofr_tpu_torch.tpu.batch_lane import BatchLane, JobError, new_batch_lane
from gofr_tpu_torch.tpu.batcher import DynamicBatcher
from gofr_tpu_torch.tpu.executor import DEFAULT_BUCKETS, Executor, new_executor

__all__ = ["BatchLane", "DEFAULT_BUCKETS", "DynamicBatcher", "Executor",
           "JobError", "new_batch_lane", "new_executor"]

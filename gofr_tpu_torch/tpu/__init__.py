"""Serving engine and its device state (counterpart of ``gofr_tpu/tpu``):
the paged KV pool and the continuous-batching generation engine, the KV
wire codec, the retry policy, the model registry, the disaggregated
cluster (in-process transport), the fleet control plane (prefix-affinity
routing, migration, drain, resumable decode, the autoscaler) and the
operating-point auto-tuner."""

"""Serving engine and its device state (counterpart of ``gofr_tpu/tpu``):
the paged KV pool and the continuous-batching generation engine, the KV
wire codec, the retry policy, the model registry and the disaggregated
cluster (in-process transport)."""

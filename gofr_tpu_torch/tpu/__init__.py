"""Serving engine and its device state (counterpart of ``gofr_tpu/tpu``):
the paged KV pool and the continuous-batching generation engine."""

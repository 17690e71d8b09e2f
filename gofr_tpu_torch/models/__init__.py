"""Models served by the port (counterpart of ``gofr_tpu/models``)."""

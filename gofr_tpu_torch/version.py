"""Framework version stamp (counterpart of ``gofr_tpu/version.py``): one
constant stamped into logs, the metrics' resource and the health
payload."""

FRAMEWORK_VERSION = "0.1.0"

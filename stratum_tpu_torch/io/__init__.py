"""Image I/O (counterpart of stratum_tpu/io)."""

"""Tracers and their host-side preparation (counterpart of stratum_tpu.ops)."""

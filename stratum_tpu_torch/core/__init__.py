"""Core rendering math (counterpart of stratum_tpu.core)."""

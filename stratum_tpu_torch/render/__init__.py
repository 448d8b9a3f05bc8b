"""Integrator, shading, lights and BSDFs (counterpart of stratum_tpu.render)."""

"""Scene schema, flattening and built-in scenes (counterpart of
stratum_tpu.scene). The node graph and host materials are shared with the
JAX package (``stratum_tpu.scene.graph`` / ``.material`` import no JAX)."""

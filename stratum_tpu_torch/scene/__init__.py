"""Scene schema, flattening and built-in scenes (counterpart of
stratum_tpu.scene). The node graph (``graph``) and host materials
(``material``) are the port's own copies of the JAX package's numpy-only
modules, so building a scene imports nothing of that package."""

"""Scene file loaders (counterpart of stratum_tpu/scene/loaders)."""

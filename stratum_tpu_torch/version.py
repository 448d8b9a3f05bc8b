"""Version constants (the reference's stratum_tpu/version.py)."""

STRATUM_VERSION_MAJOR = 0
STRATUM_VERSION_MINOR = 1

"""Multi-device rendering over a list of torch devices (counterpart of
stratum_tpu.parallel): ``mesh`` splits the pixel lanes into shards."""

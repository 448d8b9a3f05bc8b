"""ms_per_spp: the whole window's wall time, ending in a synchronise, over
the samples per pixel its calls completed."""


def read(r):
    spp = r.calls * r.units
    return r.wall_s * 1e3 / spp if spp else None

"""frame_ms: the whole window's wall time over the frames it completed
(each ends in a synchronise)."""


def read(r):
    return r.wall_s * 1e3 / r.calls if r.calls else None

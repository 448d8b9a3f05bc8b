"""live_lanes_pct.path: 100 x live lanes (t_max > 0) / lanes launched over
the closest waves of the traced stretch, from the program's counters at
its ``closest`` spans: the share of a wave's width that does work."""

from portbench import progspans


def read(r):
    recs = progspans.program_records() if r.stretch is not None else None
    return progspans.live_pct(recs) if recs else None

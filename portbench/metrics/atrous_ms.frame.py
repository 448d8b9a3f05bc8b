"""atrous_ms.frame: device milliseconds per frame of the work inside the
device extents of the program's ``atrous`` spans (one per a-trous
iteration of the SVGF filter)."""

from portbench import progspans


def read(r):
    p = progspans.placed(r)
    if p is None:
        return None
    us = progspans.device_time_in(*p, "atrous")
    return None if us is None else us / 1e3 / r.stretch.units

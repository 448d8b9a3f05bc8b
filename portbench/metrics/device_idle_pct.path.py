"""device_idle_pct.path: 100 x (1 - the union of the device's work
intervals / the traced stretch's host time), over a stretch of path
samples inside the window."""

from portbench import devtrace


def read(r):
    return None if r.stretch is None else devtrace.idle_pct(r.stretch)

"""idle_shade_ms.path: device idle milliseconds per sample per pixel
while the innermost program span open was the integrator's own work
(``camera``, ``bounce`` or ``shade``): the device waiting for the host to
issue the shading glue."""

from portbench import progspans


def read(r):
    p = progspans.placed(r)
    if p is None:
        return None
    idle = progspans.idle_by_span(*p)
    return sum(idle.get(n, 0.0) for n in progspans.SHADE) / 1e3 / r.stretch.units

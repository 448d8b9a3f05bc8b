"""idle_tracer_ms.path: device idle milliseconds per sample per pixel
while the innermost program span open was a wave (``closest``, ``shadow``)
or below it (``sort``, ``prep``, ``launch``, ``finalize``): the device
waiting for the host to issue the tracer's wrappers."""

from portbench import progspans


def read(r):
    p = progspans.placed(r)
    if p is None:
        return None
    idle = progspans.idle_by_span(*p)
    return sum(idle.get(n, 0.0) for n in progspans.TRACER) / 1e3 / r.stretch.units

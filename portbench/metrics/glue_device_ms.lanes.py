"""glue_device_ms.lanes: device time per sample per pixel of every other
kernel, copy and fill in the traced stretch (the integrator's torch glue,
the light prep, the sort and ``finalize_hit``)."""

from portbench import devtrace

NAME = "block_trace_kernel"


def read(r):
    st = r.stretch
    if st is None or not st.intervals:
        return None
    return devtrace.time_by(st, lambda n: NAME not in n) / st.units

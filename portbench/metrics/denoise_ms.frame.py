"""denoise_ms.frame: device time per frame of the work inside the
benchmark's spans around ``render.denoise.denoise``."""

from portbench import devtrace


def read(r):
    st = r.stretch
    if st is None:
        return None
    ms = devtrace.time_in_spans(st, "denoise")
    return None if not ms else ms / st.units

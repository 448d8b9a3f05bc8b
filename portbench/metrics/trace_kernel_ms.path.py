"""trace_kernel_ms.path: device time per sample per pixel of the kernels
named ``block_trace_kernel*`` (K1/K2) in the traced stretch."""

from portbench import devtrace

NAME = "block_trace_kernel"


def read(r):
    st = r.stretch
    if st is None or not any(NAME in iv.name for iv in st.intervals):
        return None
    return devtrace.time_by(st, lambda n: NAME in n) / st.units

"""host_issue_ms.path: host milliseconds per sample per pixel inside
the program's ``trace_path`` spans of the traced stretch: how long the
host takes to issue a sample, beside the device's time for it. The
profiler's cost per launch is in it: not a reading of an untraced run."""

from portbench import progspans


def read(r):
    return progspans.host_ms_per_unit(r, ("trace_path",))

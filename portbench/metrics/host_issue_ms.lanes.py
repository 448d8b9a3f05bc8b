"""host_issue_ms.lanes: host milliseconds per sample per pixel inside the
program's ``trace_path`` spans of the traced stretch, one span a
``render_path_lanes`` call of ``lanes`` samples: how long the host takes to
issue them, beside the device's time for them. The profiler's cost per
launch is in it, and the host's wait on a full launch queue."""

from portbench import progspans


def read(r):
    return progspans.host_ms_per_unit(r, ("trace_path",))

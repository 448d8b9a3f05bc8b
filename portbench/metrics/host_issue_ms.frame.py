"""host_issue_ms.frame: host milliseconds per frame inside the program's
``frame`` (``RenderSession.frame``) and ``tonemap`` spans of the traced
stretch: how long the host takes to issue a frame. The profiler's cost
per launch is in it: not a reading of an untraced run."""

from portbench import progspans


def read(r):
    return progspans.host_ms_per_unit(r, ("frame", "tonemap"))

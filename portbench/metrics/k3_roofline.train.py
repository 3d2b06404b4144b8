"""K3's launches of the traced window: their least time over their
profiler device time, %."""

from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "k3")

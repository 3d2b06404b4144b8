"""The program's ``extract.waits`` counter over its ``extract.cores``
counter (host waits for the device per core extracted), over the program
window (``harness/program.py``)."""

from portbench.harness.program import ratio


def read(run):
    return ratio(run, "extract.waits", "extract.cores")

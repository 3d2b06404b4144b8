"""The host's time in the program's ``extract.cut`` and ``extract.stage``
spans (cutting a core into patches, filling the pinned buffer) per
``extract.core``, over the program window (``harness/program.py``), ms."""

from portbench.harness.program import host_ms_per


def read(run):
    return host_ms_per(run, ("extract.cut", "extract.stage"), "extract.core")

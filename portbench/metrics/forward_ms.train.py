"""Device time of the ops launched inside the program's ``train.forward``
span (the model, its case losses and any group loss), per training window,
over the program window (``harness/program.py``), ms."""

from portbench.harness.program import device_ms_per_window


def read(run):
    return device_ms_per_window(run, "train.forward")

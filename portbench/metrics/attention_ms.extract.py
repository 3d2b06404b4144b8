"""Device time of the ops launched inside the program's ``vit.attention``
span (norm1, the qkv projection, K3, the output projection, LayerScale and
the residual add of every block) per encoder batch (``vit.batches``), over
the program window (``harness/program.py``), ms."""

from portbench.harness.encoder import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, "vit.attention")

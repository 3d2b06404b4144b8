"""Device time of the ops launched inside the program's ``vit.mlp`` span
(norm2, fc1, the GELU or the packed SwiGLU's gate, fc2, LayerScale and the
residual add of every block) per encoder batch (``vit.batches``), over the
program window (``harness/program.py``), ms."""

from portbench.harness.encoder import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, "vit.mlp")

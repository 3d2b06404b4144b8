"""Encoder rows that were padding over all rows, %: the batches from the
program's K3 calls, one a block a batch, the real rows the patches."""

from portbench.harness.readers import pad_share


def read(run):
    config = run.cell.config
    return pad_share(run, int(config["model"]["depth"]), int(config["extraction"]["batch_size"]))

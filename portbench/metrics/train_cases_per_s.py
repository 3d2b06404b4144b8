"""Training cases completed over the measured window, host clock."""

from portbench.harness.readers import rate

read = rate

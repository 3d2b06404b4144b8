"""Real patches of the cores completed over the measured window (padding
left out), host clock."""

from portbench.harness.readers import rate

read = rate

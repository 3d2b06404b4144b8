"""The share of the traced window with no op on the device, %."""

from portbench.harness.readers import idle

read = idle

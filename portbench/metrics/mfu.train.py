"""The measured window's useful FLOPs over its length at the card's peak, %."""

from portbench.harness.readers import mfu

read = mfu

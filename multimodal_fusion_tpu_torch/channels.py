"""Channel names the port's fixtures and HDF5 layer need.

A *channel* addresses one dataset inside the per-patient HDF5 file using the
``group=dataset[=dataset]`` string form, e.g. ``wsi=features`` or
``tma=cd3=features`` (same convention as the JAX package's ``channels``).
"""

from __future__ import annotations

# The eight IHC markers used throughout the stack.
TMA_MARKERS = ("cd163", "cd3", "cd56", "cd68", "cd8", "he", "mhc1", "pdl1")


def h5_path_for_channel(channel: str) -> str:
    """``wsi=features`` -> ``wsi/features``; ``tma=cd3=features`` ->
    ``tma/cd3/features``."""
    return "/".join(channel.split("="))

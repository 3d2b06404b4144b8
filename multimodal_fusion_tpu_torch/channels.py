"""Channel-spec parsing (counterpart of ``multimodal_fusion_tpu.channels``).

A *channel* addresses one dataset inside the per-patient HDF5 file using the
``group=dataset[=dataset]`` string form, e.g. ``wsi=features`` or
``tma=cd3=features``.  Users write shorthand names (``wsi``, ``tma``,
``clinical_mask``, ...) which expand to lists of full channel paths, as
the reference parser does (``downstream_survival/main.py:458-574``):
shorthands expand via a fixed mapping, strings already containing ``=``
pass through, anything else raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# The eight IHC markers used throughout the stack.
TMA_MARKERS = ("cd163", "cd3", "cd56", "cd68", "cd8", "he", "mhc1", "pdl1")

TABULAR_GROUPS = ("clinical", "pathological", "blood", "icd", "tma_cell_density")


def _build_channel_mappings() -> Dict[str, List[str]]:
    m: Dict[str, List[str]] = {
        "wsi": ["wsi=features", "wsi=reconstructed_features"],
        "tma": [f"tma={mk}=features" for mk in TMA_MARKERS],
        "tma_patches": [f"tma={mk}=patches" for mk in TMA_MARKERS],
    }
    for grp in TABULAR_GROUPS:
        m[grp] = [f"{grp}=val"]
        m[f"{grp}_ori"] = [f"{grp}=ori_val"]
        m[f"{grp}_mask"] = [f"{grp}=val", f"{grp}=mask"]
        m[f"{grp}_ori_mask"] = [f"{grp}=ori_val", f"{grp}=mask"]
    for mk in TMA_MARKERS:
        m[mk] = [f"tma={mk}=features"]
        m[f"{mk}_patches"] = [f"tma={mk}=patches"]
    return m


CHANNEL_MAPPINGS = _build_channel_mappings()


def parse_channels(channels: Sequence[str]) -> List[str]:
    """Expand shorthand channel names into full channel paths, in
    expansion order (duplicates preserved, as the reference does)."""
    if not channels:
        return []
    parsed: List[str] = []
    invalid: List[str] = []
    for ch in channels:
        if ch in CHANNEL_MAPPINGS:
            parsed.extend(CHANNEL_MAPPINGS[ch])
        elif "=" in ch:  # already a full path
            parsed.append(ch)
        else:
            invalid.append(ch)
    if invalid:
        raise ValueError(
            f"Invalid channel names: {invalid}. "
            f"Supported shorthands: {sorted(CHANNEL_MAPPINGS.keys())}"
        )
    return parsed


def h5_path_for_channel(channel: str) -> str:
    """``wsi=features`` -> ``wsi/features``; ``tma=cd3=features`` ->
    ``tma/cd3/features``."""
    return "/".join(channel.split("="))


def get_available_channels() -> Dict[str, List[str]]:
    """Grouped listing of all shorthand channel names, under the reference's
    headings (``downstream_survival/main.py:570-574``)."""
    return {
        "WSI channels": ["wsi"],
        "TMA Features channels": ["tma"] + list(TMA_MARKERS),
        "TMA Patches channels": ["tma_patches"] + [f"{mk}_patches" for mk in TMA_MARKERS],
        **{
            f"{_GROUP_HEADINGS.get(grp, grp.capitalize())} channels": [
                grp, f"{grp}_ori", f"{grp}_mask", f"{grp}_ori_mask"
            ]
            for grp in TABULAR_GROUPS
        },
    }


_GROUP_HEADINGS = {"icd": "ICD", "tma_cell_density": "TMA Cell Density"}


def channel_group(channel: str) -> str:
    """Leading group of a channel string (``tma=cd3=features`` -> ``tma``)."""
    return channel.split("=")[0]


def is_mask_channel(channel: str) -> bool:
    return channel.endswith("=mask")


def mask_channel_for(channel: str) -> str:
    """The mask channel companion for a tabular value channel."""
    return f"{channel_group(channel)}=mask"


def print_available_channels() -> None:
    """Print all shorthand channel names grouped by category (reference:
    ``downstream_survival/main.py:576-592``)."""
    for group, names in get_available_channels().items():
        print(f"{group}: {', '.join(names)}")

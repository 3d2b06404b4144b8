"""The card's peaks, from NVIDIA's data sheets (dense, without sparsity, at
the card's full power limit), keyed on ``torch.cuda.get_device_name``.

float32 is the rate outside the tensor cores: the port switches TF32 off
(``device.resolve_device``), so its float32 matmuls run in true float32.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Peaks:
    flops: Dict[str, float]  # compute dtype -> FLOP/s
    hbm: float  # bytes/s


# lowercased substring of the device name -> peaks; the first match wins
TABLE: Tuple[Tuple[str, Peaks], ...] = (
    ("h100 pcie", Peaks({"float32": 51e12, "bfloat16": 756e12}, 2.0e12)),
    ("h100", Peaks({"float32": 67e12, "bfloat16": 989e12}, 3.35e12)),
)


def peaks(kind: str) -> Peaks:
    """The row of the card ``kind``; an unlisted card raises, since its
    shares of a peak would mean nothing."""
    low = kind.lower()
    for sub, row in TABLE:
        if sub in low:
            return row
    raise KeyError(f"no peaks for the card {kind!r}")


def bound_s(ops: float, nbytes: float, row: Peaks, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations at
    the compute peak and the bytes at the HBM rate."""
    return max(ops / row.flops[dtype], nbytes / row.hbm)


def power_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()

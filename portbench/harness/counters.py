"""The program's own call counters of its attention kernels
(``ops/attention_kernel.py``): ``attention_fwd.launches`` for K3 and
``attention_bwd.launches`` for K4.  They count calls on the card; a call
may launch more than one kernel (K4's launch two)."""

from __future__ import annotations

from typing import Dict


def calls() -> Dict[str, int]:
    from multimodal_fusion_tpu_torch.ops.attention_kernel import attention_bwd, attention_fwd

    return {"k3": attention_fwd.launches, "k4": attention_bwd.launches}

"""Masked helpers for padded tensors (counterpart of
``multimodal_fusion_tpu.ops.masked``).

Only the mask value is ported so far: the attention paths replace masked
scores with this finite value, so a fully masked row degrades to a uniform
average instead of NaN.
"""

NEG_INF = -1e9

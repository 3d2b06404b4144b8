"""BaseModel contract (counterpart of ``multimodal_fusion_tpu.models.base``).

The JAX package writes every model for ONE case and batches with
``jax.vmap``; the port's models take a padded window with that leading case
axis written out:

``case['channels']``: dict RAW channel string -> tensor; bag channels
(``wsi=features``, ``tma=<marker>=features``) are [G, N_pad, D]; tabular
value and mask channels are [G, 1, D_c].  ``case['masks']``: dict
bag-channel -> bool [G, N_pad] validity masks.

A model's ``forward(case, label=None, *, generator=None, train=False)``
takes the window's labels [G] (the CLAM family's branch and gate losses
read them; MFMF ignores them) and returns the result dict with at least
``logits`` [G, C], ``probabilities`` [G, C] and ``predictions`` [G]; an
entry that is [1, ...] per case in the JAX package is [G, ...] here (a
scalar loss is [G]).  ``loss_fn(logits, labels, result)`` returns the
per-case losses [G] (each the JAX model's loss of that case alone).

A model marks the parts of its forward that are independent of each other
or run in sequence (a CLAM branch, an MFMF attention block) with
:meth:`BaseModel.segment`; under the trainer's ``remat`` each segment is
checkpointed on its own, so the backward pass holds the recomputed
activations of one segment at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.ops.losses import cross_entropy

Case = Dict[str, Any]
Result = Dict[str, torch.Tensor]


def derive_used_modalities(channels_used_in_model) -> List[str]:
    """Collapse a channel list into the modality set the trunk consumes:
    wsi=* -> 'wsi=features' (``wsi=reconstructed*`` dropped), tma=* ->
    'tma=features', '*=mask' skipped, other channels pass through; sorted
    (reference: clam_mlp.py:105-114)."""
    used = set()
    for ch in channels_used_in_model:
        if ch.startswith("wsi=reconstructed"):
            continue
        if ch.startswith("wsi="):
            used.add("wsi=features")
        elif ch.startswith("tma="):
            used.add("tma=features")
        elif ch.endswith("=mask"):
            continue
        else:
            used.add(ch)
    return sorted(used)


def process_case(case: Case, channels_used_in_model) -> Tuple[Dict[str, torch.Tensor],
                                                                Dict[str, Optional[torch.Tensor]]]:
    """Merge a window's raw channels into modality inputs (reference
    clam_mlp.py:230-255): ``wsi=features`` passes through, every ``tma=*``
    channel concatenates (with masks) along the token axis into
    ``tma=features``, ``*=mask`` channels multiply into their value
    channel, other channels pass through; other ``wsi=*`` channels are
    dropped.  Returns (inputs, masks) keyed as
    :func:`derive_used_modalities` names them."""
    chans = case["channels"]
    raw_masks = case.get("masks", {})
    inputs: Dict[str, torch.Tensor] = {}
    masks: Dict[str, Optional[torch.Tensor]] = {}
    tma_parts, tma_masks = [], []
    for ch in channels_used_in_model:
        if ch.startswith("wsi=reconstructed"):
            continue
        elif ch.startswith("wsi=features"):
            inputs["wsi=features"] = chans[ch]
            masks["wsi=features"] = raw_masks.get(ch)
        if ch.startswith("tma="):
            arr = chans[ch]
            tma_parts.append(arr)
            m = raw_masks.get(ch)
            tma_masks.append(m if m is not None else
                             torch.ones(arr.shape[:2], dtype=torch.bool, device=arr.device))
        elif ch.endswith("=mask"):
            continue
        elif not ch.startswith("wsi="):
            v = chans[ch]
            mask_ch = f"{ch.split('=')[0]}=mask"
            if mask_ch in chans:
                v = v * chans[mask_ch]
            inputs[ch] = v
    if tma_parts:
        inputs["tma=features"] = torch.cat(tma_parts, dim=1)
        masks["tma=features"] = torch.cat(tma_masks, dim=1)
    return inputs, masks


def checkpoint_replaying(fn: Callable, args, kwargs, generator: Optional[torch.Generator]):
    """``fn(*args, generator=generator, **kwargs)`` under
    ``torch.utils.checkpoint``.  The checkpoint restores the global RNG
    states, not an explicit generator, so the generator's state before the
    call is replayed for the recompute and the state after it put back (the
    recompute may stop early): the recompute draws the forward's dropout
    masks."""
    start = None if generator is None else generator.get_state()
    recompute = False

    def run(*a):
        nonlocal recompute
        if not recompute or generator is None:
            recompute = True
            return fn(*a, generator=generator, **kwargs)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, generator=generator, **kwargs)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


class BaseModel(nn.Module):
    # True only for models that implement inference-time modality dropout
    supports_drop_prob = False
    # set by the trainer from ExperimentConfig.remat: training forwards
    # checkpoint each segment (``segment``)
    remat = False

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.input_dim = config.input_dim
        self.dropout_rate = config.dropout
        self.n_classes = config.n_classes
        if config.base_loss_fn not in (None, "ce"):
            raise ValueError(f"Unsupported base loss: {config.base_loss_fn}")

    def segment(self, fn: Callable, *args, generator: Optional[torch.Generator] = None,
                train: bool = False, **kwargs):
        """``fn(*args, generator=generator, train=train, **kwargs)``; under
        ``remat`` in a training forward that records gradients, its
        activations are dropped after the forward and recomputed, with the
        same draws, when the backward pass reaches it."""
        kwargs["train"] = train
        if self.remat and train and torch.is_grad_enabled():
            return checkpoint_replaying(fn, args, kwargs, generator)
        return fn(*args, generator=generator, **kwargs)

    def base_loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per-case cross entropy [G] of logits [G, C]."""
        return cross_entropy(logits, labels, reduction="none")

    @staticmethod
    def make_result(logits, probabilities, predictions, **kwargs) -> Result:
        result = {"logits": logits, "probabilities": probabilities, "predictions": predictions}
        for k in sorted(kwargs):
            if kwargs[k] is not None:
                result[k] = kwargs[k]
        return result

    @staticmethod
    def classify(logits: torch.Tensor):
        """Probabilities and argmax predictions of logits [G, C]."""
        return torch.softmax(logits, dim=-1), torch.argmax(logits, dim=-1)

    def loss_fn(self, logits: torch.Tensor, labels: torch.Tensor, result: Result) -> torch.Tensor:
        return self.base_loss(logits, labels)

    def has_group_loss(self) -> bool:
        return False

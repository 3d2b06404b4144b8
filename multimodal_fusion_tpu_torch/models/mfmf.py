"""MFMF: Perceiver-IO-style cross-attention fusion (counterpart of
``multimodal_fusion_tpu.models.mfmf``).

Every channel is transferred to ``output_dim`` tokens, grouped into
modalities {wsi, reconstruct, tma, other}, fused through a configurable
sequence of cross-attention blocks (default other->tma, result->wsi,
reconstruct->result), mean-pooled and classified (reference
``downstream_survival/models/mfmf.py:10-148``).  The port runs a padded
window [G, N, D] at once; the attention goes through
``ops.attention.attention``, whose fused path is K3 forward and K4
backward on CUDA tensors.

The JAX MFMF subclasses ClamMLP and so also builds CLAM branches and a
fusion MLP that its forward never runs (they get no gradient).  The port
keeps ClamMLP's constructor checks but builds neither;
``mfmf_params_from_jax`` skips their parameters.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig, model_size_dims
from multimodal_fusion_tpu_torch.models.base import BaseModel, Case, Result, derive_used_modalities
from multimodal_fusion_tpu_torch.models.common import LayerNorm, dropout, torch_linear
from multimodal_fusion_tpu_torch.models.jax_params import flat_jax, port_leaf
from multimodal_fusion_tpu_torch.ops.attention import VALID_IMPLS, attention, draw_case_seeds

DEFAULT_FUSION_SEQUENCE = [
    {"q": "other", "kv": "tma"},
    {"q": "result", "kv": "wsi"},
    {"q": "reconstruct", "kv": "result"},
]


class CrossAttentionLayer(nn.Module):
    """Pre-norm multi-head cross attention + MLP, both residual, over
    q [(G,) Nq, D] and kv [(G,) Nk, D] with a key mask [(G,) Nk]."""

    def __init__(self, dim: int, num_heads: int, widening_factor: int, dropout_rate: float,
                 generator: torch.Generator):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        dev = generator.device
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_norm = LayerNorm(dim, device=dev)
        self.kv_norm = LayerNorm(dim, device=dev)
        self.q_proj = torch_linear(dim, dim, generator)
        self.k_proj = torch_linear(dim, dim, generator)
        self.v_proj = torch_linear(dim, dim, generator)
        self.out_proj = torch_linear(dim, dim, generator)
        self.mlp_norm = LayerNorm(dim, device=dev)
        self.mlp_fc1 = torch_linear(dim, widening_factor * dim, generator)
        self.mlp_fc2 = torch_linear(widening_factor * dim, dim, generator)
        self.dropout_rate = dropout_rate
        # 'auto'/'pallas' (K3 + K4 on CUDA tensors), 'pallas_interpret' (their
        # plain versions) or 'xla' (einsum form)
        self.attn_impl = "auto"

    def forward(self, q: torch.Tensor, kv: torch.Tensor, kv_mask: Optional[torch.Tensor] = None,
                *, generator: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
        h, hd = self.num_heads, self.head_dim
        qn = self.q_norm(q)
        kvn = self.kv_norm(kv)
        Q = self.q_proj(qn).reshape(*q.shape[:-1], h, hd)
        K = self.k_proj(kvn).reshape(*kv.shape[:-1], h, hd)
        V = self.v_proj(kvn).reshape(*kv.shape[:-1], h, hd)
        seed = None
        if train and self.dropout_rate > 0.0 and generator is not None:
            # the fused kernels hash one seed per case, as the JAX kernel
            # under the trainer's vmap over per-case keys; 'xla' draws
            # Bernoulli masks from the generator
            seed = generator if self.attn_impl == "xla" or q.dim() == 2 else \
                draw_case_seeds(generator, q.shape[0])
        out = attention(Q, K, V, kv_mask, impl=self.attn_impl, dropout_rate=self.dropout_rate,
                        seed=seed, train=train).reshape(q.shape)
        x = q + self.out_proj(out)
        hid = self.mlp_fc2(F.gelu(self.mlp_fc1(self.mlp_norm(x)), approximate="none"))
        hid = dropout(hid, self.dropout_rate, generator, train)
        return x + hid


class MFMF(BaseModel):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config)
        # ClamMLP's constructor checks (clam_mlp.py:54-98)
        self.size = model_size_dims(config.input_dim, config.model_size)
        if config.inst_loss_fn not in (None, "ce"):
            raise ValueError(f"Unsupported instance loss: {config.inst_loss_fn}")
        self.output_dim = config.get("output_dim", 1024)
        self.channels_used_in_model = list(config.channels_used_in_model)
        self.used_modality = derive_used_modalities(self.channels_used_in_model)
        hg = [ch for ch in self.used_modality if ch.startswith("hypergraph=")]
        if hg:
            raise ValueError(f"MFMF does not consume hypergraph channels {hg}; use "
                             "model_type=cust_omics for hypergraph inputs")

        self.fusion_blocks_sequence: List[Dict[str, str]] = (
            config.get("fusion_blocks_sequence") or DEFAULT_FUSION_SEQUENCE
        )
        num_heads = config.get("attention_num_heads", 8)
        widening = config.get("attention_widening_factor", 1)
        attn_dropout = config.get("attention_dropout", 0.0)
        self.attention_blocks = nn.ModuleDict({
            f"{b['q']}:{b['kv']}": CrossAttentionLayer(self.output_dim, num_heads, widening,
                                                       attn_dropout, generator)
            for b in self.fusion_blocks_sequence
        })
        impl = config.get("attention_impl", "auto")
        if impl not in VALID_IMPLS:
            raise ValueError(f"unknown attention_impl {impl!r}")
        for blk in self.attention_blocks.values():
            blk.attn_impl = impl
        transfer = {}
        for ch in self.channels_used_in_model:
            if ch.endswith("=mask"):
                continue
            if ch.startswith("wsi=") or ch.startswith("tma="):
                in_dim = self.input_dim
            else:
                in_dim = config.channel_input_dims.get(ch)
                if in_dim is None:
                    raise ValueError(
                        f"channel_input_dims missing entry for tabular channel {ch!r}; "
                        "static shapes are required (no lazy layer creation)"
                    )
            transfer[ch] = torch_linear(in_dim, self.output_dim, generator)
        self.mfmf_transfer = nn.ModuleDict(transfer)
        self.head = torch_linear(self.output_dim, self.n_classes, generator)

    def _collect_modalities(self, case: Case):
        chans = case["channels"]
        raw_masks = case.get("masks", {})
        tma_feats, tma_masks, other_feats = [], [], []
        modality, modality_mask = {}, {}
        for ch in self.channels_used_in_model:
            if ch.endswith("=mask") or ch not in chans:
                continue
            feat = chans[ch]
            if not ch.startswith("wsi=") and not ch.startswith("tma="):
                mch = f"{ch.split('=')[0]}=mask"
                if mch in chans:
                    feat = feat * chans[mch]
            feat = self.mfmf_transfer[ch](feat)
            if ch.startswith("tma="):
                tma_feats.append(feat)
                m = raw_masks.get(ch)
                tma_masks.append(m if m is not None else
                                 torch.ones(feat.shape[:-1], dtype=torch.bool, device=feat.device))
            elif ch == "wsi=features":
                modality["wsi"] = feat
                modality_mask["wsi"] = raw_masks.get(ch)
            elif ch == "wsi=reconstructed_features":
                modality["reconstruct"] = feat
                modality_mask["reconstruct"] = raw_masks.get(ch)
            else:
                other_feats.append(feat)
        if tma_feats:
            modality["tma"] = torch.cat(tma_feats, dim=-2)
            modality_mask["tma"] = torch.cat(tma_masks, dim=-1)
        if other_feats:
            modality["other"] = torch.cat(other_feats, dim=-2)
            modality_mask["other"] = None
        return modality, modality_mask

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        modality, modality_mask = self._collect_modalities(case)
        result_mask = None
        for blk in self.fusion_blocks_sequence:
            out = self.segment(
                self.attention_blocks[f"{blk['q']}:{blk['kv']}"],
                modality[blk["q"]], modality[blk["kv"]], modality_mask.get(blk["kv"]),
                generator=generator, train=train,
            )
            modality["result"] = out
            # the result tokens are the q side's: their validity follows it
            result_mask = modality_mask.get(blk["q"])
            modality_mask["result"] = result_mask
        res = modality["result"]  # [G, N, D]
        if result_mask is not None:
            w = result_mask.to(res.dtype)[..., None]
            fused = (res * w).sum(dim=-2) / w.sum(dim=(-2, -1)).clamp_min(1.0)[..., None]
        else:
            fused = res.mean(dim=-2)
        logits = self.head(fused)  # [G, C]
        probs, preds = self.classify(logits)
        return self.make_result(logits, probs, preds, Y_prob=probs, Y_hat=preds)


def mfmf_params_from_jax(state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's MFMF state dict from the JAX MFMF's parameters, given as
    a nested pure dict (``nnx.to_pure_dict(nnx.state(model, nnx.Param))``)
    or flat ``{path: array}`` with tuple or dotted-string paths.  Linear
    ``kernel`` [in, out] becomes ``weight`` [out, in]; LayerNorm ``scale``
    becomes ``weight``.  The JAX model's CLAM branches, tabular
    ``transfer_layers`` and ``fusion_fc*`` (built by its ClamMLP base, never
    run by MFMF) are skipped.  Load with ``model.load_state_dict``."""
    return dict(port_leaf(".".join(parts), arr) for parts, arr in flat_jax(state).items()
                if parts[0] in ("attention_blocks", "mfmf_transfer", "head"))

"""CustOmics, hypergraph-based multimodal fusion (counterpart of
``multimodal_fusion_tpu.models.hypergraph_fusion``).

Reference: ``downstream_survival/models/cust_omics.py:11-431``: a
HypergraphConv stack and GlobalAttention pooling over the WSI (+ TMA) nodes,
then an MoE gate fusing that token with the tabular tokens.  As in the JAX
package, the hypergraph is a dense padded incidence H [G, N, E] with node
masks, so the convolution

    X' = D^-1 H W B^-1 H^T X Theta       (torch_geometric HypergraphConv)

is two batched products over the window's leading case axis, and the
``hypergraph=edge_weights`` channel, where present, is the convolution's W
(the JAX package's documented deviation from the reference, which drops
its own weights).

Channels read (``data.multimodal`` and ``data.batching`` make them from the
``hypergraph/`` arrays of the build): ``hypergraph=wsi_super_features``
[G, Ns, D] and ``hypergraph=tma_features`` [G, Nt, D] with their masks,
``hypergraph=incidence`` [G, Ns + Nt, E], ``hypergraph=edge_weights``
[G, E].  Without them the raw ``wsi``/``tma`` bags are the nodes, with one
hyperedge over all of a case's valid nodes (reference cust_omics.py:190-227).

The reference leaves the model out of its factory and the JAX package has
no ``state_dict`` map for it, so the parameter names follow
torch_geometric where it has them: ``hypergraph_net.first``,
``hypergraph_net.bn.{weight,bias}``, ``hypergraph_net.convs.<i>.lin`` and
``hypergraph_net.convs.<i>.bias``, ``hypergraph_net.out_layer``,
``hypergraph_net.pool.gate_nn.{0,2}``; then ``moe_gate``, ``head``,
``hypergraph_transfer`` and ``hypergraph_tma_transfer``, beside the ClamMLP
trunk's names, which it inherits unused as the JAX model does.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.config import ModelConfig
from multimodal_fusion_tpu_torch.models.base import Case, Result, process_case
from multimodal_fusion_tpu_torch.models.clam_mlp import CLAM_CHANNELS, ClamMLP
from multimodal_fusion_tpu_torch.models.common import dropout, torch_linear, torch_linear_no_bias
from multimodal_fusion_tpu_torch.ops.masked import NEG_INF


class MaskedBatchNorm(nn.Module):
    """Normalisation over each case's valid nodes with a learnable scale
    and bias, in training and evaluation alike: no running statistics (the
    JAX package's documented deviation from torch's BatchNorm1d, whose eval
    mode would read statistics gathered over other cases)."""

    def __init__(self, dim: int, device=None, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [G, N, H], mask [G, N] (None: every node valid)."""
        if mask is None:
            mean = x.mean(dim=1, keepdim=True)
            var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        else:
            w = mask.to(x.dtype)[..., None]
            n = w.sum(dim=1, keepdim=True).clamp_min(1.0)
            mean = (x * w).sum(dim=1, keepdim=True) / n
            var = (((x - mean) ** 2) * w).sum(dim=1, keepdim=True) / n
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class HypergraphConv(nn.Module):
    """Dense HypergraphConv (torch_geometric semantics, no attention):
    ``lin`` without bias, then the two normalised incidence products, then
    ``bias``.  Degrees are clamped at 1e-12, so empty hyperedges and padded
    nodes give zeros, not NaN."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.lin = torch_linear_no_bias(in_dim, out_dim, generator)
        self.bias = nn.Parameter(torch.zeros(out_dim, device=generator.device))

    def forward(self, x: torch.Tensor, incidence: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [G, N, in], incidence [G, N, E] (0/1), edge_weight [G, E]."""
        w = edge_weight if edge_weight is not None else incidence.new_ones(
            (incidence.shape[0], incidence.shape[2]))
        xl = self.lin(x)  # [G, N, out]
        B = incidence.sum(dim=1)  # hyperedge degree [G, E]
        D = torch.bmm(incidence, w[..., None])[..., 0]  # node degree [G, N]
        edge_feat = torch.bmm(incidence.transpose(1, 2), xl) / B.clamp_min(1e-12)[..., None]
        out = torch.bmm(incidence * w[:, None, :], edge_feat) / D.clamp_min(1e-12)[..., None]
        return out + self.bias


class GlobalAttentionPool(nn.Module):
    """torch_geometric GlobalAttention with a Tanh gate MLP (reference
    cust_omics.py:68-75): gate scores of masked nodes are -1e9 before the
    softmax over the nodes and 0 after it; out = sum gate * x."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.gate_nn = nn.ModuleDict({"0": torch_linear(dim, dim // 2, generator),
                                      "2": torch_linear(dim // 2, 1, generator)})

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [G, N, D] -> [G, D]."""
        gate = self.gate_nn["2"](torch.tanh(self.gate_nn["0"](x)))[..., 0]  # [G, N]
        if mask is not None:
            gate = torch.where(mask, gate, NEG_INF)
        gate = torch.softmax(gate, dim=-1)
        if mask is not None:
            gate = torch.where(mask, gate, 0.0)
        return torch.bmm(gate[:, None, :], x)[:, 0]


class HypergraphNetwork(nn.Module):
    """Linear -> BatchNorm -> ReLU -> HypergraphConv stack -> Linear ->
    attention pool (reference cust_omics.py:11-110), dropout after the
    first block and after each convolution."""

    def __init__(self, input_dim: int, hidden_dims: List[int], output_dim: int,
                 dropout_rate: float, generator: torch.Generator):
        super().__init__()
        self.first = torch_linear(input_dim, hidden_dims[0], generator)
        self.bn = MaskedBatchNorm(hidden_dims[0], device=generator.device)
        self.convs = nn.ModuleList([HypergraphConv(hidden_dims[i - 1], hidden_dims[i], generator)
                                    for i in range(1, len(hidden_dims))])
        self.out_layer = torch_linear(hidden_dims[-1], output_dim, generator)
        self.pool = GlobalAttentionPool(output_dim, generator)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, incidence: torch.Tensor, node_mask: Optional[torch.Tensor],
                edge_weight: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
        """Nodes x [G, N, input_dim] -> one token [G, output_dim] a case."""
        h = F.relu(self.bn(self.first(x), node_mask))
        h = dropout(h, self.dropout_rate, generator, train)
        for conv in self.convs:
            h = dropout(conv(h, incidence, edge_weight), self.dropout_rate, generator, train)
        return self.pool(self.out_layer(h), node_mask)


class CustOmics(ClamMLP):
    consumes_hypergraph = True  # the one trunk that does (see ClamMLP)

    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__(config, generator)
        self.modality_order = sorted(self.used_modality)
        hidden_dims = config.get("hypergraph_hidden_dims", [256, 256])
        self.hypergraph_net = HypergraphNetwork(self.output_dim, hidden_dims, self.output_dim,
                                                config.get("hypergraph_dropout", 0.2), generator)
        self.other_modalities = [m for m in self.modality_order
                                 if m not in CLAM_CHANNELS and not m.startswith("hypergraph=")]
        self.max_num_tokens = 1 + len(self.other_modalities)
        self.moe_gate = torch_linear(self.output_dim, self.max_num_tokens, generator)
        self.head = torch_linear(self.output_dim, self.n_classes, generator)
        # each node part transfers on its own before the concatenation
        # (reference cust_omics.py:283-303): the two may be stored at
        # different widths; the TMA width defaults to the WSI one
        hg_dim = config.get("hypergraph_node_dim", config.input_dim)
        tma_dim = config.get("hypergraph_tma_node_dim", hg_dim)
        self.hypergraph_transfer = (torch_linear(hg_dim, self.output_dim, generator)
                                    if hg_dim != self.output_dim else None)
        self.hypergraph_tma_transfer = (torch_linear(tma_dim, self.output_dim, generator)
                                        if tma_dim != self.output_dim else None)

    @staticmethod
    def _mask_or_ones(raw_masks, ch, arr):
        m = raw_masks.get(ch)
        return m if m is not None else torch.ones(arr.shape[:2], dtype=torch.bool, device=arr.device)

    def _image_nodes(self, case: Case, inputs, in_masks):
        """(nodes [G, N, output_dim], node mask [G, N], incidence [G, N, E],
        edge weights [G, E] or None): the build's hypergraph channels when
        the window has them, else the raw wsi/tma bags with one hyperedge
        over all valid nodes; all None without image channels."""
        chans = case["channels"]
        raw_masks = case.get("masks", {})
        if "hypergraph=wsi_super_features" in chans and "hypergraph=incidence" in chans:
            w = chans["hypergraph=wsi_super_features"]
            parts = [w if self.hypergraph_transfer is None else self.hypergraph_transfer(w)]
            masks = [self._mask_or_ones(raw_masks, "hypergraph=wsi_super_features", w)]
            if "hypergraph=tma_features" in chans:
                t = chans["hypergraph=tma_features"]
                parts.append(t if self.hypergraph_tma_transfer is None
                             else self.hypergraph_tma_transfer(t))
                masks.append(self._mask_or_ones(raw_masks, "hypergraph=tma_features", t))
            return (torch.cat(parts, dim=1), torch.cat(masks, dim=1), chans["hypergraph=incidence"],
                    chans.get("hypergraph=edge_weights"))
        parts, masks = [], []
        for ch in CLAM_CHANNELS[::-1]:  # wsi first, then tma (reference order)
            if ch in inputs:
                parts.append(inputs[ch])
                masks.append(self._mask_or_ones(in_masks, ch, inputs[ch]))
        if not parts:
            return None, None, None, None
        nodes = torch.cat(parts, dim=1)
        node_mask = torch.cat(masks, dim=1)
        if self.hypergraph_transfer is not None:
            nodes = self.hypergraph_transfer(nodes)
        valid = node_mask.to(nodes.dtype)
        return nodes, node_mask, valid[:, :, None] * valid[:, None, :], None

    def forward(self, case: Case, label: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None, train: bool = False) -> Result:
        inputs, in_masks = process_case(case, self.channels_used_in_model)
        nodes, node_mask, incidence, edge_w = self._image_nodes(case, inputs, in_masks)
        tokens = []
        if nodes is not None:
            tokens.append(self.segment(self.hypergraph_net, nodes, incidence, node_mask, edge_w,
                                       generator=generator, train=train))
        for ch in self.other_modalities:
            tokens.append(self.transfer_layer[ch](inputs[ch]).squeeze(-2))
        if not tokens:
            # a zero fused token (reference cust_omics.py:392-395)
            G = next(iter(case["channels"].values())).shape[0]
            tokens.append(torch.zeros((G, self.output_dim), device=self.head.weight.device))
        tokens_tensor = torch.stack(tokens, dim=1)  # [G, T, D]
        T = tokens_tensor.shape[1]
        weights = torch.softmax(self.moe_gate(tokens_tensor.mean(dim=1)), dim=-1)[:, :T]
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-8)
        logits = self.head(torch.bmm(weights[:, None, :], tokens_tensor)[:, 0])
        probs, preds = self.classify(logits)
        return self.make_result(logits, probs, preds, Y_prob=probs, Y_hat=preds, moe_weights=weights)

    def loss_fn(self, logits, labels, result):
        return self.base_loss(logits, labels)

"""Padding/bucketing raw numpy cases into window batches (counterpart of
``multimodal_fusion_tpu.data.batching``, numpy only).

Ragged patch bags are padded to a small ladder of bucket sizes
(``ops.masked.bucket_size``) and the cases of one gradient-accumulation
window share a single bucket, so the window runs as one batched step with
a leading case axis (the JAX package's vmapped window step, replacing the
reference's per-case loop, ``downstream_survival/trainer.py:780-813``).
The port keeps the JAX package's buckets, so both see the same shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_fusion_tpu_torch.ops.masked import bucket_size

Case = Dict  # {'channels': {...}, 'masks': {...}, 'label': int}


def is_bag_channel(channel: str) -> bool:
    """Bag channels have a variable instance axis (wsi/tma features and
    hypergraph node sets); tabular channels are fixed [1, D].  ``aligned_<ch>``
    entries (the JAX package's dataset-level alignment) share their base
    channel's instance axis and must pad with it."""
    if channel.startswith("aligned_"):
        channel = channel[len("aligned_"):]
    return (
        channel.startswith("wsi=")
        or channel.startswith("tma=")
        or channel
        in (
            "hypergraph=wsi_super_features",
            "hypergraph=tma_features",
            "hypergraph=group_labels",
        )
    )


def edge_index_to_incidence(
    edge_index: np.ndarray, n_nodes: int, n_hyperedges: int
) -> np.ndarray:
    """Dense incidence H[i, e] = 1 for pairs (i, e) in edge_index [2, P].

    Replaces torch_geometric's sparse (node, hyperedge) pair list; the node
    counts involved are at most a few hundred."""
    H = np.zeros((n_nodes, n_hyperedges), np.float32)
    if edge_index.size:
        src = np.clip(edge_index[0], 0, n_nodes - 1)
        dst = np.clip(edge_index[1], 0, n_hyperedges - 1)
        H[src, dst] = 1.0
    return H


def pad_case(
    raw: Dict[str, np.ndarray],
    label: int,
    bag_sizes: Dict[str, int],
) -> Case:
    """Pad every bag channel of a raw case up to ``bag_sizes[channel]``.

    ``hypergraph=edge_index`` is converted to a dense incidence matrix keyed
    ``hypergraph=incidence`` sized [total_nodes, total_nodes] (hyperedge ids
    are node ids in the reference's clique-expanded edge list)."""
    channels: Dict[str, np.ndarray] = {}
    masks: Dict[str, np.ndarray] = {}
    n_super = raw.get("hypergraph=wsi_super_features", np.zeros((0, 1))).shape[0]
    n_tma_hg = raw.get("hypergraph=tma_features", np.zeros((0, 1))).shape[0]
    for ch, arr in raw.items():
        if ch in ("hypergraph=edge_index", "hypergraph=edge_weights"):
            continue  # handled below (mapped into the padded hyperedge space)
        if is_bag_channel(ch):
            n = arr.shape[0]
            n_pad = bag_sizes[ch]
            # integer bags (hypergraph=group_labels) keep their dtype and pad
            # with -1 (an impossible group id); float bags pad with 0 + mask
            if arr.dtype.kind in "iu":
                out = np.full((n_pad,) + arr.shape[1:], -1, arr.dtype)
            else:
                out = np.zeros((n_pad,) + arr.shape[1:], np.float32)
            out[:n] = arr
            channels[ch] = out
            m = np.zeros((n_pad,), bool)
            m[:n] = True
            masks[ch] = m
        else:
            channels[ch] = arr.astype(np.float32)
    if "hypergraph=edge_index" in raw:
        ns_pad = bag_sizes.get("hypergraph=wsi_super_features", n_super)
        nt_pad = bag_sizes.get("hypergraph=tma_features", n_tma_hg)
        total_pad = ns_pad + nt_pad
        ei = raw["hypergraph=edge_index"]
        # remap tma node ids (which follow the unpadded super block) into the
        # padded layout
        if nt_pad > 0 and ei.size:
            ei = ei.copy()
            for row in range(2):
                sel = ei[row] >= n_super
                ei[row][sel] = ei[row][sel] - n_super + ns_pad
        channels["hypergraph=incidence"] = edge_index_to_incidence(ei, total_pad, total_pad)
        if "hypergraph=edge_weights" in raw:
            # h5 weights are per PAIR [(node, hyperedge)]; HypergraphConv's W
            # is per HYPEREDGE [E_pad = total_pad] — scatter-mean the pair
            # weights onto their hyperedge id, 1.0 for hyperedges with no
            # pairs (models/hypergraph_fusion.py:29, review finding: the raw
            # ragged [E_pairs] vector broke both the conv shape contract and
            # window stacking)
            w_pairs = np.asarray(raw["hypergraph=edge_weights"], np.float32).reshape(-1)
            w_edge = np.ones((total_pad,), np.float32)
            if ei.size and w_pairs.size == ei.shape[1]:
                dst = np.clip(ei[1], 0, total_pad - 1)
                sums = np.zeros((total_pad,), np.float32)
                cnts = np.zeros((total_pad,), np.float32)
                np.add.at(sums, dst, w_pairs)
                np.add.at(cnts, dst, 1.0)
                nz = cnts > 0
                w_edge[nz] = sums[nz] / cnts[nz]
            channels["hypergraph=edge_weights"] = w_edge
    return {"channels": channels, "masks": masks, "label": np.int32(label)}


def window_bag_sizes(
    raws: Sequence[Dict[str, np.ndarray]],
    buckets: Optional[Sequence[int]] = None,
) -> Dict[str, int]:
    """Shared bucketed bag size per channel across a window of raw cases."""
    sizes: Dict[str, int] = {}
    for raw in raws:
        for ch, arr in raw.items():
            if ch != "hypergraph=edge_index" and is_bag_channel(ch):
                sizes[ch] = max(sizes.get(ch, 0), arr.shape[0])
    if buckets is not None:
        return {ch: bucket_size(n, tuple(buckets)) for ch, n in sizes.items()}
    return {ch: bucket_size(n) for ch, n in sizes.items()}


def stack_window(cases: List[Case]):
    """Stack same-shape cases (nested dicts of arrays) into a leading
    window axis."""
    first = cases[0]
    if isinstance(first, dict):
        return {k: stack_window([c[k] for c in cases]) for k in first}
    return np.stack(cases)


def make_window(
    raws: Sequence[Dict[str, np.ndarray]],
    labels: Sequence[int],
    buckets: Optional[Sequence[int]] = None,
) -> Case:
    """Raw cases -> one stacked, padded window batch."""
    sizes = window_bag_sizes(raws, buckets)
    padded = [pad_case(r, l, sizes) for r, l in zip(raws, labels)]
    return stack_window(padded)

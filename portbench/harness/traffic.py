"""The generator: inputs made from ``--seed`` and a traffic file's parameters.

Two kinds of input, as the traffic file's ``generator`` names them:

- ``cohort``: survival cases held on the device as one padded table per
  channel, in the layout of the trainer's ``device_data`` path
  (``SurvivalTrainer._device_tables``): a bag channel [R, pad, D] with its
  bool mask [R, pad], a tabular channel [R, 1, d], labels int64 [R].  The
  WSI bag and its reconstruction share a length; every TMA marker has its
  own.  The sizes are spread evenly over their ranges, the same multiset
  for every seed, which only orders them: the work does not depend on it.
- ``cores``: uint8 TMA core images [E, E, 3] of the traffic's edges (a
  blocky colour field plus noise), ``pool`` of each edge, drawn on the
  device in set-up and copied to host memory, and the order in which the
  window feeds them: cycles over every edge, each cycle in an order of its
  own drawn from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from portbench.harness.draw import derive, generator


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over [lo, hi]: each of the
    hi - lo + 1 values about equally often."""
    i = np.arange(n)
    return (lo + np.floor((hi - lo + 1) * (i + 0.5) / n)).astype(np.int64)


@dataclass
class Cohort:
    tables: Dict  # {"channels": {...}, "masks": {...}, "label": [R]}
    lengths: Dict[str, np.ndarray]  # bag channel -> valid rows of each case [R]
    labels: np.ndarray  # [R]


def cohort(traffic: Dict, model: Dict, seed: int, device, pad: Callable[[int], int]) -> Cohort:
    """The cohort of ``traffic`` for the channels of ``model`` (a
    configuration's ``model`` section); ``pad`` maps a channel's longest bag
    to its padded length (the program's bucket ladder)."""
    rng = np.random.default_rng(derive(seed, "cohort-sizes"))
    g = generator(seed, "cohort-values", device)
    r = int(traffic["cases"])
    dim = int(model["input_dim"])
    channels = list(model["channels_used_in_model"])
    wsi_lo, wsi_hi = traffic["wsi_patches"]
    tma_lo, tma_hi = traffic["tma_patches"]
    tma = [ch for ch in channels if ch.startswith("tma=")]

    n_wsi = rng.permutation(spread(wsi_lo, wsi_hi, r))
    n_tma = rng.permutation(spread(tma_lo, tma_hi, r * len(tma))).reshape(r, len(tma))
    labels = rng.permutation(np.arange(r) % int(model["n_classes"]))
    lengths = {ch: n_wsi for ch in channels if ch.startswith("wsi=")}
    lengths.update({ch: n_tma[:, i] for i, ch in enumerate(tma)})

    def bag(n: np.ndarray):
        width = pad(int(n.max()))
        mask = torch.arange(width, device=device)[None, :] < torch.as_tensor(n, device=device)[:, None]
        x = torch.randn((r, width, dim), generator=g, device=device)
        return x.mul_(mask.unsqueeze(-1)), mask

    values, masks = {}, {}
    for ch in channels:
        if ch == "wsi=reconstructed_features":
            continue  # below, from wsi=features
        if ch in lengths:
            values[ch], masks[ch] = bag(lengths[ch])
        else:
            values[ch] = torch.randn((r, 1, int(model["channel_input_dims"][ch])), generator=g,
                                     device=device)
    if "wsi=reconstructed_features" in channels:
        # the VAE's reconstruction of the bag: the bag plus a little noise
        base, mask = values["wsi=features"], masks["wsi=features"]
        noise = torch.randn(base.shape, generator=g, device=device)
        noise.mul_(float(traffic["reconstruction_noise"])).mul_(mask.unsqueeze(-1)).add_(base)
        values["wsi=reconstructed_features"], masks["wsi=reconstructed_features"] = noise, mask
    tables = {
        "channels": {ch: values[ch] for ch in channels},
        "masks": {ch: masks[ch] for ch in channels if ch in masks},
        "label": torch.as_tensor(labels, dtype=torch.int64, device=device),
    }
    return Cohort(tables=tables, lengths=lengths, labels=labels)


def epochs(n_cases: int, window: int, seed: int, tag: str) -> Iterator[np.ndarray]:
    """Row windows of ``window`` cases over epochs of all ``n_cases`` rows,
    each epoch in an order of its own drawn from the seed; the last window
    of an epoch may be shorter."""
    rng = np.random.default_rng(derive(seed, tag))
    while True:
        order = rng.permutation(n_cases)
        for start in range(0, n_cases, window):
            yield order[start:start + window]


def core_image(edge: int, traffic: Dict, g: torch.Generator, device) -> np.ndarray:
    """A uint8 [edge, edge, 3] core: colour levels over square blocks plus
    Gaussian noise, clipped to 0..255."""
    block = int(traffic["block"])
    lo, hi = traffic["levels"]
    n = edge // block + 1
    base = torch.randint(int(lo), int(hi), (n, n, 3), generator=g, device=device).float()
    img = base.repeat_interleave(block, 0).repeat_interleave(block, 1)[:edge, :edge]
    img = img + float(traffic["noise"]) * torch.randn((edge, edge, 3), generator=g, device=device)
    return img.clamp_(0, 255).to(torch.uint8).cpu().numpy()


def cores(traffic: Dict, seed: int, device) -> Dict[int, List[np.ndarray]]:
    """``pool`` images of every edge of ``traffic``."""
    g = generator(seed, "cores", device)
    return {int(e): [core_image(int(e), traffic, g, device) for _ in range(int(traffic["pool"]))]
            for e in traffic["edges"]}


def core_cycles(traffic: Dict, seed: int) -> Iterator[List[Tuple[int, int]]]:
    """The cores the window feeds, a cycle at a time: cycle c holds every
    edge once, as (edge, pool index c % pool), in an order drawn from the
    seed.  Every cycle is the same work, so where a window ends does not
    change its mix."""
    rng = np.random.default_rng(derive(seed, "core-order"))
    edges = [int(e) for e in traffic["edges"]]
    cycle = 0
    while True:
        yield [(edges[i], cycle % int(traffic["pool"])) for i in rng.permutation(len(edges))]
        cycle += 1


def patches_of(edge: int, patch: int, stride: int) -> int:
    """Patches the sliding window cuts from a square core (a core smaller
    than a patch is resized whole to one)."""
    if edge < patch:
        return 1
    per_axis = (edge - patch) // stride + 1
    return per_axis * per_axis

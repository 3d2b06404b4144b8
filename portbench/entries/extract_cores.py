"""TMA feature extraction as the extraction CLI runs it: each step hands a
stream of decoded cores, as (key, image) pairs, to one
``extract_marker_features`` call with the extractor that
``make_feature_extractor`` builds over the ViT.  How the program batches
the stream's patches is its own: today each core is cut on the host, its
uint8 windows uploaded, /255, the bicubic resize and the normalisation run
on the device, the encoder in fixed batches with the last one padded, and
one wait for the device a core.

The cores are drawn in set-up; a step streams the traffic's
``cycles_per_call`` cycles of them (a cycle: every edge of the traffic
once, in the seed's order).  The warm-up streams the
smallest and the largest core, which build every kernel and buffer the
path uses.  Every core's features are kept, and the check holds a sample
of the window's cores, drawn from the seed, against the plain reference."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.entries._plant import patch
from portbench.harness import compare, draw, manifest, traffic


class Entry:
    unit = "patches"

    def __init__(self, cell, seed: int, device: torch.device, spans):
        from multimodal_fusion_tpu_torch.data import tma_extraction
        from multimodal_fusion_tpu_torch.models.vit import ViT

        self.tma_extraction, self.spans, self.device = tma_extraction, spans, device
        self.config, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.reference = manifest.reference(cell.config["reference"])
        m, ext = cell.config["model"], cell.config["extraction"]
        self.ext = ext
        model = ViT(img_size=m["img_size"], patch_size=m["patch_size"], embed_dim=m["embed_dim"],
                    depth=m["depth"], num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                    init_values=m["init_values"],
                    generator=torch.Generator(device=device).manual_seed(draw.derive(seed, "init")))
        model.load_state_dict(draw.weights(self.reference.weight_spec(cell.config), seed, device))
        self.extractor = tma_extraction.make_feature_extractor(
            model, int(ext["batch_size"]), compute_dtype=ext["compute_dtype"], device=device)
        self.images = traffic.cores(cell.traffic, seed, device)
        self.cycles = traffic.core_cycles(cell.traffic, seed)
        self.outputs: List = []  # (edge, pool index, features) of each core of the window
        self.failed = 0
        edges = sorted(self.images)
        self._extract([(e, 0) for e in dict.fromkeys((edges[0], edges[-1]))])  # the warm-up

    def _extract(self, cores: List) -> Dict[str, np.ndarray]:
        """The features of ``cores`` ((edge, pool index) pairs) from one
        call, keyed by each core's place in ``cores``."""
        ext = self.ext
        stream = ((str(i), self.images[edge][index]) for i, (edge, index) in enumerate(cores))
        with self.spans("extract_marker_features"):
            return self.tma_extraction.extract_marker_features(
                stream, self.extractor, int(ext["patch_size"]), int(ext["stride"]),
                ext["white_threshold"], ext["min_content_ratio"])

    def step(self):
        """The cores of one call; its record is each core's patch count."""
        done, patches = 0, []
        cores = [c for _ in range(int(self.traffic["cycles_per_call"])) for c in next(self.cycles)]
        out = self._extract(cores)
        for i, (edge, index) in enumerate(cores):
            n = traffic.patches_of(edge, int(self.ext["patch_size"]), int(self.ext["stride"]))
            feats = out.get(str(i))
            patches.append(n)
            if feats is None or feats.shape != (n, int(self.config["model"]["embed_dim"])):
                self.failed += n
                continue
            self.outputs.append((edge, index, feats))
            done += n
        return done, {"patches": patches}

    def release(self) -> None:
        self.extractor = None

    def check(self) -> Dict[str, float]:
        """The largest relative L2 gap of a window's feature row from the
        reference's, over cores drawn from the seed until they hold
        ``traffic.check_patches`` windows."""
        if not self.outputs:
            return {}
        rng = np.random.default_rng(draw.derive(self.seed, "check"))
        chosen = sample(self.outputs, [len(f) for _, _, f in self.outputs],
                        int(self.traffic["check_patches"]), rng)
        weights = draw.weights(self.reference.weight_spec(self.config), self.seed, self.device)
        ref = self.reference.extract(weights, self.config,
                                     [self.images[e][i] for e, i, _ in chosen], self.device)
        return {"feature_gap": max(compare.row_gap(f, r.cpu().numpy())
                                   for (_, _, f), r in zip(chosen, ref))}


def sample(items: List, sizes: List[int], total: int, rng) -> List:
    """Items in an order drawn from ``rng`` until their sizes reach ``total``."""
    chosen, n = [], 0
    for i in rng.permutation(len(items)):
        chosen.append(items[i])
        n += sizes[i]
        if n >= total:
            break
    return chosen


def control(cell, seed: int, device) -> Dict[str, float]:
    """The readings of the reference in TF32 put in the program's place, on
    cores of the window's order drawn as a run's check draws them."""
    config, ext = cell.config, cell.config["extraction"]
    reference = manifest.reference(config["reference"])
    images = traffic.cores(cell.traffic, seed, device)
    cycles = traffic.core_cycles(cell.traffic, seed)
    cores = [core for _ in range(4) for core in next(cycles)]
    sizes = [traffic.patches_of(e, int(ext["patch_size"]), int(ext["stride"])) for e, _ in cores]
    chosen = sample(cores, sizes, int(cell.traffic["check_patches"]),
                    np.random.default_rng(draw.derive(seed, "check")))
    weights = draw.weights(reference.weight_spec(config), seed, device)
    picked = [images[e][i] for e, i in chosen]
    ref = reference.extract(weights, config, picked, device)
    low = reference.extract(weights, config, picked, device, tf32=True)
    return {"feature_gap": max(compare.row_gap(a.cpu().numpy(), b.cpu().numpy())
                               for a, b in zip(low, ref))}


def _wrap_extractor(change):
    """Every extractor that ``make_feature_extractor`` builds hands its
    features through ``change`` (patches, features) -> features."""
    from multimodal_fusion_tpu_torch.data import tma_extraction

    real = tma_extraction.make_feature_extractor

    def make(*args, **kwargs):
        extract = real(*args, **kwargs)
        return lambda patches: change(patches, extract(patches))

    return patch(tma_extraction, "make_feature_extractor", make)


def _half_batch():
    """Every call encodes the first half of its patches; the rest come back
    as zeros."""
    def change(patches, feats):
        out = np.zeros_like(feats)
        half = len(patches) // 2
        out[:half] = feats[:half]
        return out

    return _wrap_extractor(change)


def _altered_answer():
    """One feature of the first patch of every core is 1.0 off."""
    def change(patches, feats):
        feats = feats.copy()
        feats[0, 0] += 1.0
        return feats

    return _wrap_extractor(change)


FAULTS = {"half_batch": _half_batch, "altered_answer": _altered_answer}

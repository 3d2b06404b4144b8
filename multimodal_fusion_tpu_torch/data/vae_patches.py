"""WSI patch dataset for the VAE (counterpart of
``multimodal_fusion_tpu.data.vae_patches``, numpy only).

Reference: ``vae/dataset.py:21-363`` — wraps the multimodal dataset with
``channels=['wsi=features']``, keeps only patients with a given label
(default 'living'), builds a flat patch index with stochastic subsampling
(>1000 patches -> 10%, >100 -> 20%, else all), supports full preload and
``resample_patches()`` to reshuffle the subsample between epochs.  The
subsample draws from ``random.Random(seed)`` as in the JAX package, so
``patch_index`` equals the JAX one for a seed and after every resample.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_fusion_tpu_torch.data.multimodal import MultimodalDataset


class WSIVAEDataset:
    def __init__(
        self,
        csv_path,
        data_root_dir,
        label_filter: Optional[str] = "living",
        use_all_data: bool = False,
        preload: bool = True,
        seed: int = 42,
    ):
        self.base = MultimodalDataset(csv_path, data_root_dir, channels=["wsi=features"])
        self.use_all_data = use_all_data
        self.rng = random.Random(seed)
        # reference treats None AND empty/whitespace as "no filter"
        # (vae/dataset.py:74) — label_filter='' must not produce an empty set
        if label_filter is not None and str(label_filter).strip() != "":
            self.case_ids = [
                c for c in self.base.case_ids if self.base.case_to_label[c] == label_filter
            ]
        else:
            self.case_ids = list(self.base.case_ids)
        self._features: Dict[str, np.ndarray] = {}
        if preload:
            for cid in self.case_ids:
                raw, _ = self.base.get_case(cid)
                self._features[cid] = raw["wsi=features"]
        self.patch_index: List[Tuple[str, int]] = []
        self.resample_patches()

    def _case_features(self, cid: str) -> np.ndarray:
        if cid in self._features:
            return self._features[cid]
        raw, _ = self.base.get_case(cid)
        return raw["wsi=features"]

    def resample_patches(self) -> None:
        """Rebuild the flat patch index with the reference's sampling rules
        (vae/dataset.py:219-233)."""
        self.patch_index = []
        for cid in self.case_ids:
            n = self._case_features(cid).shape[0]
            if self.use_all_data:
                sel = range(n)
            elif n > 1000:
                sel = sorted(self.rng.sample(range(n), max(1, int(n * 0.1))))
            elif n > 100:
                sel = sorted(self.rng.sample(range(n), max(1, int(n * 0.2))))
            else:
                sel = range(n)
            self.patch_index.extend((cid, i) for i in sel)

    def __len__(self) -> int:
        return len(self.patch_index)

    def __getitem__(self, idx: int) -> np.ndarray:
        cid, pi = self.patch_index[idx]
        return self._case_features(cid)[pi]

    def materialize(self) -> np.ndarray:
        """The current (sub)sampled patch set as one [len(self), D] array —
        row i == self[i], so a device-resident copy of this table gathered by
        ``VAETrainer._index_batches`` rows reproduces ``batches`` exactly."""
        per_case: List[np.ndarray] = []
        i = 0
        while i < len(self.patch_index):
            cid = self.patch_index[i][0]
            j = i
            while j < len(self.patch_index) and self.patch_index[j][0] == cid:
                j += 1
            feats = self._case_features(cid)
            per_case.append(feats[[pi for _, pi in self.patch_index[i:j]]])
            i = j
        if not per_case:
            return np.zeros((0, 1), np.float32)
        return np.concatenate(per_case, axis=0)

    def batches(self, batch_size: int, shuffle_rng: Optional[np.random.Generator] = None):
        """Yield [B, D] numpy batches (drops no remainder; the final short
        batch is padded by wrap-around, as the JAX package pads it to keep
        its shapes static)."""
        order = np.arange(len(self))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[: batch_size - len(idxs)]])
            yield np.stack([self[i] for i in idxs])


class VAEPatchSubset:
    """Position view over a ``WSIVAEDataset`` — the analog of the torch
    ``Subset`` that ``random_split`` returns in the reference
    (vae/train.py:414-417).  Positions index the parent's flat patch list;
    they stay valid across ``resample_patches`` because the sampling rules
    draw a deterministic COUNT per case (the reference's Subset relies on the
    same property)."""

    def __init__(self, parent: WSIVAEDataset, positions):
        self.parent = parent
        self.positions = np.asarray(positions, np.int64)

    def __len__(self) -> int:
        return len(self.positions)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.parent[int(self.positions[idx])]

    def resample_patches(self) -> None:
        self.parent.resample_patches()

    def materialize(self) -> np.ndarray:
        full = self.parent.materialize()
        if full.shape[0] == 0:
            return full
        return full[self.positions]

    def batches(self, batch_size: int, shuffle_rng: Optional[np.random.Generator] = None):
        order = np.arange(len(self))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[: batch_size - len(idxs)]])
            yield np.stack([self[i] for i in idxs])


def split_train_val(
    dataset: WSIVAEDataset, val_frac: float = 0.2, seed: int = 42
) -> Tuple[VAEPatchSubset, VAEPatchSubset]:
    """Disjoint patch-level 80/20 split (reference random_split,
    vae/train.py:414-417).  Validating on the training patches — the bug
    this replaces — contaminates the plateau/early-stop metric."""
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_frac))) if n > 1 else 0
    return (
        VAEPatchSubset(dataset, np.sort(perm[n_val:])),
        VAEPatchSubset(dataset, np.sort(perm[:n_val])),
    )

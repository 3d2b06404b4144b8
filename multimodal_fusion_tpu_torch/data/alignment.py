"""Aligned TMA NPZ dataset and global negative-sample pool (counterpart of
``multimodal_fusion_tpu.data.alignment``, numpy only).

Reference: ``alignment/alignment_dataset.py:15-706``:
- per-marker NPZ files keyed ``<...>_block<b>_x<x>_y<y>_patient<pid>``;
  keys are normalised via regex and aligned across modalities
  ('intersection' keeps common cores, 'union' pads missing with zeros);
- each (core, modality) entry is [n_patches, D] and is expanded to
  patch-level samples keyed (block, x, y, patient, patch_id);
- a global mismatch pool of per-modality index combos (size = ceil(N*ratio))
  provides negatives for the loss_IM BCE term;
- ``split_by_ids`` partitions by patient / spatial / full-tuple key.

The batch collate returns numpy stacks for the alignment step: positives
{modality: [B, D]} and negatives {modality: [B_neg, D]}.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NORM_PATTERN = re.compile(r"_block(\d+)_x(\d+)_y(\d+)_patient(\w+)$")

Key = Tuple[int, int, int, str, int]  # (block, x, y, patient, patch_id)


class TMANpzAlignedDataset:
    def __init__(
        self,
        base_dir: str | Path,
        modality_names: Sequence[str],
        filename_template: str = "tma_uni_tile_1024_{marker}.npz",
        align_mode: str = "intersection",
        feature_dim: Optional[int] = None,
    ):
        if align_mode not in ("intersection", "union"):
            raise ValueError("align_mode must be 'intersection' or 'union'")
        self.base_dir = Path(base_dir)
        self.modality_names = list(modality_names)
        self.align_mode = align_mode

        self.npz: Dict[str, np.lib.npyio.NpzFile] = {}
        self._core_cache: Dict[Tuple[str, str], np.ndarray] = {}
        self.norm_to_raw: Dict[str, Dict[Tuple[int, int, int, str], str]] = {}
        norm_sets = {}
        missing_files = []
        for mod in self.modality_names:
            path = self.base_dir / filename_template.format(marker=mod)
            if not path.exists():
                missing_files.append((mod, path))
                continue
            f = np.load(path, allow_pickle=True, mmap_mode="r")
            self.npz[mod] = f
            mapping = {}
            for raw in f.keys():
                m = NORM_PATTERN.search(raw)
                if m:
                    mapping[(int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4))] = raw
            self.norm_to_raw[mod] = mapping
            norm_sets[mod] = set(mapping)
        if not norm_sets:
            raise RuntimeError("no usable NPZ files / keys found")
        if missing_files:
            # the reference warns per missing file (alignment_dataset.py);
            # in intersection mode a fully absent modality would silently
            # train on all-zero features for that marker — fail instead
            import warnings

            desc = ", ".join(f"{m} ({p})" for m, p in missing_files)
            if align_mode == "intersection":
                raise FileNotFoundError(
                    f"missing modality NPZ file(s) in intersection mode: {desc}"
                )
            warnings.warn(f"missing modality NPZ file(s), zero-filled: {desc}",
                          stacklevel=2)

        if align_mode == "intersection":
            core_keys = set.intersection(*norm_sets.values())
        else:
            core_keys = set().union(*norm_sets.values())

        # infer feature dim from any entry
        if feature_dim is None:
            for mod in self.modality_names:
                if mod in self.npz:
                    any_key = next(iter(self.npz[mod].keys()))
                    arr = self.npz[mod][any_key]
                    feature_dim = arr.shape[-1]
                    break
        self.feature_dim = int(feature_dim)

        # expand to patch level using the first available modality's count
        self.normalized_keys: List[Key] = []
        for ck in sorted(core_keys):
            n_patches = None
            for mod in self.modality_names:
                raw = self.norm_to_raw.get(mod, {}).get(ck)
                if raw is not None:
                    arr = self.npz[mod][raw]
                    n_patches = 1 if arr.ndim == 1 else arr.shape[0]
                    break
            if n_patches is None:
                continue
            for pid in range(n_patches):
                self.normalized_keys.append(ck + (pid,))

    def __len__(self) -> int:
        return len(self.normalized_keys)

    def _core_array(self, mod: str, raw: str) -> np.ndarray:
        """Per-(modality, core) array with a small FIFO cache: np.load's
        mmap_mode is a no-op for compressed .npz members, so an uncached
        ``self.npz[mod][raw]`` decompresses the WHOLE [P, D] core to read one
        patch row — O(P^2) rows per core across a collate/device_tables
        sweep."""
        cache_key = (mod, raw)
        arr = self._core_cache.get(cache_key)
        if arr is None:
            arr = np.asarray(self.npz[mod][raw])
            if len(self._core_cache) >= 256:
                self._core_cache.pop(next(iter(self._core_cache)))
            self._core_cache[cache_key] = arr
        return arr

    def _fetch(self, mod: str, key: Key) -> np.ndarray:
        raw = self.norm_to_raw.get(mod, {}).get(key[:4])
        if raw is None:
            return np.zeros((self.feature_dim,), np.float32)  # union-mode fill
        arr = self._core_array(mod, raw)
        if arr.ndim == 1:
            return np.asarray(arr, np.float32)
        if key[4] >= arr.shape[0]:
            # the reference raises here (alignment_dataset.py patch_id range
            # check); clamping would silently pair MISALIGNED patches when
            # modalities disagree on per-core patch counts
            raise ValueError(
                f"patch_id {key[4]} out of range for modality '{mod}' core "
                f"{key[:4]} with {arr.shape[0]} patches"
            )
        return np.asarray(arr[key[4]], np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key = self.normalized_keys[index]
        return {mod: self._fetch(mod, key) for mod in self.modality_names}

    # ------------------------------------------------------------------

    @staticmethod
    def _key_to_id(key: Key, id_type: str):
        if id_type == "patient":
            return key[3]
        if id_type == "spatial":
            return key[:4]
        if id_type == "tuple":
            return key
        raise ValueError(f"unknown id_type {id_type}")


class GlobalMismatchSampler:
    """Global mismatch pool: per-modality random index combos with uniqueness
    repair (reference alignment_dataset.py:257-305)."""

    def __init__(self, pool_size: int, seed: int = 42):
        if pool_size == 0:
            raise ValueError("empty key set")
        self.pool_size = pool_size
        self.rng = np.random.RandomState(seed)

    def sample(self, num_pairs: int, modality_names: Sequence[str]) -> Dict[str, np.ndarray]:
        indices = {
            m: self.rng.randint(0, self.pool_size, size=num_pairs) for m in modality_names
        }
        mods = list(modality_names)
        seen = {}
        for i in range(num_pairs):
            combo = tuple(int(indices[m][i]) for m in mods)
            if combo in seen:
                for _ in range(50):
                    m = mods[self.rng.randint(len(mods))]
                    new = self.rng.randint(self.pool_size)
                    if new == indices[m][i]:
                        continue
                    indices[m][i] = new
                    combo = tuple(int(indices[x][i]) for x in mods)
                    if combo not in seen:
                        break
            seen[combo] = i
        return indices


class TMANpzAlignedWithNegDataset(TMANpzAlignedDataset):
    def __init__(
        self,
        base_dir,
        modality_names,
        filename_template: str = "tma_uni_tile_1024_{marker}.npz",
        align_mode: str = "intersection",
        mismatch_ratio: float = 1.0,
        seed: int = 42,
    ):
        super().__init__(base_dir, modality_names, filename_template, align_mode)
        self.mismatch_ratio = float(mismatch_ratio)
        self.seed = seed
        self._build_negative_pool()

    def _build_negative_pool(self):
        total = len(self.normalized_keys)
        n_pool = max(int(np.ceil(total * max(0.0, self.mismatch_ratio))), 1)
        sampler = GlobalMismatchSampler(total, self.seed)
        idx = sampler.sample(n_pool, self.modality_names)
        self.neg_pool = [
            {m: int(idx[m][i]) for m in self.modality_names} for i in range(n_pool)
        ]

    def resample_negatives(self, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        self._build_negative_pool()

    def get_negatives_for_batch(self, batch_id: int, batch_size: int) -> List[Dict[str, int]]:
        need = int(np.ceil(batch_size * max(0.0, self.mismatch_ratio)))
        if need <= 0 or not self.neg_pool:
            return []
        start = (batch_id * need) % len(self.neg_pool)
        return [self.neg_pool[(start + i) % len(self.neg_pool)] for i in range(need)]

    # ------------------------------------------------------------------

    def collate(self, sample_indices: Sequence[int], batch_id: int):
        """Stack positives and slice the negative pool for one batch
        (reference build_collate_fn, alignment_dataset.py:608-673)."""
        pos = {
            m: np.stack([self._fetch(m, self.normalized_keys[i]) for i in sample_indices])
            for m in self.modality_names
        }
        neg_combos = self.get_negatives_for_batch(batch_id, len(sample_indices))
        if neg_combos:
            neg = {
                m: np.stack(
                    [self._fetch(m, self.normalized_keys[c[m]]) for c in neg_combos]
                )
                for m in self.modality_names
            }
        else:
            neg = None
        return pos, neg

    def device_tables(self):
        """Materialise the whole aligned dataset for device residency:
        (features {marker: [N, D] f32}, neg_idx {marker: [P] int32 positions
        into the features}).  A batch then becomes two device-side gathers —
        zero per-step host->device feature upload (the host collate re-reads
        NPZ rows and ships ~MBs per step)."""
        feats = {
            m: np.stack([self._fetch(m, k) for k in self.normalized_keys]).astype(
                np.float32
            )
            for m in self.modality_names
        }
        neg_idx = {
            m: np.asarray([c[m] for c in self.neg_pool], np.int32)
            for m in self.modality_names
        }
        return feats, neg_idx

    def split_by_ids_with_neg(
        self,
        id_groups: Dict[str, List],
        id_type: str = "tuple",
        mismatch_ratio: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, "AlignedSubsetView"]:
        out = {}
        for name, ids in id_groups.items():
            id_set = set(ids)
            idxs = [
                i
                for i, k in enumerate(self.normalized_keys)
                if self._key_to_id(k, id_type) in id_set
            ]
            out[name] = AlignedSubsetView(
                self, idxs,
                mismatch_ratio if mismatch_ratio is not None else self.mismatch_ratio,
                seed if seed is not None else 42,
            )
        return out


class AlignedSubsetView:
    """Subset view with its own negative pool (reference :404-605)."""

    def __init__(self, parent: TMANpzAlignedWithNegDataset, indices: List[int], mismatch_ratio: float, seed: int):
        self.parent = parent
        self.indices = list(indices)
        if not self.indices:
            raise ValueError(
                "split group matched zero keys — check the split ids/id_type "
                "against the dataset's normalized keys"
            )
        self.mismatch_ratio = mismatch_ratio
        total = max(len(self.indices), 1)
        n_pool = max(int(np.ceil(total * max(0.0, mismatch_ratio))), 1)
        sampler = GlobalMismatchSampler(total, seed)
        idx = sampler.sample(n_pool, parent.modality_names)
        self.neg_pool = [
            {m: self.indices[int(idx[m][i]) % total] for m in parent.modality_names}
            for i in range(n_pool)
        ]

    def __len__(self):
        return len(self.indices)

    def collate(self, batch_positions: Sequence[int], batch_id: int):
        p = self.parent
        sample_indices = [self.indices[i] for i in batch_positions]
        pos = {
            m: np.stack([p._fetch(m, p.normalized_keys[i]) for i in sample_indices])
            for m in p.modality_names
        }
        need = int(np.ceil(len(sample_indices) * max(0.0, self.mismatch_ratio)))
        neg = None
        if need > 0 and self.neg_pool:
            start = (batch_id * need) % len(self.neg_pool)
            combos = [self.neg_pool[(start + i) % len(self.neg_pool)] for i in range(need)]
            neg = {
                m: np.stack([p._fetch(m, p.normalized_keys[c[m]]) for c in combos])
                for m in p.modality_names
            }
        return pos, neg


    def device_tables(self):
        """View-local device tables (see TMANpzAlignedWithNegDataset
        .device_tables): features for THIS view's rows, negative-pool
        combos as positions into the view."""
        p = self.parent
        feats = {
            m: np.stack(
                [p._fetch(m, p.normalized_keys[i]) for i in self.indices]
            ).astype(np.float32)
            for m in p.modality_names
        }
        pos_of = {idx: j for j, idx in enumerate(self.indices)}
        neg_idx = {
            m: np.asarray([pos_of[c[m]] for c in self.neg_pool], np.int32)
            for m in p.modality_names
        }
        return feats, neg_idx


def create_tma_aligned_with_neg_dataset(
    base_dir, modality_names, **kwargs
) -> TMANpzAlignedWithNegDataset:
    """Factory matching the reference helper (alignment_dataset.py:676-706)."""
    return TMANpzAlignedWithNegDataset(base_dir, modality_names, **kwargs)

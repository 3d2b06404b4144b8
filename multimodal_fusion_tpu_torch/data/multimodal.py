"""MultimodalDataset: CSV + per-patient HDF5 -> per-case numpy channel dicts
(counterpart of ``multimodal_fusion_tpu.data.multimodal``).

Reference semantics: ``downstream_survival/datasets/multimodal_dataset.py:31-523``:
- CSV columns patient_id, case_id, label, h5_file_path;
- channels validated, cases missing any channel filtered out at init;
- deterministic label map (sorted unique labels -> int);
- special ``hypergraph=`` channels read the ``hypergraph/`` h5 group with
  fallback to raw features (:343-386);
- per-file locks + retry handled by the ``io.h5io`` layer;
- an optional alignment model applied at load time produces
  ``aligned_<channel>`` entries (:396-425).

The JAX dataset's ``preload_all`` is not ported: no CLI of either package
sets it.

The CSV is read with the stdlib ``csv`` module and ``h5py`` is imported
inside the functions that open files (the port runs on machines without
pandas or h5py).  Values read from the CSV are strings, as pandas would
give for these columns except ``patient_id``, which stays a string here.
This layer returns numpy dicts; padded window batches come from
``data.batching``.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from multimodal_fusion_tpu_torch.channels import h5_path_for_channel
from multimodal_fusion_tpu_torch.io.h5io import read_h5_retrying

RawCase = Dict[str, np.ndarray]

HYPERGRAPH_KEY_PATHS = {
    "wsi_super_features": ("hypergraph/wsi_super/features", "wsi/features"),
    "tma_features": ("hypergraph/tma/features", None),
    "edge_index": ("hypergraph/edge_index", None),
    "edge_weights": ("hypergraph/edge_weights", None),
    "group_labels": ("hypergraph/group_labels", None),
}


def _standardize(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr.astype(np.float32)


class MultimodalDataset:
    def __init__(
        self,
        csv_path: str | Path,
        data_root_dir: str | Path,
        channels: List[str],
        align_channels: Optional[Dict[str, str]] = None,
        alignment_apply_fn: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
        print_info: bool = False,
    ):
        """``align_channels`` maps a channel to its alignment modality;
        ``alignment_apply_fn`` maps {modality: [N, D]} to the aligned dict
        (``train.alignment.make_alignment_apply_fn``)."""
        if not channels:
            raise ValueError("channels must not be empty")
        self.data_root_dir = Path(data_root_dir)
        self.channels = list(channels)
        self.align_channels = dict(align_channels or {})
        self.alignment_apply_fn = alignment_apply_fn
        self.print_info = print_info
        missing_align = [c for c in self.align_channels if c not in self.channels]
        if missing_align:
            raise ValueError(f"align_channels keys not in channels: {missing_align}")

        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            columns = list(reader.fieldnames or [])
            rows = list(reader)
        required = ["patient_id", "case_id", "label", "h5_file_path"]
        missing_cols = [c for c in required if c not in columns]
        if missing_cols:
            raise ValueError(f"CSV missing required columns: {missing_cols}")

        self.case_to_file: Dict[str, str] = {}
        self.case_to_label: Dict[str, str] = {}
        self.case_to_patient: Dict[str, str] = {}
        # optional survival-time columns (the reference CSV carries only
        # binary labels)
        self.has_survival_time = "time" in columns
        self.case_to_time: Dict[str, float] = {}
        self.case_to_event: Dict[str, float] = {}
        for row in rows:
            cid = row["case_id"]
            self.case_to_file[cid] = str(self.data_root_dir / row["h5_file_path"])
            self.case_to_label[cid] = row["label"]
            self.case_to_patient[cid] = row["patient_id"]
            if self.has_survival_time:
                self.case_to_time[cid] = float(row["time"])
                self.case_to_event[cid] = float(
                    float(row["event"]) if "event" in columns else (row["label"] == "deceased")
                )
        self.case_ids = sorted(self.case_to_file)

        self._filter_missing()
        self._build_label_mapping()

    # ------------------------------------------------------------------

    def _build_label_mapping(self):
        uniq = sorted({self.case_to_label[c] for c in self.case_ids})
        self.label_to_int = {l: i for i, l in enumerate(uniq)}
        self.int_to_label = {i: l for l, i in self.label_to_int.items()}

    def _channel_present(self, f, channel: str) -> bool:
        if channel.startswith("hypergraph="):
            key = channel.replace("hypergraph=", "")
            if key not in HYPERGRAPH_KEY_PATHS:
                # a typo'd key would otherwise silently filter every case
                raise ValueError(
                    f"unknown hypergraph channel {channel!r}; valid keys: "
                    f"{sorted(HYPERGRAPH_KEY_PATHS)}"
                )
            path, fallback = HYPERGRAPH_KEY_PATHS[key]
            if path in f:
                return True
            if key == "edge_weights":  # optional
                return True
            return fallback is not None and fallback in f
        return h5_path_for_channel(channel) in f

    def _filter_missing(self):
        valid = []
        for cid in self.case_ids:
            path = self.case_to_file[cid]
            if not os.path.exists(path):
                continue
            if read_h5_retrying(
                path,
                lambda f: all(self._channel_present(f, ch) for ch in self.channels),
            ):
                valid.append(cid)
        dropped = len(self.case_ids) - len(valid)
        if dropped and self.print_info:
            print(f"Filtered {dropped} cases missing required channels")
        self.case_ids = valid

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.case_ids)

    def get_label_int(self, case_id: str) -> int:
        return self.label_to_int[self.case_to_label[case_id]]

    @property
    def labels(self) -> np.ndarray:
        return np.asarray([self.get_label_int(c) for c in self.case_ids])

    def _read_hypergraph_channel(self, f, channel: str) -> Optional[np.ndarray]:
        key = channel.replace("hypergraph=", "")
        path, fallback = HYPERGRAPH_KEY_PATHS[key]
        if path in f:
            data = np.asarray(f[path])
        elif fallback is not None and fallback in f:
            data = np.asarray(f[fallback])
        elif key == "edge_weights":
            # optional channel missing in this file: an empty marker keeps
            # the key present in every case of a window
            return np.zeros((0,), np.float32)
        else:
            raise KeyError(f"missing hypergraph channel {channel}")
        if key == "edge_index":
            return data.astype(np.int64)
        if key == "edge_weights":
            return np.asarray(data, np.float32).reshape(-1)
        if key == "group_labels":
            return np.asarray(data, np.int64).reshape(-1)
        return _standardize(data)

    def get_case(self, case_id: str) -> Tuple[RawCase, int]:
        path = self.case_to_file[case_id]

        # the hot path retries the whole read unit, like the reference
        # (multimodal_dataset.py:465-503)
        def read(f) -> RawCase:
            case: RawCase = {}
            for ch in self.channels:
                if ch.startswith("hypergraph="):
                    data = self._read_hypergraph_channel(f, ch)
                    if data is not None:
                        case[ch] = data
                else:
                    case[ch] = _standardize(np.asarray(f[h5_path_for_channel(ch)]))
            return case

        out = read_h5_retrying(path, read)
        if self.alignment_apply_fn is not None and self.align_channels:
            align_in = {mod: out[ch] for ch, mod in self.align_channels.items() if ch in out}
            if align_in:
                aligned = self.alignment_apply_fn(align_in)
                mod_to_ch = {m: c for c, m in self.align_channels.items()}
                for mod, feat in aligned.items():
                    if mod in mod_to_ch:
                        out[f"aligned_{mod_to_ch[mod]}"] = np.asarray(feat, np.float32)
        return out, self.label_to_int[self.case_to_label[case_id]]

    def __getitem__(self, idx: int) -> Tuple[RawCase, int]:
        return self.get_case(self.case_ids[idx])

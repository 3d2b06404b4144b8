"""HDF5 per-patient storage for the port (same on-disk schema as the JAX
package's ``io.h5io``)::

    <patient>.h5
    ├── wsi/{features [N, D], positions [N, 2]}
    ├── tma/features [T, D]  or  tma/<marker>/features
    └── hypergraph/
        ├── wsi_super/{features,positions}
        ├── tma/features
        ├── edge_index   [2, E] int64
        ├── edge_weights [E]    float32
        ├── group_labels [V]    int64
        └── similarity/{wsi_internal,wsi_tma}   (optional caches)
            (+ JSON 'stats' attribute on the hypergraph group)

``h5py`` is imported inside each function, never at module import: the
numeric path (``hypergraph.build.process_arrays``) runs on machines without
it.  h5py handles are not thread-safe, so each file is guarded by a
per-path lock and reads retry with exponential backoff + jitter.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np

from multimodal_fusion_tpu_torch.channels import h5_path_for_channel


def _json_default(o):
    """numpy scalars/arrays -> plain python for stats JSON."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# RLock: composite operations hold the per-path lock across reads that
# themselves acquire it.
_FILE_LOCKS: Dict[str, threading.RLock] = {}
_FILE_LOCKS_GUARD = threading.Lock()


def _lock_for(path: str) -> threading.RLock:
    with _FILE_LOCKS_GUARD:
        if path not in _FILE_LOCKS:
            _FILE_LOCKS[path] = threading.RLock()
        return _FILE_LOCKS[path]


def read_h5_retrying(h5_path, fn, retries: int = 4, backoff: float = 0.05):
    """Run ``fn(h5py.File)`` under the per-path lock, retrying the whole
    read unit on transient ``OSError``.  ``fn`` must be a pure read."""
    import h5py

    path = str(h5_path)
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        with _lock_for(path):
            try:
                with h5py.File(path, "r") as f:
                    return fn(f)
            except FileNotFoundError:  # not transient
                raise
            except OSError as e:  # pragma: no cover - transient-IO path
                last_err = e
        if attempt + 1 < retries:
            time.sleep(backoff * (2**attempt) * (1 + random.random()))
    raise OSError(f"failed to read {path} after {retries} attempts: {last_err}")


@contextlib.contextmanager
def open_h5_retrying(h5_path, mode: str = "r", retries: int = 4, backoff: float = 0.05):
    """Locked ``h5py.File`` handle whose OPEN is retried with backoff (the
    body runs once: use ``read_h5_retrying`` for whole-unit read retry)."""
    import h5py

    path = str(h5_path)
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        with _lock_for(path):
            try:
                f = h5py.File(path, mode)
            except FileNotFoundError:
                if mode == "r":
                    raise
                last_err = FileNotFoundError(path)
            except OSError as e:  # pragma: no cover - transient-IO path
                last_err = e
            else:
                try:
                    yield f
                finally:
                    f.close()
                return
        if attempt + 1 < retries:
            time.sleep(backoff * (2**attempt) * (1 + random.random()))
    raise OSError(f"failed to open {path} after {retries} attempts: {last_err}")


def write_channel(h5_path, channel: str, data: np.ndarray, compression: Optional[str] = "gzip") -> None:
    """Write/overwrite one channel dataset."""
    import h5py

    path = str(h5_path)
    dset = h5_path_for_channel(channel)
    with _lock_for(path):
        with h5py.File(path, "a") as f:
            if dset in f:
                del f[dset]
            f.create_dataset(dset, data=np.asarray(data), compression=compression)


HYPERGRAPH_KEYS = (
    "wsi_super/features",
    "wsi_super/positions",
    "tma/features",
    "edge_index",
    "edge_weights",
    "group_labels",
)
SIMILARITY_KEYS = ("similarity/wsi_internal", "similarity/wsi_tma")


def write_hypergraph_group(
    h5_path,
    arrays: Dict[str, np.ndarray],
    stats: Optional[Dict] = None,
    save_similarity: bool = True,
    compression: Optional[str] = None,
) -> None:
    """Write the ``hypergraph/`` group; ``stats`` becomes a JSON string
    attribute written last, so it doubles as the completion marker."""
    import h5py

    path = str(h5_path)
    with _lock_for(path):
        with h5py.File(path, "a") as f:
            if "hypergraph" in f:
                del f["hypergraph"]
            grp = f.create_group("hypergraph")
            for key, arr in arrays.items():
                if not save_similarity and key.startswith("similarity/"):
                    continue
                grp.create_dataset(key, data=np.asarray(arr), compression=compression)
            if stats is not None:
                grp.attrs["stats"] = json.dumps(stats, default=_json_default)


def has_complete_hypergraph(h5_path, require_similarity: bool = False) -> bool:
    """True when ``h5_path`` carries a complete ``hypergraph/`` group: every
    structural key plus the ``stats`` attribute (and the similarity caches
    when ``require_similarity``)."""
    keys = HYPERGRAPH_KEYS + (SIMILARITY_KEYS if require_similarity else ())

    def probe(f):
        if "hypergraph" not in f:
            return False
        grp = f["hypergraph"]
        return "stats" in grp.attrs and all(k in grp for k in keys)

    try:
        return read_h5_retrying(h5_path, probe)
    except OSError:
        return False


def read_hypergraph_group(h5_path, keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Read the ``hypergraph/`` group (all datasets, or a subset) plus the
    parsed ``stats`` attribute under ``__stats__``."""
    import h5py

    def read(f) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if "hypergraph" not in f:
            raise KeyError(f"no hypergraph group in {h5_path}")
        grp = f["hypergraph"]
        if keys is None:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name] = np.asarray(obj)
            grp.visititems(visit)
        else:
            for key in keys:
                if key in grp:
                    out[key] = np.asarray(grp[key])
        if "stats" in grp.attrs:
            out["__stats__"] = json.loads(grp.attrs["stats"])
        return out

    return read_h5_retrying(h5_path, read)

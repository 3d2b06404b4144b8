"""Live scalar emission during training (counterpart of
``multimodal_fusion_tpu.utils.scalars``, copied).

The reference surfaces live training signal two ways: TensorBoard scalars in
the VAE trainer (vae/train.py:84,162-165,228-241) and tqdm live postfix in the
alignment trainer (alignment/trainer.py:334-342).  The
equivalent is an append-only CSV that is flushed after every row, so
``tail -f <run>/scalars.csv`` tracks a training run live — greppable,
plottable, and dependency-free (no TB event-file writer needed).

Rows are written at the same cadence the reference emits scalars: per epoch
for the VAE, per validation interval for alignment.  Columns are fixed at
first write; subsequent writes must pass the same keys.  Resuming into an
existing CSV keeps its column order when the scalar set matches, and rotates
the old file to ``scalars.csv.N`` when it doesn't — rows are never appended
under a mismatched header.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, Optional, Sequence


class ScalarWriter:
    """Append-only CSV scalar log, flushed (and fsync'd) per row."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", newline="")
        self._writer: Optional[csv.DictWriter] = None
        self._fields: Optional[Sequence[str]] = None

    def write(self, scalars: Dict[str, float]) -> None:
        if self._writer is None:
            self._fields = list(scalars)
            if self._fh.tell() > 0:
                # appending to an existing log (--resume): keep its column
                # order if the scalar sets match; otherwise rotate the old
                # file aside so rows never land under a mismatched header
                with open(self.path, newline="") as rf:
                    old = next(csv.reader(rf), None)
                if old and set(old) == set(self._fields):
                    self._fields = old
                elif old is not None:
                    self._fh.close()
                    n = 1
                    while self.path.with_suffix(self.path.suffix + f".{n}").exists():
                        n += 1
                    os.replace(self.path, self.path.with_suffix(self.path.suffix + f".{n}"))
                    self._fh = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=self._fields)
            if self._fh.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({k: scalars.get(k, "") for k in self._fields})
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

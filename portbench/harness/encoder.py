"""The encoder's own spans and counters (``models/vit.py``: ``vit.attention``
and ``vit.mlp`` tiling each block, ``vit.batches`` one a forward,
``vit.tokens`` its rows times its tokens) in the program window
(``harness/program.py``).

The first read of a window logs the encoder's tokens a second over it
beside ``pad_share.extract``.  A program whose ViT has no such spans or
counters reads nothing and logs nothing.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from portbench.harness.program import Window, window

_LOGGED: List[Optional[Window]] = [None]  # the window whose tokens were logged


def _log_tokens(run, w: Window) -> None:
    if _LOGGED[0] is w:
        return
    _LOGGED[0] = w
    from portbench.harness.readers import pad_share

    config = run.cell.config
    share = pad_share(run, int(config["model"]["depth"]), int(config["extraction"]["batch_size"]))
    beside = "not read" if share is None else f"{share:.4f}%"
    tokens, batches = w.counts["vit.tokens"], w.counts.get("vit.batches", 0)
    print(f"program window: vit.tokens / window = {tokens / w.seconds:.1f} tokens/s ({tokens} "
          f"tokens in {batches} batches, {w.seconds:.3f} s); pad_share.extract {beside}",
          file=sys.stderr)


def device_ms_per_batch(run, name: str) -> Optional[float]:
    """Device ms of the ops launched inside the span ``name`` per
    ``vit.batches``, over the program window."""
    w = window(run)
    if w is None or not w.counts.get("vit.tokens"):
        return None
    _log_tokens(run, w)
    batches = w.counts.get("vit.batches", 0)
    if w.device_s is None or not batches or name not in w.device_s:
        return None
    return 1e3 * w.device_s[name] / batches

"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), all
sources at once, at the first CUDA use.  Libraries land in ``_build/`` next
to this package (git-ignored), named by a hash of their source, so an edited
source rebuilds and an unchanged one loads straight away.  Loading is
``ctypes``: every C entry takes ``void*`` pointers and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch.  ``call`` runs an entry on
PyTorch's current stream and ``check`` raises on the error it returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _lib_path(src: Path) -> Path:
    # the shared headers are part of every source's hash: editing one
    # rebuilds every library
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, Dict]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all started together.  Returns, per kernel source, its
    library path, build seconds (0.0 when it was already built) and the
    compiler's ``-Xptxas -v`` report.  Raises if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = {}
        report: Dict[str, Dict] = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = _lib_path(src)
            if out.exists():
                report[src.stem] = {"lib": str(out), "seconds": 0.0, "log": ""}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[src.stem] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            report[name] = {"lib": str(out), "seconds": seconds, "log": log}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel
    first if its library is missing."""
    with _lock:
        if name in _libs:
            return _libs[name]
    path = _lib_path(CSRC / f"{name}.cu")
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def call(device: torch.device, fn, *args):
    """``fn(*args, stream)`` on PyTorch's current stream of ``device``,
    made the current device for the call if it is not.  The stream's raw
    handle is the one PyTorch's own generated kernels take: it builds no
    torch.cuda.Stream object."""
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(current))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

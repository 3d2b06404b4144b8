"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import multimodal_fusion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules if m == "multimodal_fusion_tpu" or m.startswith("multimodal_fusion_tpu."))
assert not leaked, leaked
assert not [m for m in sys.modules if m in ("flax", "optax") or m.startswith(("flax.", "optax."))]
required = {
    "multimodal_fusion_tpu_torch.ops.attention",
    "multimodal_fusion_tpu_torch.ops.attention_kernel",
    "multimodal_fusion_tpu_torch.ops.resize",
    "multimodal_fusion_tpu_torch.models.vit",
    "multimodal_fusion_tpu_torch.data.tma_extraction",
    "multimodal_fusion_tpu_torch.cli.extract_tma_features",
}
assert required <= set(names), sorted(required - set(names))
print(len(names))
"""


def test_port_imports_without_jax_or_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every submodule of both slices was imported
    assert int(out.stdout.strip()) >= 25


def test_chip_smoke_imports_without_jax_or_jax_package():
    """chip_smoke.py's imports resolve without JAX (its main() is not run:
    it needs a card)."""
    probe = (
        "import sys; sys.modules['jax'] = None; import runpy; "
        "ns = runpy.run_path('chip_smoke.py', run_name='chip_smoke'); "
        "assert 'main' in ns; "
        "assert not [m for m in sys.modules if m.startswith('multimodal_fusion_tpu.') "
        "or m == 'multimodal_fusion_tpu']"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr

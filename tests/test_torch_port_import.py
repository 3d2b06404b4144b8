"""The PyTorch port imports neither JAX nor anything of the JAX package, and
no module of it imports sklearn, pandas, h5py or matplotlib at top level
(the card's machine has none of them)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import pkgutil, sys
for blocked in ("jax", "sklearn", "pandas", "h5py", "matplotlib", "tensorboard"):
    sys.modules[blocked] = None  # any `import <blocked>` now raises ImportError
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
    "multimodal_fusion_tpu_torch.config",
    "multimodal_fusion_tpu_torch.ops.losses",
    "multimodal_fusion_tpu_torch.data.batching",
    "multimodal_fusion_tpu_torch.data.splits",
    "multimodal_fusion_tpu_torch.data.multimodal",
    "multimodal_fusion_tpu_torch.models.base",
    "multimodal_fusion_tpu_torch.models.mfmf",
    "multimodal_fusion_tpu_torch.models.factory",
    "multimodal_fusion_tpu_torch.train.optim",
    "multimodal_fusion_tpu_torch.train.metrics",
    "multimodal_fusion_tpu_torch.train.checkpoint",
    "multimodal_fusion_tpu_torch.train.survival",
    "multimodal_fusion_tpu_torch.utils.logging",
    "multimodal_fusion_tpu_torch.ops.masked",
    "multimodal_fusion_tpu_torch.models.attention",
    "multimodal_fusion_tpu_torch.models.clam",
    "multimodal_fusion_tpu_torch.models.clam_mlp",
    "multimodal_fusion_tpu_torch.models.svd_gate",
    "multimodal_fusion_tpu_torch.utils.results_io",
    "multimodal_fusion_tpu_torch.utils.predict",
    "multimodal_fusion_tpu_torch.utils.serve",
    "multimodal_fusion_tpu_torch.cli.predict",
    "multimodal_fusion_tpu_torch.cli.serve",
    "multimodal_fusion_tpu_torch.models.auc_clam",
    "multimodal_fusion_tpu_torch.models.cox",
    "multimodal_fusion_tpu_torch.utils.seeding",
    "multimodal_fusion_tpu_torch.cli.main_survival",
    "multimodal_fusion_tpu_torch.data.alignment",
    "multimodal_fusion_tpu_torch.models.alignment",
    "multimodal_fusion_tpu_torch.train.alignment",
    "multimodal_fusion_tpu_torch.cli.run_alignment",
    "multimodal_fusion_tpu_torch.utils.scalars",
    "multimodal_fusion_tpu_torch.utils.profiling",
    "multimodal_fusion_tpu_torch.utils.visualization",
    "multimodal_fusion_tpu_torch.cli.alignment_visualization",
    "multimodal_fusion_tpu_torch.models.vae",
    "multimodal_fusion_tpu_torch.data.vae_patches",
    "multimodal_fusion_tpu_torch.utils.tbevents",
    "multimodal_fusion_tpu_torch.train.vae",
    "multimodal_fusion_tpu_torch.cli.train_vae",
    "multimodal_fusion_tpu_torch.cli.generate_reconstructed_wsi",
    "multimodal_fusion_tpu_torch.hypergraph.dense_graph",
    "multimodal_fusion_tpu_torch.parallel.mesh",
    "multimodal_fusion_tpu_torch.parallel.multihost",
    "multimodal_fusion_tpu_torch.parallel.dryrun",
    "multimodal_fusion_tpu_torch.demo.example_usage",
}
assert required <= set(names), sorted(required - set(names))
print(len(names))
"""


def test_port_imports_without_jax_or_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every submodule of the four slices was imported
    assert int(out.stdout.strip()) >= 50


def test_chip_smoke_imports_without_jax_or_jax_package():
    """chip_smoke.py's imports resolve without JAX (its main() is not run:
    it needs a card)."""
    probe = (
        "import sys; sys.modules.update(jax=None, sklearn=None, pandas=None, h5py=None); "
        "import runpy; "
        "ns = runpy.run_path('chip_smoke.py', run_name='chip_smoke'); "
        "assert 'main' in ns; "
        "assert not [m for m in sys.modules if m.startswith('multimodal_fusion_tpu.') "
        "or m == 'multimodal_fusion_tpu']"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr

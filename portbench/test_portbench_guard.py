"""No JAX: the harness, the entries and the metric readers load neither
JAX nor the JAX package, and the reference loads nothing of the port
either; names are compared by their whole top-level part."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.harness import guard

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def test_whole_top_level_names():
    assert guard.forbidden(["multimodal_fusion_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden(["multimodal_fusion_tpu.models", "jax.numpy", "jaxlib", "flax.nnx"]) == \
        ["flax", "jax", "jaxlib", "multimodal_fusion_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    for path in PKG.rglob("*.py"):
        assert guard.forbidden(_imports(path)) == [], path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"multimodal_fusion_tpu_torch", "multimodal_fusion_tpu", "jax"}, path


def _loaded_after(code: str):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return p.stdout.split()


def test_a_cpu_run_loads_no_jax():
    names = _loaded_after(
        "import time\n"
        "from portbench.test_portbench_runs import run\n"
        "run('mfmf_config1.train')\nrun('uni_vit_l16.extract_big_cores')")
    assert guard.forbidden(names) == []


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded_after("import portbench.reference.mfmf, portbench.reference.vit")
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"multimodal_fusion_tpu_torch", "multimodal_fusion_tpu", "jax", "jaxlib",
                       "flax"}

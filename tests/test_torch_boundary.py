"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py``, the port's examples (``examples/*_torch.py``) and its
tools (every ``tools/*.py`` that imports ``repro_torch``) imports JAX or the
JAX package ``repro``."""
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b|\s*,)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def test_port_imports_no_jax_and_no_repro():
    files = [p for p in sorted((ROOT / "src" / "repro_torch").rglob("*")) if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh")]
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    tools = [p for p in sorted((ROOT / "tools").glob("*.py")) if "repro_torch" in p.read_text()]
    files += [ROOT / "chip_smoke.py", *examples, *tools]
    assert len(files) > 20
    assert {p.name for p in examples} >= {"quickstart_torch.py", "photonic_paper_repro_torch.py",
                                          "serve_sparse_torch.py", "sparse_training_torch.py"}
    assert {p.name for p in tools} >= {"decode_mma_clocks.py", "mesh_phase.py",
                                       "sparse_matvec_times.py", "time_continuous.py",
                                       "time_dense_prefill.py"}
    bad = [f"{p.relative_to(ROOT)}:{text[:m.start()].count(chr(10)) + 1}: {m.group(0).strip()}"
           for p in files for text in [p.read_text()] for m in FORBIDDEN.finditer(text)]
    assert not bad, bad


def test_boundary_pattern():
    for line in ["import jax", "  from jax import numpy", "import repro.core",
                 "from repro.models import layers", "from repro import serve",
                 "import repro", "import jax.numpy as jnp"]:
        assert FORBIDDEN.search(line), line
    for line in ["import repro_torch", "from repro_torch.models import layers",
                 "import repro_torch.kernels.build", "import jaxtyping",
                 "# from repro.core import x is the reference"]:
        assert not FORBIDDEN.search(line), line

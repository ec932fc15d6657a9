"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b|\s*,)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def test_port_imports_no_jax_and_no_repro():
    files = [p for p in sorted((ROOT / "src" / "repro_torch").rglob("*")) if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
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

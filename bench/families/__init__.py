"""The model a configuration brings: its family file and its plain
reference, found by path from two keys of the configuration file.

    "family": "bench/families/dense.py"   (the default where the key is missing)
    "reference": "bench/reference.py"     (the default where the key is missing)

Paths are from the checkout's root.  A new model is new files: a
configuration that names its own family and reference, and nothing else
here or in the harness changes.

A family file defines, for a configuration file's dict ``model``:

- ``build_arch(model)``: the port's ``Arch`` at the sizes the file states.
  It imports the program inside the function, never at the top of the file.
- ``param_tree(model, seed, device)``: the port's param tree, every weight
  bf16, each leaf drawn from the seed exactly as the reference draws it
  again after the window (``bench/weights.py``'s generators and block
  scaling).
- ``decode_step(model, contexts)``: (operations, bytes) of one decode
  step's problem, the live rows each at its real context length.
- ``prefill_chunk(model, rows)``: (operations, bytes) of one prefill
  launch's problem, ``rows`` of (start, real tokens, final chunk).
- ``int8_step_bound_s(model, m)``: Σ ``roofline.bound_s`` over one
  forward's int8 launches at M = m rows.  It covers exactly the launches
  whose kernels ``tracing.reduce_profile`` counts as int8 (names holding
  ``tracing.INT8_MARK``), no more and no fewer, since the int8 rooflines
  divide one by the other.  A new kernel outside that filter gets a metric
  file of its own (``bench/metrics/``) instead of a share of this bound.

The counts come from the configuration's shapes alone, never from the
program's tensors or kernels.

A reference file defines ``logit_gaps(model, seed, device, seqs,
control=False)`` as ``bench/reference.py`` does: the model in plain PyTorch
or NumPy, float32, TF32 off, over whole sequences, its weights made again
from the seed.  It imports nothing of the program (``repro_torch``), nor
JAX or the JAX package, and takes nothing the program made.

A file that lacks one of its functions fails here, when it is loaded.
"""
from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
DEFAULT_FAMILY = "bench/families/dense.py"
DEFAULT_REFERENCE = "bench/reference.py"
FAMILY_FUNCTIONS = ("build_arch", "param_tree", "decode_step", "prefill_chunk",
                    "int8_step_bound_s")
REFERENCE_FUNCTIONS = ("logit_gaps",)


def _module_name(path: Path) -> str:
    """The dotted name of a file under the checkout (``bench.reference``),
    so that a file also imported the usual way is one module, not two."""
    try:
        return ".".join(path.relative_to(ROOT).with_suffix("").parts)
    except ValueError:
        return "bench_file_" + hashlib.sha256(str(path).encode()).hexdigest()[:16]


def _load(model: dict, key: str, default: str, functions: tuple[str, ...]) -> ModuleType:
    given = model.get(key, default)
    path = (ROOT / given).resolve()
    if not path.is_file():
        raise ImportError(f"{model.get('name', 'a configuration')}: its {key} file {given} "
                          f"does not exist")
    name = _module_name(path)
    mod = sys.modules.get(name)
    if mod is None or Path(getattr(mod, "__file__", "")).resolve() != path:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    missing = [f for f in functions if not callable(getattr(mod, f, None))]
    if missing:
        raise ImportError(f"{given}: a {key} file defines {', '.join(functions)}; "
                          f"this one lacks {', '.join(missing)}")
    return mod


def load(model: dict) -> ModuleType:
    """The family file the configuration names (``"family"``)."""
    return _load(model, "family", DEFAULT_FAMILY, FAMILY_FUNCTIONS)


def reference(model: dict) -> ModuleType:
    """The plain reference the configuration names (``"reference"``)."""
    return _load(model, "reference", DEFAULT_REFERENCE, REFERENCE_FUNCTIONS)

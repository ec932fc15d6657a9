"""Per-layer metrics: one file each, ``<name>.py``, found by this loader.

A metric file sets ``NAME``, ``UNIT``, ``BETTER`` ("lower" | "higher"),
``LAYER`` (as ``PERF.md``'s list of layers names it), ``SOURCE``
("device_trace" | "program_span" | "program_counter" | "host_clock"),
``MOVES`` (the end-to-end metric it should move) and ``read(data)``, which
returns its value from the traced run's ``data`` = {"stats": the
scheduler's counters over the window, "spans": ``tracing.Recorder.summary()``,
"profile": ``tracing.reduce_profile`` of the profiled slice}, or None where
there is nothing to read (the metric is then left out of the line).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def load() -> list[ModuleType]:
    mods = []
    for path in sorted(HERE.glob("*.py")):
        if path.name == "__init__.py":
            continue
        spec = importlib.util.spec_from_file_location(
            f"bench.metrics.{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.NAME != path.stem:
            raise ValueError(f"{path.name} declares NAME {mod.NAME!r}")
        mods.append(mod)
    return mods


def read_all(data: dict, moved: list[str] | None = None) -> list[tuple[str, str, float]]:
    """(name, unit, value) of every metric that found something to read and
    moves one of ``moved`` (the cell's end-to-end metrics; None: any)."""
    out = []
    for mod in load():
        if moved is not None and mod.MOVES not in moved:
            continue
        value = mod.read(data)
        if value is not None:
            out.append((mod.NAME, mod.UNIT, float(value)))
    return out

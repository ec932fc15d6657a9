"""Cells, configurations and traffic mixes, found by name in their own files:
``workloads/<cell>.json``, ``configs/<config>.json``, ``traffic/<mix>.json``.
A new cell, configuration or mix is a new file; nothing here names one.  A
configuration's model (its family and reference files) is found the same
way, by the paths the configuration gives (``bench/families/``)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    spec: dict  # workloads/<name>.json
    model: dict  # configs/<spec["config"]>.json
    mix: dict  # traffic/<spec["traffic"]>.json

    @property
    def serve(self) -> dict:
        return self.spec["serve"]

    @property
    def check(self) -> dict:
        return self.spec["check"]


def _read(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (root / kind).glob("*.json"))
        raise SystemExit(f"no {kind[:-1]} {name!r} ({path}); known: {known}")
    return json.loads(path.read_text())


def load(name: str, root: Path = HERE) -> Cell:
    spec = _read("workloads", name, root)
    return Cell(name, spec, _read("configs", spec["config"], root),
                _read("traffic", spec["traffic"], root))

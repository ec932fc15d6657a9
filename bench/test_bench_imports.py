"""What a run loads: no module whose top-level name is ``jax`` or ``repro``
(compared whole: ``repro_torch`` is the program), checked in a fresh
interpreter, since the test process itself may hold JAX.  Without a card
the command line prints no result and exits 2.  Every reference file a
configuration names loads without the program."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
from bench import run, harness, testing, knee, calibrate
testing.run_tiny(seconds=0.5)
cuda = torch.cuda.is_available()
rc = None if cuda else run.main(["--workload", "nemo-chat", "--seed", "1", "--seconds", "1"])
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}), "rc": rc,
                  "forbidden": harness.forbidden_modules()}}))
"""

REFERENCES = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from bench import families
loaded = []
for folder in ("bench/configs", "bench/testdata/configs"):
    for path in sorted(Path(folder).glob("*.json")):
        loaded.append(families.reference(json.loads(path.read_text())).__file__)
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "loaded": loaded}}))
"""


def _probe(code: str) -> tuple[subprocess.CompletedProcess, dict]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT),
                                                            src=str(ROOT / "src"))],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out, json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out, got = _probe(PROBE)
    assert "repro_torch" in got["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])
    assert got["forbidden"] == []
    if got["rc"] is not None:
        assert got["rc"] == 2
        assert out.stdout.strip().splitlines()[-1].startswith('{"modules"')


def test_every_named_reference_loads_without_the_program():
    _, got = _probe(REFERENCES)
    configs = [p for d in ("configs", "testdata/configs") for p in (ROOT / "bench" / d).glob("*")]
    assert len(got["loaded"]) == len(configs) >= 4
    assert not {"repro_torch", "jax", "jaxlib", "flax", "repro"} & set(got["modules"])

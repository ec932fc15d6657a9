"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``bench/workloads/<cell>.json`` (its configuration and traffic
mix are named there).  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics and the device's busy time from a
profiled slice of the window.  The last line of standard output is one JSON
object; the numbers that decide ``correct`` close standard error, each with
its limit.  Without a CUDA card, or with fewer cards than the cell asks for,
it prints no result and exits 2.  Every cache it builds lives under the
checkout's ``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _dir)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell: bench/workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "--id=0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def emit(run: dict) -> None:
    """The info line, then each compared number beside its limit, closing
    standard error; then the result line, last on standard output."""
    result = run["result"]
    result["checks"] = result.pop("checks")  # the compared numbers come last
    print(json.dumps({"info": run["info"]}, default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from bench import cells, harness

    cell = cells.load(args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark and the port import neither JAX nor "
              f"the JAX package", file=sys.stderr)
        return 3
    run["result"]["device"]["power_limit_w"] = power_limit_w()
    emit(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phase alone on one CUDA card, then (with
``--dry-run-all``) the port's whole dry run.

    python3 tools/mesh_phase.py [--dry-run-all] [--jobs N] [--out FILE]

The mesh phase (``chip_smoke.phase_mesh``): the sharded train step on a
one-rank NCCL mesh against the plan-less step, bit for bit, the main
path's engine on the same mesh against the plain engine, and three dry-run
cells; one JSON line, with the card's name and power limit.  Then
``python -m repro_torch.launch.dryrun --all --mesh both --jobs N --out
FILE``: every (arch × shape × mesh) cell on fake groups of 256 and 512
ranks, N cells at once (the host's CPU does this work; nothing runs on the
card).  Without a card it exits.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run-all", action="store_true")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mesh_phase: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    with torch.inference_mode():
        chip_smoke.phase_mesh(card, torch.device("cuda", 0))
    if args.dry_run_all:
        from repro_torch.launch import dryrun

        dryrun.main(["--all", "--mesh", "both", "--jobs", str(args.jobs), "--out", args.out])


if __name__ == "__main__":
    main()

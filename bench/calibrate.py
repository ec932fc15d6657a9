"""The readings a cell's ``logit_gap`` limit is set from, on the card at the
cell's own size and load, many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seconds <s> --seeds 11,12,...

The program is set up once; for each seed its weights are made from that
seed and written into the engine's tensors in place (``Program.reseed``),
then a short window of the cell's traffic, the drain, and the plain
reference over the sample a run compares, with the control beside it (the
reference's products in float8 e4m3, the precision below the
configuration's bf16).  One JSON line per seed: the program's widest logit
gap, the control's, the tokens compared, and the verdict of the cell's
limit on each (``program_correct`` has to be true, ``control_correct``
false).  The lower reading is the largest program gap over the seeds, the
upper the smallest control gap; the limit goes between them (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run  # noqa: E402,F401  (sys.path, cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    import torch

    from bench import cells, harness

    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    prog = harness.Program(cell, seeds[0], device)
    for seed in seeds:
        t0 = time.perf_counter()
        if seed != seeds[0]:
            prog.reseed(seed)
        win = harness.Window(prog, cell, seed, args.seconds)
        m = win.run()
        got = harness.compare(cell, seed, win.served, device, control=True)
        checks, info = got["checks"], got["info"]
        limit = checks["logit_gap"]["limit"]
        others = all(c["value"] <= c["limit"] for k, c in checks.items() if k != "logit_gap")
        print(json.dumps({"seed": seed, "gap": info["program_gap"],
                          "control_gap": info["control_gap"], "limit": limit,
                          "program_correct": others and info["program_gap"] <= limit,
                          "control_correct": others and info["control_gap"] <= limit,
                          "tokens": info["compared_tokens"],
                          "requests": info["compared_requests"],
                          "unanswered": checks["unanswered"]["value"],
                          "malformed": checks["malformed"]["value"],
                          "tok_s": m["tok_s"], "reference_s": info["reference_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

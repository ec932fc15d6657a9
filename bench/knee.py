"""The knee sweep of an open-loop cell: the highest arrival rate the program
sustains, found once when the cell is defined and then fixed in its file.

    python3 bench/knee.py --workload <cell> --seed <n> --seconds <s> --rates 1,2,3

One process sets the program up once, then serves the cell's mix for
``--seconds`` at each rate (a fresh scheduler each time, the same engine and
graphs; nothing is drained).  One JSON line per rate: requests due, tok/s,
TTFT and TPOT p90, and the backlog (submitted, unfinished) at half time and
at the close.  The knee is the highest rate whose backlog does not grow from
half time to the close.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run as cli  # noqa: E402  (sys.path, cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    args = ap.parse_args(argv)
    import torch

    from bench import cells, harness

    if not torch.cuda.is_available():
        print("the knee sweep needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    prog = harness.Program(cell, args.seed, device)
    print(json.dumps({"setup_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(),
                      "power_limit_w": cli.power_limit_w()}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        prog.new_scheduler(args.seed)
        win = harness.Window(prog, cell, args.seed, args.seconds, rate=rate)
        m = win.run(drain=False)
        print(json.dumps({"rate_rps": rate, "due": m["attempted"], "tok_s": m["tok_s"],
                          "ttft_p90_ms": m["ttft_p90_ms"], "tpot_p90_ms": m["tpot_p90_ms"],
                          "backlog_half": win.backlog_mid, "backlog_close": win.backlog_end,
                          "window_captures": m["window_captures"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

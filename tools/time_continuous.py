#!/usr/bin/env python3
"""The continuous-serving cell's end-to-end times on one CUDA card, from one
tree's ``src``.

    python tools/time_continuous.py [--src DIR] [--label NAME] [--configs A,B]

tinyllama-1.1b at full width (random weights from seed 0, int8 weights at
sparsity 0.5 in (128, 128) blocks, bf16 compute), as ``chip_smoke.py``'s
continuous and speculative phases serve it: 32 requests at 100 requests/s
(prompts 4–64, 4–32 new tokens, seed 0) through
``launch.serve.run_poisson``, n_slots 4, segment_len 16, max_len 128,
block_len 16, in these configurations:

* plain decoding, dense and paged × scan and while;
* speculative decoding at k = 4, dense while, drafters ``truncate:1``,
  ``self`` (sparsity 0.75) and ``truncate:22`` (the whole model: every
  draft accepted).

Each runs once to capture its graphs, then 3 timed runs on the same draws.
Then one run under torch.profiler for the card's busy time against the
timed runs' median wall.  One JSON line per configuration: tok/s, p50/p95
latency and TTFT (median, min and max of 3), busy ms and the idle share,
the first run's tok/s, captures, capture seconds, the slot graphs' pool
bytes, segments, decode steps (rounds) with a live slot and the rounds run
past a while segment's stop, and the card's name and power limit.

``--src`` imports ``repro_torch`` from another tree's ``src`` (an unpacked
earlier commit), so two versions are compared on one card in one call:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CONFIGS = [("plain_dense_scan", "dense", "scan", None),
           ("plain_dense_while", "dense", "while", None),
           ("plain_paged_scan", "paged", "scan", None),
           ("plain_paged_while", "paged", "while", None),
           ("truncate1", "dense", "while", "truncate:1"),
           ("self075", "dense", "while", "self"),
           ("truncate22", "dense", "while", "truncate:22")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory to import repro_torch from")
    ap.add_argument("--label", default="", help="a name printed on every line")
    ap.add_argument("--configs", default=",".join(c[0] for c in CONFIGS),
                    help="comma-separated configuration names to run")
    opts = ap.parse_args()
    sys.path.insert(0, opts.src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_arch
    from repro_torch.serve.engine import SLOT_PROGRAMS, ServeConfig, ServeEngine, SpecConfig

    if not torch.cuda.is_available():
        sys.exit("time_continuous: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    build.load_library()
    arch = get_arch("tinyllama-1.1b")
    with torch.inference_mode():
        params = arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    args = serve.parse_args(["--workload", "poisson", "--n-requests", "32", "--rate", "100",
                             "--prompt-len", "64", "--new-tokens", "32", "--segment-len",
                             "16", "--seed", "0"])
    draws = serve._poisson_draws(args, arch.cfg.vocab_size)
    for name, layout, mode, draft in CONFIGS:
        if name not in opts.configs.split(","):
            continue
        sc = ServeConfig(max_len=128, kv_layout=layout, block_len=16, weight_quant="int8",
                         weight_quant_sparsity=0.5,
                         spec=SpecConfig(k=4, draft=draft) if draft else None)
        eng = ServeEngine(arch, params, sc, device=dev)
        args.segment_mode, args.kv_layout = mode, layout
        useful, total, sched, _ = serve.run_poisson(eng, args, draws, verbose=False)
        first_tok_s = useful / total
        captured = dict(eng.trace_counts)
        timed = []
        for _ in range(3):
            useful, total, sched, handles = serve.run_poisson(eng, args, draws, verbose=False)
            timed.append(serve.report_poisson(eng, useful, total, sched, handles))
        if eng.trace_counts != captured or sched.stats["admitted"] != sched.stats["retired"]:
            raise AssertionError(f"{name} {layout} {mode}: a timed run captured or did "
                                 f"not drain")
        st = sched.stats
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve.run_poisson(eng, args, draws, verbose=False)
        busy_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA) / 1e6
        wall_ms = statistics.median(1e3 * t["seconds"] for t in timed)
        print(json.dumps({
            "label": opts.label, "card": card, "config": name, "layout": layout,
            "segment_mode": mode, "tokens": timed[-1]["tokens"],
            "spread_of_3": {k: {"median": statistics.median(t[k] for t in timed),
                                "min": min(t[k] for t in timed),
                                "max": max(t[k] for t in timed)}
                            for k in timed[0] if k.endswith(("_s", "_ms"))},
            "device_busy_ms": busy_ms, "wall_ms_median": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "first_run_tok_s": first_tok_s,
            "captures": {k: eng.trace_counts[k] for k in SLOT_PROGRAMS if eng.trace_counts[k]},
            "capture_seconds": sum(eng.capture_seconds[k] for k in SLOT_PROGRAMS),
            "pool_reserved_bytes": eng.slot_graph_bytes, "segments": st["segments"],
            "steps_total": st["steps_total"], "steps_predicated": st["steps_predicated"],
            "accepted_hist": {int(n): c for n, c in sorted(st["accepted_hist"].items())},
        }), flush=True)
        del eng, sched
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

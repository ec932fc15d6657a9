#!/usr/bin/env python3
"""The dense bf16 prefill's time on one CUDA card, from one tree's ``src``.

    python tools/time_dense_prefill.py [--src DIR] [--label NAME] [--reps N]

tinyllama-1.1b at full width, random bf16 weights from seed 0, served
unquantized (every projection a cuBLAS ``x @ W`` through
``layers.dense_apply``), greedy batch 4 × prompt 64 (M = 256 rows a
projection) on the "scan" loop: ``generate(prompts, 1)`` replays the
captured prefill graph.  One JSON line: host ms of that call (median, min,
max of ``--reps`` after a capturing run), the card's busy ms and kernel
count in one call (torch.profiler), the first tokens, and the card's name
and power limit.

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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory to import repro_torch from")
    ap.add_argument("--label", default="", help="a name printed on the line")
    ap.add_argument("--reps", type=int, default=15)
    opts = ap.parse_args()
    sys.path.insert(0, opts.src)
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.registry import get_arch
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    if not torch.cuda.is_available():
        sys.exit("time_dense_prefill: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    arch = get_arch("tinyllama-1.1b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.replace(param_dtype="bfloat16"))
    with torch.inference_mode():
        params = arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)
        eng = ServeEngine(arch, params, ServeConfig(max_len=97), device=dev)
        prompts = torch.randint(0, arch.cfg.vocab_size, (4, 64), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
        first = eng.generate(prompts, 1)  # the real prefill, then its capture
        times = []
        for _ in range(opts.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(prompts, 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, 1)
            torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    print(json.dumps({"tool": "time_dense_prefill", "label": opts.label, "src": opts.src,
                      "card": card, "model": "tinyllama-1.1b", "batch": 4, "prompt_len": 64,
                      "rows": 256, "captures": dict(eng.trace_counts)["prefill"],
                      "prefill_ms": {"median": statistics.median(times), "min": min(times),
                                     "max": max(times)},
                      "busy_ms": sum(e.duration_ns() for e in evs) / 1e6,
                      "device_kernels": len(evs), "first_tokens": first[:, 0].tolist()}),
          flush=True)


if __name__ == "__main__":
    main()

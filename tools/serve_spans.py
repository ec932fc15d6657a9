#!/usr/bin/env python3
"""The port's own serving spans in one benchmark cell on the card, beside the
benchmark's readings of the same run, and what the port's tracing costs.

    python3 tools/serve_spans.py --workload <cell> --seeds A,B,C,D [--seconds 50] [--out F]

The cell's program is set up once (``bench.harness.Program``); a new
scheduler takes ``ServeConfig.trace`` as the engine then holds it, so the
port's tracing is switched between windows, each on its seed's weights
(``Program.reseed``).  Every seed but the last: two untraced windows of the
cell's traffic, the port's tracing off and on, in turns (off first on the
first seed, on first on the next, ...), read as ``bench/run.py --trace 0``
reads them (``tpot_p90_ms``, ``tok_s``), and with tracing on the port's
own decode device ms per round and ``decode_stall_ms``, with no wrapper of
the harness's around its calls.  The last seed: the run
``bench/run.py --trace 1`` makes (the harness's wrappers, CUDA events and
profiled slice), with the port's tracing on beside it and its spans cleared
at the window's start.  It prints the benchmark's per-layer metrics; the
port's ``span_summary``; ``decode_stall_ms`` and ``host_idle_share``
(``bench/spans.py``, over the idle split by the innermost of the port's
spans and the harness's ``bench.`` ranges); that split, and the one over
the port's spans alone; and
four agreements: the port's decode device ms per round against
``decode_step_ms``, its prefill device ms per 1,000 real tokens against
``prefill_ms_per_ktok``, ``decode_step_ms`` + ``decode_stall_ms`` against
the mean TPOT (per request, and per token), and the idle seconds by span
against the slice's.  ``clock_match``: the share of the slice's
``bench.decode`` ranges (the profiler's clock) that hold a ``serve.decode``
span (the port's) within 200 µs.

One JSON line per window on standard output; all of them, with the card's
name and power limit, in ``--out`` (default
``results/serve_spans-<cell>.json`` under the checkout).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from bench import run  # noqa: E402  (sys.path, cache directories)

SLACK_NS = 200_000


def set_trace(prog, on: bool, seed: int) -> None:
    """The seed's weights and a new scheduler, traced by the port or not."""
    prog.engine.sc = dataclasses.replace(prog.engine.sc, trace=on)
    prog.reseed(seed)


def tpot_means(served) -> dict:
    """Mean TPOT over requests with ≥ 2 tokens, per request and per token."""
    done = [s for s in served if s.n >= 2]
    if not done:
        return {"per_request_ms": None, "per_token_ms": None}
    return {"per_request_ms": 1e3 * statistics.fmean((s.last - s.first) / (s.n - 1)
                                                      for s in done),
            "per_token_ms": 1e3 * sum(s.last - s.first for s in done)
            / sum(s.n - 1 for s in done)}


def untraced(prog, cell, seed: int, seconds: float, on: bool) -> dict:
    from bench import harness, spans

    set_trace(prog, on, seed)
    win = harness.Window(prog, cell, seed, seconds)
    m = win.run()
    out = {"seed": seed, "port_trace": on, "tok_s": m["tok_s"],
           "tpot_p90_ms": m["tpot_p90_ms"], "ttft_p90_ms": m["ttft_p90_ms"],
           "failed": m["failed"], **tpot_means(win.served)}
    if on:  # the port's own readings, with no wrapper of the harness's around its calls
        program = prog.scheduler.trace.span_summary()
        program.pop("intervals")
        dec = program["decode"]
        out.update(decode_ms_per_round=ratio(dec["device_ms"], dec["rounds"]),
                   decode_stall_ms=spans.decode_stall_ms({"program": program}), program=program)
    return out


def ratio(a, b):
    return a / b if a is not None and b else None


def clock_match(serve: list, ranges: list) -> float | None:
    """Share of the slice's ``bench.decode`` ranges holding a
    ``serve.decode`` span within ``SLACK_NS``."""
    outer = [(s, e) for s, e, n in ranges if n == "bench.decode"]
    inner = [(s, e) for s, e, n in serve if n == "serve.decode"]
    if not outer:
        return None
    hit = sum(any(s - SLACK_NS <= a and b <= e + SLACK_NS for a, b in inner) for s, e in outer)
    return hit / len(outer)


def traced(prog, cell, seed: int, seconds: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from bench import harness, metrics, spans
    from bench.tracing import Recorder, reduce_profile

    set_trace(prog, True, seed)
    rec = Recorder(cell.model, prog.device)
    rec.install(prog.engine, prog.scheduler)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        prog.sync()
    tr = prog.scheduler.trace
    tr.clear_spans()
    win = harness.Window(prog, cell, seed, seconds, rec)
    m = win.run()
    program = tr.span_summary()
    prof = reduce_profile(win.profile)
    device, w0, w1, ranges = spans.profile_intervals(win.profile)
    serve = program["intervals"]
    prof["idle_by_span"] = spans.idle_by_span(device, w0, w1, serve + ranges)
    data = {"stats": m["stats"], "spans": rec.summary(), "profile": prof, "program": program}
    bench = {name: v for name, _, v in metrics.read_all(data, cell.spec["end_to_end"])}
    stall, host_idle = spans.decode_stall_ms(data), spans.host_idle_share(data)
    serve_only = spans.idle_by_span(device, w0, w1, serve)
    dec, pre = program["decode"], program["prefill"]
    means = tpot_means(win.served)
    step = bench.get("decode_step_ms")
    idle_s = prof["window_s"] - prof["busy_s"]
    agree = {
        "decode_ms_per_round": [ratio(dec["device_ms"], dec["rounds"]), step],
        "prefill_ms_per_ktok": [ratio(pre["device_ms"],
                                      pre["real_tokens"] / 1e3),
                                bench.get("prefill_ms_per_ktok")],
        "step_plus_stall_vs_tpot_mean": [step + stall if step and stall is not None else None,
                                         means["per_request_ms"], means["per_token_ms"]],
        "idle_by_span_vs_idle_s": [sum(prof["idle_by_span"].values()), idle_s],
    }
    for k, v in agree.items():
        print(f"agree {cell.name} {k} {v}", file=sys.stderr)
    program.pop("intervals")
    return {"seed": seed, "traced": True, "tok_s": m["tok_s"], "tpot_p90_ms": m["tpot_p90_ms"],
            "tpot_mean": means, "bench_metrics": bench, "decode_stall_ms": stall,
            "host_idle_share": host_idle, "idle_s": idle_s, "window_s": prof["window_s"],
            "idle_by_span": prof["idle_by_span"], "idle_by_serve_span": serve_only,
            "idle_gaps": prof["idle_gaps"], "clock_match": clock_match(serve, ranges),
            "agree": agree, "program": program}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated; the last one traced")
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out", help="the JSON file (default: results/serve_spans-<cell>.json)")
    args = ap.parse_args(argv)
    import torch

    from bench import cells, harness

    if not torch.cuda.is_available():
        print("serve_spans needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = cells.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    prog = harness.Program(cell, seeds[0], device)
    out = {"workload": cell.name, "card": torch.cuda.get_device_name(device),
           "power_limit_w": run.power_limit_w(), "setup_s": time.perf_counter() - t0,
           "windows": []}
    with torch.inference_mode():
        for i, seed in enumerate(seeds[:-1]):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                line = untraced(prog, cell, seed, args.seconds, on)
                out["windows"].append(line)
                print(json.dumps(line), flush=True)
        line = traced(prog, cell, seeds[-1], args.seconds)
        out["windows"].append(line)
        print(json.dumps(line, default=str), flush=True)
    dest = Path(args.out) if args.out else ROOT / "results" / f"serve_spans-{cell.name}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

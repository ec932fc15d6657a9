"""HTTP serving launcher: the continuous scheduler behind a front door.

The port of ``repro.launch.http_serve``: builds the engine with
``launch/serve.py``'s ``build_engine`` (random weights from ``--seed`` on
the device, the kernels built there first on the card) and a
``ContinuousScheduler`` with the poisson workload's knobs, wraps them in
the asyncio ``FrontDoor`` (SSE streaming, disconnect-cancel propagation,
bounded admission with 429 backpressure, graceful drain on Ctrl-C), and
serves ``POST /v1/generate`` / ``GET /healthz`` / ``GET /v1/stats``.
Every flag of the reference's (but its mesh), plus the port's ``--device``,
``--weight-quant*``, ``--cache-quant-int8`` and ``--spec-*``.  Without
``--device cpu`` it targets the card and exits when there is none.

Usage, on the card:
    PYTHONPATH=src python -m repro_torch.launch.http_serve \\
        --weight-quant int8 --weight-quant-sparsity 0.5 --kv-layout paged \\
        --port 0 --tenant acme:3 --tenant hobby:1 --trace --smoke 6
On the CPU, at test size:
    PYTHONPATH=src python -m repro_torch.launch.http_serve --reduced \\
        --device cpu --kv-layout paged --port 0 --tenant acme:3 \\
        --tenant hobby:1 --trace --smoke 6
``--smoke N`` serves, drives N seeded in-process SSE clients round-robin
over the tenants, prints a summary, drains, and exits 0 only if every
stream finished clean.  Without it the server runs until Ctrl-C, then
drains.

Request body:
    {"prompt": [1, 2, 3], "max_new_tokens": 16,
     "tenant": "acme", "priority": "interactive", "stream": true}
"""
from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from repro_torch.configs.base import ALL_ARCH_IDS
from repro_torch.launch.serve import build_engine
from repro_torch.serve.http import FrontDoor, HttpConfig, generate
from repro_torch.serve.policy import TenantPolicy, TenantSpec
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.utils.logging import get_logger

log = get_logger("launch.http_serve")


def _parse_tenant(spec: str) -> tuple[str, TenantSpec]:
    """``name[:weight[:rate[:priority]]]`` — empty fields inherit defaults
    (e.g. ``hobby:1:0.5:batch``, ``acme:3``, ``spot:::batch``)."""
    parts = spec.split(":")
    if not parts[0]:
        raise SystemExit(f"--tenant '{spec}': empty tenant name")
    try:
        weight = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
        rate = float(parts[2]) if len(parts) > 2 and parts[2] else None
        priority = parts[3] if len(parts) > 3 and parts[3] else "standard"
        return parts[0], TenantSpec(weight=weight, rate=rate,
                                    default_priority=priority)
    except ValueError as e:
        raise SystemExit(f"--tenant '{spec}': {e}") from e


async def _smoke(fd: FrontDoor, args, vocab: int) -> int:
    """Seeded in-process client sweep: N concurrent streaming requests
    round-robined over the configured tenants; returns a process exit
    code (0 = every stream reached a clean terminal event)."""
    rng = np.random.RandomState(args.seed)
    tenants = [t.split(":")[0] for t in args.tenant] or [None]
    payloads = []
    for i in range(args.smoke):
        plen = int(rng.randint(4, max(args.prompt_len, 5)))
        payloads.append({
            "prompt": [int(t) for t in rng.randint(0, vocab, plen)],
            "max_new_tokens": int(rng.randint(4, args.new_tokens + 1)),
            "tenant": tenants[i % len(tenants)],
        })
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        generate(fd.cfg.host, fd.port, p) for p in payloads])
    dt = time.perf_counter() - t0
    bad = 0
    tokens = 0
    for i, (p, o) in enumerate(zip(payloads, outs)):
        body = o.get("body") or {}
        ok = (o["status"] == 200 and body.get("finish_reason") == "length"
              and len(body.get("tokens", ())) == p["max_new_tokens"])
        bad += not ok
        tokens += len(body.get("tokens", ()))
        log.info("smoke r%-2d status=%s finish=%s tokens=%d ttft=%s",
                 i, o["status"], body.get("finish_reason"),
                 len(body.get("tokens", ())),
                 f"{o['ttft_s']:.3f}s" if o["ttft_s"] else "-")
    log.info("smoke: %d/%d clean, %d tokens in %.2fs (%.1f tok/s)",
             args.smoke - bad, args.smoke, tokens, dt, tokens / dt)
    return 1 if bad else 0


async def _serve(fd: FrontDoor, args, vocab: int) -> int:
    await fd.start()
    log.info("serving on http://%s:%d  (POST /v1/generate, GET /healthz, "
             "GET /v1/stats)", fd.cfg.host, fd.port)
    code = 0
    try:
        if args.smoke:
            code = await _smoke(fd, args, vocab)
        else:
            while True:  # Ctrl-C drains below
                await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        log.info("interrupt — draining")
    finally:
        await fd.stop()
        st = fd.stats
        log.info("front door: %d requests — %d accepted, %d completed, "
                 "%d disconnects, %d backpressure / %d rate 429s",
                 st["http_requests"], st["accepted"], st["completed"],
                 st["disconnects"], st["rejected_backpressure"],
                 st["rejected_rate"])
        if fd.sched.policy is not None:
            for name, row in fd.sched.policy.snapshot().items():
                log.info("tenant %-12s weight=%.1f submitted=%d admitted=%d "
                         "tokens=%d rate-rejections=%d", name, row["weight"],
                         row["submitted"], row["admitted"],
                         row["served_tokens"], row["rate_rejections"])
        if fd.worker is not None and fd.worker.error is not None:
            code = 1
    return code


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777,
                    help="listen port (0 = ephemeral, printed at startup)")
    ap.add_argument("--seed", type=int, default=0)
    # capacity: the prompt/new-token bounds a request may ask for
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="largest prompt the server accepts")
    ap.add_argument("--new-tokens", type=int, default=64,
                    help="largest generation budget the server accepts")
    # the served weights and cache
    ap.add_argument("--weight-quant", default="none", choices=("none", "int8"),
                    help="serve int8 block-sparse weights through the "
                         "hand-written kernels")
    ap.add_argument("--weight-quant-sparsity", type=float, default=0.0,
                    help="block-prune the served weights to this sparsity "
                         "before int8 quantization (requires --weight-quant int8)")
    ap.add_argument("--cache-quant-int8", action="store_true",
                    help="store the KV cache as int8 with one fp32 scale per "
                         "position and head")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft this many tokens per "
                         "round (0 = off)")
    ap.add_argument("--spec-draft", default="self",
                    help="drafter: 'self' or 'truncate:N'")
    ap.add_argument("--spec-sparsity", type=float, default=0.75,
                    help="weight sparsity of the 'self' drafter")
    # scheduler knobs (the poisson-workload subset that matters online)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment-len", type=int, default=16)
    ap.add_argument("--segment-mode", default="while",
                    choices=("scan", "while"))
    ap.add_argument("--kv-layout", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--block-len", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-buckets", type=int, default=4)
    ap.add_argument("--prefill-token-budget", type=int, default=0)
    ap.add_argument("--overcommit", type=float, default=1.0)
    ap.add_argument("--preempt-mode", default="recompute",
                    choices=("recompute", "swap"))
    ap.add_argument("--trace", action="store_true",
                    help="per-segment trace + per-tenant tok/s and J/token "
                         "in GET /v1/stats")
    # multi-tenant policy
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME[:WEIGHT[:RATE[:PRIORITY]]]",
                    help="register a tenant (repeatable): DRR weight "
                         "(default 1), token-bucket rate in req/s (default "
                         "unlimited), default priority class (interactive/"
                         "standard/batch)")
    ap.add_argument("--quantum", type=int, default=64,
                    help="DRR quantum in tokens per scheduling visit")
    # front-door knobs
    ap.add_argument("--max-pending", type=int, default=64,
                    help="admission bound: queued submissions past this get "
                         "429 + Retry-After")
    ap.add_argument("--heartbeat", type=float, default=10.0,
                    help="SSE keepalive seconds under token silence")
    ap.add_argument("--drain-timeout", type=float, default=30.0)
    ap.add_argument("--smoke", type=int, default=0, metavar="N",
                    help="self-test: drive N seeded in-process clients, "
                         "print a summary, drain, exit (0 = serve forever)")
    args = ap.parse_args(argv)
    if args.overcommit != 1.0 and args.kv_layout != "paged":
        ap.error("--overcommit requires --kv-layout paged")
    if args.preempt_mode == "swap" and args.kv_layout != "paged":
        ap.error("--preempt-mode swap requires --kv-layout paged")
    if args.n_blocks is not None and args.kv_layout != "paged":
        ap.error("--n-blocks requires --kv-layout paged")
    if args.prefill_token_budget and not args.prefill_chunk:
        ap.error("--prefill-token-budget requires --prefill-chunk")
    if args.weight_quant_sparsity and args.weight_quant != "int8":
        ap.error("--weight-quant-sparsity requires --weight-quant int8")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    # what build_engine reads of the serve launcher's flags: the engine
    # serves the continuous scheduler (max_len in whole blocks and chunks),
    # greedy, its slot programs as CUDA graphs on the card
    args.workload, args.loop, args.temperature, args.eos_token = "poisson", "scan", 0.0, -1
    return args


def build_front_door(args: argparse.Namespace) -> FrontDoor:
    """Engine, scheduler (with a ``TenantPolicy`` when tenants or a quantum
    are given) and the front door over them."""
    policy = None
    if args.tenant or args.quantum != 64:
        policy = TenantPolicy(
            tenants=dict(_parse_tenant(t) for t in args.tenant),
            quantum=args.quantum)
    eng = build_engine(args)
    sched = ContinuousScheduler(
        eng, n_slots=args.slots, segment_len=args.segment_len,
        segment_mode=args.segment_mode, seed=args.seed, n_blocks=args.n_blocks,
        prefill_chunk=args.prefill_chunk,
        prefill_buckets=args.prefill_buckets,
        prefill_token_budget=args.prefill_token_budget,
        overcommit=args.overcommit, preempt_mode=args.preempt_mode,
        policy=policy)
    return FrontDoor(sched, HttpConfig(
        host=args.host, port=args.port, max_pending=args.max_pending,
        heartbeat_s=args.heartbeat, drain_timeout_s=args.drain_timeout))


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    fd = build_front_door(args)
    try:
        code = asyncio.run(_serve(fd, args, fd.sched.engine.cfg.vocab_size))
    except KeyboardInterrupt:
        # _serve already drained (asyncio.run cancels the task, delivering
        # CancelledError into it, before re-raising the interrupt here)
        code = 0
    raise SystemExit(code)


if __name__ == "__main__":
    main()

"""Serving launcher, two workloads as in the reference's:

  batch    (default) one fixed batch through ``ServeEngine.generate``;
           prints tok/s and the first two token rows.
  poisson  continuous batching: requests arrive on a simulated Poisson
           process (seeded numpy draws, ``_poisson_draws``) with ragged
           prompt and output lengths and stream through
           ``serve.scheduler.ContinuousScheduler``; per-segment progress
           and request 0's tokens print live, then tok/s and p50/p95
           latency and TTFT.

Weights are random, made from ``--seed`` on the device; batch prompts from
``--seed + 1``.  ``--loop`` picks the decode loop (``scan``, the default:
one CUDA graph per decode step, replayed; ``while``: the same with an eos
early exit; ``python``: the eager loop; on the poisson workload "python"
runs the slot programs eagerly) and ``--cache-quant-int8`` the int8 KV
cache, as in the reference's launcher.  ``--spec-k`` (poisson workload,
greedy) turns on speculative decoding with the drafter ``--spec-draft``
("self": the weights pruned to ``--spec-sparsity`` and kept block-sparse;
"truncate:N": the first N layers) and gives max_len ``spec_k`` positions of
headroom; each segment's line then says the mean accepted tokens per
round, and the summary gives the acceptance histogram.  ``--trace``
(poisson) records the serving trace (``serve/trace.py``: host counters
priced through the analytic roofline) and ends with its totals and the
photonic model's energy per token; ``--autotune`` (poisson) picks
segment_len / prefill_chunk / block_len / spec_k with the analytic
autotuner (``roofline/autotune.py``, priced on the H100's peak rates)
before serving, and with ``--trace`` on a speculative run re-ranks with the
acceptance length the run measured, as the reference's launcher does.

Usage, on the card (the CUDA kernels build into ``build/`` at first use,
before the timed run):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --weight-quant int8 --weight-quant-sparsity 0.5 \
        --batch 4 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --weight-quant int8 --weight-quant-sparsity 0.5 --workload poisson \
        --n-requests 32 --rate 100 --prompt-len 64 --new-tokens 32
On the CPU, at test size (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --weight-quant int8 --weight-quant-sparsity 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --weight-quant int8 --weight-quant-sparsity 0.5 --workload poisson \
        --n-requests 10 --rate 200 --new-tokens 24 --kv-layout paged
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --workload poisson --spec-k 2 --spec-draft truncate:1
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --workload poisson --trace --autotune
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs.base import ALL_ARCH_IDS
from repro_torch.kernels import build
from repro_torch.models.registry import get_arch
from repro_torch.serve.chaos import ChaosConfig
from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
from repro_torch.serve.request import SubmitRequest
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--loop", default="scan", choices=("scan", "while", "python"),
                    help="decode loop: one CUDA graph per decode step replayed "
                         "(scan, default), the same with an eos early exit "
                         "(while), or the eager host loop (python)")
    ap.add_argument("--eos-token", type=int, default=-1)
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
                         "round and verify them in one forward of the served "
                         "model (0 = off; greedy only; poisson workload)")
    ap.add_argument("--spec-draft", default="self",
                    help="drafter: 'self' (the weights pruned to "
                         "--spec-sparsity, kept block-sparse) or 'truncate:N' "
                         "(the first N layers, reading the verifier's KV)")
    ap.add_argument("--spec-sparsity", type=float, default=0.75,
                    help="weight sparsity of the 'self' drafter (0.0 = an "
                         "exact copy, full acceptance)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--workload", default="batch", choices=("batch", "poisson"),
                    help="batch: one static batch; poisson: simulated arrivals "
                         "through the slot scheduler")
    # poisson-workload knobs
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment-len", type=int, default=16)
    ap.add_argument("--segment-mode", default="while", choices=("scan", "while"))
    ap.add_argument("--kv-layout", default="dense", choices=("dense", "paged"),
                    help="slot-cache layout: dense max_len rows (default) or "
                         "a paged block pool + block table")
    ap.add_argument("--block-len", type=int, default=16,
                    help="paged layout: tokens per KV block (the launcher "
                         "rounds max_len up to whole blocks)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged layout: allocatable pool blocks (default: "
                         "dense-equivalent n_slots x max_len/block_len)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="batched/chunked admission: split prompts into "
                         "chunks of this many tokens (a power of two; the "
                         "launcher rounds max_len up to whole chunks) and "
                         "prefill same-bucket chunks for several slots in "
                         "one launch; 0 = per-request admission")
    ap.add_argument("--prefill-buckets", type=int, default=4,
                    help="chunked admission: final chunks pad up to this "
                         "many power-of-two bucket lengths")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="Sarathi-style admit rounds: advance up to this "
                         "many real prefill tokens per round (requires "
                         "--prefill-chunk; 0 = one chunk per prefilling "
                         "slot per round)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="paged admission: admit while committed full "
                         "budgets fit overcommit x pool capacity (>1.0 "
                         "enables mid-flight preemption when the pool runs "
                         "dry)")
    ap.add_argument("--preempt-mode", default="recompute",
                    choices=("recompute", "swap"),
                    help="how evicted requests readmit: re-prefill the "
                         "prompt + replay emitted tokens (default), or host "
                         "KV swap-out/swap-in")
    ap.add_argument("--ttft-deadline", type=float, default=None,
                    help="per-request first-token deadline in seconds "
                         "(missed -> status 'expired')")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request total deadline in seconds")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-injection RNG seed (with the --chaos-* "
                         "probabilities below)")
    ap.add_argument("--chaos-exhaust-prob", type=float, default=0.0,
                    help="fault injection: per-segment probability of "
                         "forcing pool exhaustion (paged only)")
    ap.add_argument("--chaos-cancel-prob", type=float, default=0.0,
                    help="fault injection: per-segment probability of "
                         "cancelling a random live request")
    ap.add_argument("--chaos-slot-fail-prob", type=float, default=0.0,
                    help="fault injection: per-segment probability of "
                         "failing a random occupied slot (its request "
                         "retires to the queue and readmits)")
    ap.add_argument("--trace", action="store_true",
                    help="record per-segment phase traces (host-side counters "
                         "priced through the analytic roofline) and print an "
                         "energy-per-token report at the end (poisson)")
    ap.add_argument("--autotune", action="store_true",
                    help="pick segment_len/prefill_chunk/block_len/spec_k from "
                         "the analytic autotuner before serving (poisson; "
                         "overrides those flags)")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--batch, --prompt-len and --new-tokens must be >= 1")
    if args.weight_quant_sparsity and args.weight_quant != "int8":
        ap.error("--weight-quant-sparsity requires --weight-quant int8")
    if not 0.0 <= args.weight_quant_sparsity < 1.0:
        ap.error("--weight-quant-sparsity must be in [0, 1)")
    poisson_only = {"--kv-layout paged": args.kv_layout == "paged",
                    "--prefill-chunk": bool(args.prefill_chunk),
                    "--chaos-*": bool(args.chaos_exhaust_prob or args.chaos_cancel_prob
                                      or args.chaos_slot_fail_prob),
                    "--trace": args.trace, "--autotune": args.autotune}
    for flag, given in poisson_only.items():
        if given and args.workload != "poisson":
            ap.error(f"{flag} only applies to the slot scheduler: pass --workload poisson")
    if args.n_blocks is not None and args.kv_layout != "paged":
        ap.error("--n-blocks requires --kv-layout paged")
    if args.prefill_token_budget and not args.prefill_chunk:
        ap.error("--prefill-token-budget requires --prefill-chunk")
    if args.overcommit < 1.0:
        ap.error("--overcommit must be >= 1.0")
    if args.overcommit != 1.0 and args.kv_layout != "paged":
        ap.error("--overcommit requires --kv-layout paged (dense slots have no "
                 "block pool to overcommit)")
    if args.preempt_mode == "swap" and args.kv_layout != "paged":
        ap.error("--preempt-mode swap requires --kv-layout paged")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    if args.spec_k and args.workload != "poisson":
        ap.error("--spec-k only applies to the slot scheduler: pass --workload poisson")
    if args.spec_k and args.temperature > 0:
        ap.error("speculative decoding is greedy-only: --spec-k needs --temperature 0")
    return args


def build_engine(args: argparse.Namespace) -> ServeEngine:
    """Random weights from ``args.seed`` made on the device, quantized there
    by the engine; on the card the kernels are built here too, as set-up."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu to run "
                             "on the CPU")
        build.load_library()
    arch = get_arch(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = arch.init_params(gen, device)
    # speculation writes up to spec_k rejected-tail tokens past the cursor
    max_len = args.prompt_len + args.new_tokens + 1 + args.spec_k
    if args.workload == "poisson":
        # round up so max_len is whole blocks (paged) and whole prefill
        # chunks (chunked admission), both at once via the lcm
        quantum = args.block_len if args.kv_layout == "paged" else 1
        if args.prefill_chunk:
            quantum = math.lcm(quantum, args.prefill_chunk)
        max_len += (-max_len) % quantum
    sc = ServeConfig(
        max_len=max_len,
        temperature=args.temperature,
        eos_token=args.eos_token,
        loop=args.loop,
        kv_layout=args.kv_layout,
        block_len=args.block_len,
        weight_quant=args.weight_quant,
        weight_quant_sparsity=args.weight_quant_sparsity,
        spec=(SpecConfig(k=args.spec_k, draft=args.spec_draft,
                         draft_sparsity=args.spec_sparsity) if args.spec_k else None),
        trace=args.trace,
    )
    return ServeEngine(arch, params, sc, device=device,
                       cache_quant_int8=args.cache_quant_int8)


def make_prompts(args: argparse.Namespace, vocab_size: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(args.seed + 1)
    return torch.randint(0, vocab_size, (args.batch, args.prompt_len), generator=gen)


def run_batch(eng: ServeEngine, args: argparse.Namespace) -> torch.Tensor:
    """Generate once and report; returns the (batch, new_tokens) tokens."""
    prompts = make_prompts(args, eng.cfg.vocab_size)
    gen = torch.Generator(device=eng.device).manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.new_tokens, gen)
    out = out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "cpu")
    log.info("generated %s tokens in %.3fs (%.1f tok/s) on %s", tuple(out.shape), dt,
             args.batch * args.new_tokens / dt, where)
    print(out[:2].numpy())
    return out


def _poisson_draws(args: argparse.Namespace, vocab: int):
    """The poisson workload's draws, the reference's numpy draws from
    ``--seed``: (arrival times s, prompt lengths, new-token budgets,
    prompts)."""
    if args.rate <= 0:
        raise SystemExit("--rate must be > 0")
    if args.n_requests < 1:
        raise SystemExit("--n-requests must be >= 1")
    rng = np.random.RandomState(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.n_requests))
    min_plen = min(4, args.prompt_len)  # ragged draw floor, prompt_len cap
    p_lens = rng.randint(min_plen, args.prompt_len + 1, args.n_requests)
    n_news = rng.randint(max(args.new_tokens // 8, 1), args.new_tokens + 1,
                         args.n_requests)
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in p_lens]
    return arrivals, p_lens, n_news, prompts


def run_poisson(eng: ServeEngine, args: argparse.Namespace, draws=None, verbose: bool = True):
    """Serve the poisson workload in real time: each request is submitted
    once its arrival time has passed, segments run while there is work.
    ``verbose`` streams request 0's tokens and logs each arrival and
    segment.  Returns (useful tokens, seconds, scheduler, handles)."""
    say = log.info if verbose else log.debug
    arrivals, p_lens, n_news, prompts = (
        draws if draws is not None else _poisson_draws(args, eng.cfg.vocab_size))

    def stream0(req, tok):  # live token stream for the first request
        print(f"  [r0 stream] +{tok}", flush=True)

    chaos = None
    if args.chaos_exhaust_prob or args.chaos_cancel_prob or args.chaos_slot_fail_prob:
        chaos = ChaosConfig(seed=args.chaos_seed, exhaust_prob=args.chaos_exhaust_prob,
                            cancel_prob=args.chaos_cancel_prob,
                            slot_fail_prob=args.chaos_slot_fail_prob)
    sched = ContinuousScheduler(eng, n_slots=args.slots, segment_len=args.segment_len,
                                segment_mode=args.segment_mode, seed=args.seed,
                                n_blocks=args.n_blocks, prefill_chunk=args.prefill_chunk,
                                prefill_buckets=args.prefill_buckets,
                                prefill_token_budget=args.prefill_token_budget,
                                overcommit=args.overcommit, preempt_mode=args.preempt_mode,
                                chaos=chaos)
    handles = []
    t0 = time.perf_counter()
    next_arrival = 0
    while next_arrival < args.n_requests or sched.has_work():
        now = time.perf_counter() - t0
        while next_arrival < args.n_requests and arrivals[next_arrival] <= now:
            i = next_arrival
            handles.append(sched.submit(SubmitRequest(
                prompts[i], int(n_news[i]),
                on_token=stream0 if i == 0 and verbose else None,
                ttft_deadline_s=args.ttft_deadline,
                deadline_s=args.deadline,
            )))
            say("arrive  r%-3d t=%.3fs prompt=%d max_new=%d",
                      i, now, p_lens[i], n_news[i])
            next_arrival += 1
        if sched.has_work():
            running = sched.run_segment()
            st = sched.stats
            spec_note = ""
            if sched.spec is not None and st["spec_steps"]:
                spec_note = f" accepted={st['spec_emitted'] / st['spec_steps']:.2f}tok/step"
            say("segment %-3d running=%d queued=%d admitted=%d retired=%d "
                "steps=%d%s", st["segments"], running, len(sched.queue),
                st["admitted"], st["retired"], st["steps_total"], spec_note)
        elif next_arrival < args.n_requests:
            time.sleep(max(arrivals[next_arrival] - (time.perf_counter() - t0), 0.0))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    total = time.perf_counter() - t0
    useful = sum(len(h.tokens) for h in handles)
    return useful, total, sched, handles


def report_poisson(eng: ServeEngine, useful: int, total: float, sched: ContinuousScheduler,
                   handles: list) -> dict:
    """Log the run's summary, the reference's lines; returns its numbers."""
    # cancelled/expired requests may never emit: percentile what finished
    lats = np.asarray([h.latency for h in handles if h.latency is not None])
    ttfts = np.asarray([h.ttft for h in handles if h.ttft is not None])
    st = sched.stats
    where = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "cpu")
    log.info("served %d requests / %d tokens in %.2fs — %.1f tok/s on %s",
             len(handles), useful, total, useful / total, where)
    out = {"requests": len(handles), "tokens": useful, "seconds": total,
           "tok_s": useful / total}
    if len(lats) and len(ttfts):
        out.update({f"{name}_p{q}_ms": 1e3 * float(np.percentile(v, q))
                    for name, v in (("latency", lats), ("ttft", ttfts)) for q in (50, 95)})
        log.info("latency p50=%.3fs p95=%.3fs   ttft p50=%.3fs p95=%.3fs",
                 np.percentile(lats, 50), np.percentile(lats, 95),
                 np.percentile(ttfts, 50), np.percentile(ttfts, 95))
    log.info("segments=%d slot-steps live=%d masked=%d admissions/slot=%s",
             st["segments"], st["slot_steps_live"], st["slot_steps_masked"],
             st["admissions_per_slot"])
    log.info("admitted=%d retired=%d", st["admitted"], st["retired"])
    if st["admit_rounds"]:
        log.info("admit rounds=%d (%.2f ms/round)", st["admit_rounds"],
                 1e3 * st["admit_time_s"] / st["admit_rounds"])
    captures = {k: v for k, v in eng.trace_counts.items() if v}
    log.info("captures %s in %.2fs (slot graphs reserved %.1f MiB), slot programs run "
             "eagerly on the card: %d", captures, sum(eng.capture_seconds.values()),
             eng.slot_graph_bytes / 2**20, eng.slot_eager_runs)
    if sched.chunked:
        hist = " ".join(f"{b}x{c}" for b, c in sorted(st["prefill_batch_hist"].items()))
        log.info("chunked prefill: chunk=%d buckets=%s launches=%d chunks=%d "
                 "batch-size histogram [%s] captures=%d", sched.prefill_chunk,
                 sched.buckets, st["prefill_launches"], st["chunks_prefilled"], hist,
                 eng.trace_counts["prefill_slots"] + eng.trace_counts["prefill_slots_paged"])
    elif st["chunked_skip_reason"]:
        log.info("chunked prefill disabled: %s", st["chunked_skip_reason"])
    if sched.paged:
        log.info("paged KV: peak blocks %d/%d (block_len=%d, overcommit=%.2f), blocks "
                 "grown on demand: %d, admissions deferred on full pool: %d",
                 st["blocks_in_use_peak"], sched.n_blocks, sched.block_len,
                 sched.overcommit, st["blocks_grown"], st["admit_deferred"])
    if st["preemptions"]:
        pen = (st["readmit_penalty_s"] / st["readmit_penalty_n"]
               if st["readmit_penalty_n"] else 0.0)
        log.info("preemption (%s): %d evictions, %d readmits (%d swap-outs, %d swap-ins, "
                 "%d replayed tokens), mean readmit penalty %.1f ms", sched.preempt_mode,
                 st["preemptions"], st["readmits"], st["swap_outs"], st["swap_ins"],
                 st["replayed_tokens"], 1e3 * pen)
    if st["cancelled"] or st["expired"]:
        log.info("terminal: %d cancelled (%d blocks reclaimed), %d expired",
                 st["cancelled"], st["blocks_reclaimed_cancel"], st["expired"])
    if sched.chaos is not None and sched.chaos.enabled:
        log.info("chaos: %d forced exhaustions, %d injected cancels, %d slot failures",
                 st["chaos_exhausts"], st["chaos_cancels"], st["chaos_slot_failures"])
    if sched.spec is not None:
        hist = st["accepted_hist"]
        total_steps = sum(hist.values())
        mean_acc = (sum(n * c for n, c in hist.items()) / total_steps
                    if total_steps else 0.0)
        bars = " ".join(f"{n}tok:{hist[n]}" for n in sorted(hist))
        log.info("speculative decode: k=%d draft=%s — %d draft-and-verify slot-steps, "
                 "mean accepted length %.2f tok/step, acceptance histogram [%s], "
                 "rounds predicated after a stop: %d", sched.spec.k, sched.spec.draft,
                 total_steps, mean_acc, bars, st["steps_predicated"])
        out.update(accepted_per_round=mean_acc, spec_steps=total_steps,
                   steps_predicated=st["steps_predicated"])
    elif st["spec_skip_reason"]:
        log.info("speculative decode disabled: %s", st["spec_skip_reason"])
    if sched.trace is not None:
        from repro_torch.serve.trace import trace_energy

        tr = sched.trace.totals
        log.info("trace: %d prefill + %d decode + %d spec tokens over %d launches — "
                 "%.3g GFLOP executed, %.3g GB moved (analytic)", tr["prefill_tokens"],
                 tr["decode_tokens"], tr["spec_tokens"], len(sched.trace.events),
                 tr["flops"] / 1e9, tr["hbm_bytes"] / 1e9)
        rep = trace_energy(sched.trace, eng.cfg, weight_sparsity=TRACE_WEIGHT_SPARSITY,
                           act_sparsity=TRACE_ACT_SPARSITY,
                           platforms=("SONIC", "NullHop", "NP100"))
        for name, r in rep["platforms"].items():
            log.info("energy [%-7s] %.3e J/token (%.3g J over the trace), %.1f tok/s/W at "
                     "%.2f W (the photonic model's output, not a card reading)", name,
                     r["j_per_token"], r["trace_energy_j"], r["tok_per_s_per_w"],
                     r["power_w"])
        out["trace"] = sched.trace.summary()
    return out


# sparsity assumptions for the --trace energy report, the reference's
TRACE_WEIGHT_SPARSITY = 0.75
TRACE_ACT_SPARSITY = 0.5


def _quant_bytes(args: argparse.Namespace) -> tuple[float, float]:
    """(cache, weight) bytes per element the roofline moves under the
    quantization flags."""
    cache_bpe = 1.03 if args.cache_quant_int8 else 2.0
    weight_bpe = (1.01 * (1.0 - args.weight_quant_sparsity)
                  if args.weight_quant == "int8" else 2.0)
    return cache_bpe, weight_bpe


def autotune_args(args: argparse.Namespace, draws) -> float:
    """The reference's ``--autotune`` planning step: rank the knob grid on
    the poisson draws and set ``args``' segment_len, prefill chunk and
    buckets, block_len and spec_k to the pick.  Returns its predicted tok/s
    (model units)."""
    from repro_torch.roofline.autotune import WorkloadSpec, autotune

    _, p_lens, n_news, _ = draws
    cache_bpe, weight_bpe = _quant_bytes(args)
    w = WorkloadSpec(tuple(int(x) for x in p_lens), tuple(int(x) for x in n_news),
                     n_slots=args.slots,
                     max_len=args.prompt_len + args.new_tokens + 1 + args.spec_k)
    res = autotune(get_arch(args.arch, reduced=args.reduced).cfg, w,
                   paged=(args.kv_layout == "paged"),
                   spec_ks=(0, args.spec_k) if args.spec_k else (0,),
                   cache_bytes_per_elem=cache_bpe, weight_bytes_per_elem=weight_bpe)
    log.info("autotune over %d candidates:\n%s", len(res.ranked), res.report())
    best = res.best
    args.segment_len = best.segment_len
    args.prefill_chunk = best.prefill_chunk
    args.prefill_buckets = best.prefill_buckets
    if args.kv_layout == "paged":
        args.block_len = best.block_len
    if args.spec_k and best.spec_k == 0:
        if args.trace:
            # at the assumed acceptance of 1.0 speculation never pays; keep
            # it on so the trace measures the real acceptance and the
            # post-run re-rank can judge it on real numbers
            log.info("autotune ranked spec_k=0 at assumed acceptance 1.0 — keeping "
                     "--spec-k %d under --trace to measure the real acceptance",
                     args.spec_k)
        else:
            args.spec_k = 0  # the model says speculation doesn't pay
    log.info("autotune pick: %s (segment_len=%d prefill_chunk=%d prefill_buckets=%d "
             "block_len=%d spec_k=%d) — predicted %.1f tok/s in model units",
             best.label(), best.segment_len, best.prefill_chunk, best.prefill_buckets,
             best.block_len, best.spec_k, res.ranked[0].tok_s)
    return res.ranked[0].tok_s


def rerank_with_acceptance(eng: ServeEngine, args: argparse.Namespace, draws, sched):
    """After a traced speculative run: re-rank with the acceptance length
    the run measured, so speculation competes on real numbers.  Returns the
    ``AutotuneResult``, or None when no speculative step ran."""
    acc = sched.trace.spec_accept_len()
    if acc is None:
        return None
    from repro_torch.roofline.autotune import WorkloadSpec, autotune

    _, p_lens, n_news, _ = draws
    cache_bpe, weight_bpe = _quant_bytes(args)
    w = WorkloadSpec(tuple(int(x) for x in p_lens), tuple(int(x) for x in n_news),
                     n_slots=args.slots, max_len=eng.sc.max_len)
    res = autotune(eng.cfg, w, paged=(args.kv_layout == "paged"),
                   spec_ks=(0, sched.spec.k), spec_accept_len=acc,
                   cache_bytes_per_elem=cache_bpe, weight_bytes_per_elem=weight_bpe)
    log.info("autotune re-rank with measured acceptance %.2f tok/step: pick %s "
             "(predicted %.1f tok/s, spec_k=%d)", acc, res.best.label(),
             res.ranked[0].tok_s, res.best.spec_k)
    return res


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    draws = predicted = None
    if args.autotune:
        draws = _poisson_draws(args, get_arch(args.arch, reduced=args.reduced).cfg.vocab_size)
        predicted = autotune_args(args, draws)
    eng = build_engine(args)
    if args.workload == "poisson":
        useful, total, sched, handles = run_poisson(eng, args, draws)
        report_poisson(eng, useful, total, sched, handles)
        if predicted is not None:
            log.info("autotune: predicted %.1f tok/s (model units, ranking only) vs "
                     "measured %.1f tok/s", predicted, useful / total if total > 0 else 0.0)
        if args.autotune and sched.trace is not None and sched.spec is not None:
            rerank_with_acceptance(eng, args, draws, sched)
    else:
        run_batch(eng, args)


if __name__ == "__main__":
    main()

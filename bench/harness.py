"""One run of one cell: set-up, the measured window, the drain, the metrics,
and the comparison with the plain reference that decides ``correct``.

The program under test is ``repro_torch``'s ``ServeEngine`` (int8
block-sparse weights, CUDA-graph slot programs) under its
``ContinuousScheduler`` (chunked prefill, while-mode segments, greedy).  The
benchmark makes the weights and the traffic from the seed and reads only the
scheduler's requests, its ``stats`` and the engine's capture counts.  The
model is the configuration's own: its family file builds the port's
``Arch`` and weights, its reference file decides ``correct``
(``bench/families/``); nothing here knows its layers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from bench import families, traffic
from bench.cells import Cell
from bench.tracing import Recorder, reduce_profile

DRAIN_LIMIT_S = 60.0  # an answer due in the window that has not come by then never comes
TRACE_AT = 1 / 3  # the profiled slice starts this far into the window ...
TRACE_SECONDS = 3.0  # ... and lasts about this long (at loop boundaries)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names the run may not load


@dataclasses.dataclass
class Served:
    """What the client side saw of one request."""

    prompt: np.ndarray
    max_new: int
    due: float  # host clock: its scheduled arrival
    handle: object = None
    first: float | None = None
    last: float | None = None
    n: int = 0
    in_window: int = 0
    refused: bool = False


class Program:
    """The system under test, set up for one cell and one seed."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, hook=None):
        from repro_torch.serve.engine import ServeConfig, ServeEngine

        model, serve = cell.model, cell.serve
        self.device = device
        self.family = families.load(model)
        laps = [time.perf_counter()]
        if device.type == "cuda":
            from repro_torch.kernels import build

            build.load_library()  # compiles into the checkout's build/ on its first run
        laps.append(time.perf_counter())
        comp = model["compression"]
        sc = ServeConfig(max_len=serve["max_len"], loop="while", kv_layout=serve["kv_layout"],
                         block_len=serve.get("block_len", 16), weight_quant="int8",
                         weight_quant_sparsity=comp["sparsity"],
                         weight_quant_block=tuple(comp["block"]))
        with torch.inference_mode():
            params = self.family.param_tree(model, seed, device)
        self.sync()
        laps.append(time.perf_counter())
        self.engine = ServeEngine(self.family.build_arch(model), params, sc, device=device)
        del params  # the engine keeps its int8 tree; the bf16 one goes
        if hook is not None:
            hook(self.engine)
        self.cell = cell
        self.new_scheduler(seed)
        self.sync()
        laps.append(time.perf_counter())
        self.warm_up()
        laps.append(time.perf_counter())
        # set-up seconds by stage, for the info line
        self.setup = dict(zip(("library_s", "weights_s", "engine_s", "captures_s"),
                              np.diff(laps).tolist()))

    def new_scheduler(self, seed: int) -> None:
        """A fresh scheduler of the cell's geometry (it takes over the
        engine's slot state and its graphs)."""
        from repro_torch.serve.scheduler import ContinuousScheduler

        serve = self.cell.serve
        self.scheduler = ContinuousScheduler(
            self.engine, n_slots=serve["n_slots"], segment_len=serve["segment_len"],
            segment_mode="while", seed=seed, prefill_chunk=serve["prefill_chunk"],
            prefill_buckets=serve.get("prefill_buckets", 4))

    @torch.inference_mode()
    def reseed(self, seed: int) -> None:
        """Another seed's weights into the engine's tensors, in place (the
        captured graphs read those addresses), and a fresh scheduler: many
        seeds' readings in one process (``calibrate.py``)."""
        from repro_torch.core.sonic_layers import quantize_serve_params

        comp = self.cell.model["compression"]
        fresh = quantize_serve_params(self.family.param_tree(self.cell.model, seed, self.device),
                                      comp["sparsity"], tuple(comp["block"]))

        def copy(dst, src):
            for k, v in src.items():
                copy(dst[k], v) if isinstance(v, dict) else dst[k].copy_(v)
        copy(self.engine.params, fresh)
        del fresh
        self.new_scheduler(seed)
        self.sync()

    @torch.inference_mode()
    def warm_up(self) -> None:
        """Capture every program the cell's traffic can reach: each (width,
        bucket) prefill launch, on dummy rows whose writes all drop, and the
        decode segment, with every slot masked."""
        eng, sched = self.engine, self.scheduler
        n = sched.n_slots
        pool = n + sched.n_blocks if sched.paged else 0
        for i in range(sched.n_width_buckets):
            w = 1 << i
            for b in sched.buckets:
                bt = None
                if sched.paged:
                    bt = pool + np.arange(w * sched.max_blocks).reshape(w, sched.max_blocks)
                eng.prefill_slots(sched.state, np.zeros((w, b), np.int32),
                                  np.arange(n, n + w), np.zeros(w, np.int64),
                                  np.zeros(w, np.int64), bt)
        eng.slot_segment(sched.state, 1, "while", np.zeros(n, bool), np.zeros(n, np.int64),
                         block_table=sched.block_table if sched.paged else None)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def captures(self) -> int:
        return sum(self.engine.trace_counts.values())


def _percentile(values: list[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of them at or below it."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


class Window:
    """Drives one cell's traffic through the scheduler for ``seconds``, then
    drains what was due.  ``recorder`` (the traced run) profiles a slice."""

    def __init__(self, prog: Program, cell: Cell, seed: int, seconds: float,
                 recorder: Recorder | None = None, rate: float | None = None):
        self.prog, self.cell, self.seed, self.seconds = prog, cell, seed, seconds
        self.sched = prog.scheduler
        self.recorder = recorder
        self.rate = rate if rate is not None else cell.spec.get("rate_rps")
        self.served: list[Served] = []
        self.profile = None

    def _span(self, name):
        return self.recorder.span(name) if self.recorder else contextlib.nullcontext()

    def _submit(self, req: traffic.Request, due: float) -> Served:
        s = Served(req.prompt, req.max_new, due)

        def on_token(_req, _tok, s=s):
            t = time.perf_counter()
            s.first = t if s.first is None else s.first
            s.last, s.n = t, s.n + 1
            s.in_window += t <= self.end

        try:
            s.handle = self.sched.submit(req.prompt, req.max_new, on_token=on_token)
        except ValueError as e:
            print(f"refused: {e}", file=sys.stderr)
            s.refused = True
        self.served.append(s)
        return s

    def _prefilled(self) -> int:
        return int(sum(self.sched.stats["prefill_tokens_per_round"]))

    def _profile_step(self, now: float) -> None:
        """Start the profiler at TRACE_AT of the window; stop it TRACE_SECONDS
        later, once it holds a decode segment and a prefill launch, or at
        the close (both between two scheduler calls)."""
        rec = self.recorder
        if rec is None or self.prog.device.type != "cuda":
            return
        start = self.seconds * TRACE_AT
        if self.profile is None and now >= start and now < self.seconds:
            from torch.profiler import ProfilerActivity, profile, record_function
            self.profile = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.profile.__enter__()
            self._traced = record_function("bench.traced")
            self._traced.__enter__()
            rec.profiling = True
        elif rec.profiling and (now >= self.seconds or (
                now >= start + TRACE_SECONDS and rec.traced_kinds() >= {"decode", "prefill"})):
            self.prog.sync()
            self._traced.__exit__(None, None, None)
            self.profile.__exit__(None, None, None)
            rec.profiling = False

    def backlog(self) -> int:
        """Requests submitted and not yet finished."""
        return sum(1 for s in self.served if s.handle is not None and not s.handle.terminal)

    @torch.inference_mode()
    def run(self, drain: bool = True) -> dict:
        """The window, then (``drain``) the requests due in it to their
        end.  Without the drain, what is unfinished stays so (the knee
        sweep reads the backlog instead)."""
        sched = self.sched
        stats0 = {k: v for k, v in sched.stats.items() if isinstance(v, (int, float))}
        captures0 = self.prog.captures()
        self.prog.sync()
        t0 = time.perf_counter()
        self.end = t0 + self.seconds
        due = traffic.open_loop(self.cell.mix, self.rate, self.seconds, self.seed,
                                self.cell.model["vocab_size"])
        nxt = 0
        prefilled = prefilled0 = self._prefilled()
        self.backlog_mid = None
        while True:
            now = time.perf_counter()
            if now >= self.end:
                break
            if self.backlog_mid is None and now >= t0 + self.seconds / 2:
                self.backlog_mid = self.backlog()
            self._profile_step(now - t0)
            with self._span("submit"):
                while nxt < len(due) and t0 + due[nxt].arrival <= now:
                    self._submit(due[nxt], t0 + due[nxt].arrival)
                    nxt += 1
            if sched.has_work():
                sched.run_segment()
                if time.perf_counter() <= self.end:
                    prefilled = self._prefilled()
            else:  # idle until the next arrival, or the close
                wake = t0 + due[nxt].arrival if nxt < len(due) else self.end
                with self._span("wait"):
                    time.sleep(max(min(wake, self.end) - time.perf_counter(), 0.0))
        self._profile_step(self.seconds)
        while nxt < len(due):  # due before the close, sent late: late, not lost
            self._submit(due[nxt], t0 + due[nxt].arrival)
            nxt += 1
        window_prefill = prefilled - prefilled0
        stats = {k: v - stats0[k] for k, v in sched.stats.items() if k in stats0}
        window_captures = self.prog.captures() - captures0
        self.backlog_end = self.backlog()
        # the drain: what was due in the window, finished after it closed
        limit = time.perf_counter() + DRAIN_LIMIT_S
        while drain and sched.has_work() and time.perf_counter() < limit:
            sched.run_segment()
        self.prog.sync()
        return self._metrics(window_prefill, stats, window_captures)

    def _metrics(self, window_prefill: int, stats: dict, window_captures: int) -> dict:
        out_tokens = sum(s.in_window for s in self.served)
        ttft = [(s.first - s.due) if s.first is not None else math.inf for s in self.served]
        tpot = [(s.last - s.first) / (s.n - 1) for s in self.served if s.n >= 2]
        unfinished = [s for s in self.served
                      if s.refused or s.handle is None or not s.handle.done]
        return {
            "tok_s": (window_prefill + out_tokens) / self.seconds,
            "ttft_p90_ms": 1e3 * _percentile(ttft, 0.9),
            "tpot_p90_ms": 1e3 * _percentile(tpot, 0.9),
            "attempted": len(self.served), "failed": len(unfinished),
            "prompt_tokens": window_prefill, "output_tokens": out_tokens,
            "stats": stats, "window_captures": window_captures,
        }


def sample(served: list[Served], seed: int, tokens: int) -> list[Served]:
    """Finished requests for the reference: the longest (prompt and answer),
    then others drawn from the seed until ``tokens`` served tokens."""
    done = [s for s in served if s.handle is not None and s.handle.done]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + done[i].n)
    rest = [done[i] for i in np.random.default_rng([seed, 1]).permutation(len(done))
            if i != longest]
    picked, n = [done[longest]], done[longest].n
    for s in rest:
        if n >= tokens:
            break
        picked.append(s)
        n += s.n
    return picked


def compare(cell: Cell, seed: int, served: list[Served], device, control: bool = False) -> dict:
    """The numbers that decide ``correct``, each with its limit: every request
    due in the window answered with its full budget of valid token ids, and
    the widest gap by which a sampled served token's logit lies below the
    reference's best.  With ``control`` the gap compared is the control's
    (the reference in float8 put in the program's place, at each position
    of the same served sequences), so a sound limit makes the run not
    correct; ``info["program_gap"]`` keeps the program's."""
    vocab = cell.model["vocab_size"]
    finished = [s for s in served if s.handle is not None and s.handle.done]
    malformed = [s for s in finished
                 if len(s.handle.tokens) != s.max_new
                 or not all(0 <= t < vocab for t in s.handle.tokens)]
    picked = [s for s in sample(served, seed, cell.check["sample_tokens"])
              if s not in malformed]
    seqs = [(s.prompt.astype(np.int64), list(s.handle.tokens)) for s in picked]
    reference = families.reference(cell.model)
    t0 = time.perf_counter()
    got = (reference.logit_gaps(cell.model, seed, device, seqs, control=control) if seqs
           else {"gap": math.inf, "control_gap": math.inf, "tokens": 0})
    info = {"compared_tokens": got["tokens"], "compared_requests": len(seqs),
            "reference_s": time.perf_counter() - t0, "program_gap": got["gap"]}
    if control:  # the control in the program's place, held to the same limit
        got["gap"] = info["control_gap"] = got["control_gap"]
    checks = {"unanswered": {"value": len(served) - len(finished), "limit": 0},
              "malformed": {"value": len(malformed), "limit": 0},
              "logit_gap": {"value": got["gap"], "limit": cell.check["logit_gap"]}}
    return {"checks": checks, "info": info}


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` the run may not have loaded,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, hook=None, control: bool = False) -> dict:
    """One run: {"result": the result line's keys, "info": what standard
    error reports beside them (set-up stages, tokens, the reference's time,
    the traced spans)}."""
    prog = Program(cell, seed, device, hook)
    rec = None
    if trace:
        rec = Recorder(cell.model, device)
        rec.install(prog.engine, prog.scheduler)
        if device.type == "cuda":  # the profiler's first start, outside the window
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                prog.sync()
    if device.type == "cuda":  # the peak of what serving holds, not of set-up's bf16 tree
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    setup_stages = prog.setup
    win = Window(prog, cell, seed, seconds, rec)
    m = win.run()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    spans = rec.summary() if rec else None
    prof = reduce_profile(win.profile) if win.profile is not None else {}
    served = win.served
    win.prog = win.sched = win.profile = prog = rec = None  # free the program's state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cmp = compare(cell, seed, served, device, control)
    correct = all(c["value"] <= c["limit"] for c in cmp["checks"].values())
    out = {"correct": correct, "attempted": m["attempted"], "failed": m["failed"],
           "metrics": {}, "device": {"platform": "gpu" if cuda else "cpu",
                                     "kind": torch.cuda.get_device_name(device) if cuda
                                     else "cpu", "count": 1, "memory_peak_bytes": peak},
           "checks": cmp["checks"]}
    info = {**cmp["info"], "setup_stages": setup_stages, "window_captures": m["window_captures"],
            "prompt_tokens": m["prompt_tokens"], "output_tokens": m["output_tokens"],
            "served": {k: m[k] for k in ("tok_s", "ttft_p90_ms", "tpot_p90_ms")}}
    reported = cell.spec["end_to_end"]
    if not trace:
        e2e = {"tok_s": (m["tok_s"], "tokens/s"), "ttft_p90_ms": (m["ttft_p90_ms"], "ms"),
               "tpot_p90_ms": (m["tpot_p90_ms"], "ms"), "setup_s": (setup_s, "s")}
        out["metrics"] = {k: {"value": e2e[k][0], "unit": e2e[k][1]} for k in reported}
    else:
        from bench import metrics
        data = {"stats": m["stats"], "spans": spans, "profile": prof}
        out["metrics"] = {name: {"value": v, "unit": unit}
                          for name, unit, v in metrics.read_all(data, reported)}
        if prof:
            out["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
        info["spans"] = spans
    info["setup_s"] = setup_s
    return {"result": out, "info": info}

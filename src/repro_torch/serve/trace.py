"""Serving trace: per-launch phase records priced by analytic models, and
spans of the serving loop on the profiler's clock.

The phase records are the port of ``repro.serve.trace``, whole; they read
the port's engine (``engine.cache_quant_int8`` where the reference reads
``engine.plan.cache_quant_int8``) and price through the port's
``roofline.analytic`` and ``photonic`` packages, so the same events give
the same FLOPs, bytes and Joules in both packages.  Their counts come from
host state the scheduler already holds.

Opt-in via ``ServeConfig.trace=True``.  The scheduler then owns a
:class:`TraceRecorder`, calls its ``record_*`` hooks from the launch sites
(prefill dispatch, decode/spec segment, preemption/swap) and hands it to
its slot state (``SlotState.trace``), through which the engine records the
spans of its program calls.  With tracing off the scheduler's ``trace``
attribute and the slot state's are ``None``, and every hook site is a
single ``is not None`` check: no span, event or list is made.

Spans (``Span``: name, start and end on :func:`now_ns`, the id of the span
open around it, the request ids it served, attributes), kept in memory
(``TraceRecorder.spans``) and read after the run:

    serve.segment       one ``ContinuousScheduler.run_segment`` (the root);
                        its blocking device→host reads by kind and graph
                        replays
    serve.admit         one admit round: chunks and real tokens prefilled
    serve.prefill       one ``prefill_slot`` / ``prefill_slots`` call (the
                        engine): width, bucket, real tokens, rids
    serve.first_tokens  the round's one download of first tokens
    serve.decode        one ``slot_segment`` / ``spec_segment`` call (the
                        engine): rounds run, live slot-steps, rids of the
                        active slots
    serve.stop_check    one blocking read of a while segment's stop flag
    serve.download      the segment's token-block download
    serve.retire        streaming the block and retiring finished requests:
                        tokens streamed, requests retired
    serve.queue         a request from its submission (or preemption) to
                        the claim of its slot: a root span of its own

On the card each engine call also records a CUDA event (``enable_timing``,
current stream) before its input upload and one after its last replay;
they add no synchronize and are read only by :meth:`TraceRecorder.resolve`,
after the run, for the calls' device milliseconds and the device time
between consecutive decode calls.  :func:`now_ns` is the base of
``torch.profiler``'s host and device stamps (Unix-epoch nanoseconds), so
a profiled slice's idle gaps can be laid over the spans.  Spans and events
grow with the run: a long-lived server clears them with
:meth:`TraceRecorder.clear_spans`.

Conventions of the phase records (shared with roofline/analytic.py's
step-cost models):

* ``tokens`` counts USEFUL tokens — real prompt tokens prefilled, live
  decode emissions (replayed tokens included: the device computed them).
* ``flops`` / ``hbm_bytes`` count EXECUTED work: a decode segment runs all
  ``n_slots`` rows (masked ones included) attending the full ``max_len``
  context every step, and a chunked-prefill launch is padded to its
  power-of-two width.  The gap between the two columns is exactly the
  masked/padding waste a knob change can claw back.
* Preemption events record the swap payload bytes (host<->device), kept
  out of the ``hbm_bytes`` total — they are PCIe traffic, not HBM.

``trace_energy`` bridges a finished trace to the photonic energy model:
per-token Joules from ``photonic.mapper.lm_workload`` (linear layers only —
attention score/PV work and KV traffic are NOT priced by the photonic
model) evaluated on SONIC and the electronic
baselines, scaled by the trace's token count.  Its Joules are the
photonic model's analytic output, not a reading of the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Sequence

import torch

from repro_torch.roofline.analytic import (
    StepCost,
    decode_step_cost,
    prefill_chunk_cost,
    spec_verify_cost,
)

PHASES = ("prefill", "decode", "spec", "preempt", "brownout")
# the spans that are one blocking device→host read each, by the counter's name
READS = {"serve.stop_check": "stop_checks", "serve.download": "token_downloads",
         "serve.first_tokens": "first_token_downloads"}
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()  # fixed once, at import


def now_ns() -> int:
    """The spans' clock: ``time.perf_counter_ns()`` moved to Unix-epoch
    nanoseconds by an offset fixed at import, the base of the host and
    device events ``torch.profiler`` returns (``kineto_results.events()``)."""
    return time.perf_counter_ns() + _EPOCH_NS


@dataclasses.dataclass
class Span:
    """One interval of the serving loop on :func:`now_ns`: ``parent`` is the
    ``sid`` of the span open around it (None for a root), ``rids`` the
    requests it served, ``events`` the [start, end] CUDA events of an
    engine call on the card."""

    sid: int
    name: str
    start_ns: int
    parent: int | None
    end_ns: int = 0
    rids: tuple[int, ...] = ()
    attrs: dict = dataclasses.field(default_factory=dict)
    events: list | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def _nearest_rank(values: list[float], q: float) -> float:
    """The smallest value with at least ``q`` of them at or below it."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


@dataclasses.dataclass(frozen=True)
class PhaseRecord:
    phase: str  # one of PHASES
    segment: int  # scheduler segment counter when recorded
    batch: int  # rows the launch executed (padded width / n_slots)
    steps: int  # loop steps (decode/spec) or chunk length (prefill)
    tokens: int  # useful tokens (see module docstring)
    flops: float  # executed FLOPs (analytic)
    hbm_bytes: float  # executed HBM traffic (analytic; swap bytes excluded)


class TraceRecorder:
    """Accumulates per-launch :class:`PhaseRecord` events + running totals."""

    def __init__(self, engine):
        self.cfg = engine.cfg
        self.max_len = engine.sc.max_len
        spec = engine.spec
        self.spec_k = spec.k if spec is not None else 0
        self.draft_layers = (engine.draft_cfg.n_layers
                             if spec is not None and engine.draft_cfg is not None
                             else None)
        self.cache_bytes_per_elem = (
            1.03 if engine.cache_quant_int8 else 2.0)
        # int8 block-sparse serving weights: kept blocks move as
        # int8 + one fp32 scale + one int32 index each (~1.01 bytes/elem at
        # the 128-tile default), and pruned blocks never leave HBM — the
        # density folds straight into the per-element price
        sc = engine.sc
        self.weight_bytes_per_elem = (
            1.01 * (1.0 - sc.weight_quant_sparsity)
            if getattr(sc, "weight_quant", "none") == "int8" else 2.0)
        self.events: list[PhaseRecord] = []
        # per-tenant emitted-token counters: the billing basis —
        # the scheduler calls note_tenant_tokens once per live emission
        # (replays excluded), keyed by the request's tenant label
        self.tenant_tokens: dict[str, int] = {}
        self.totals: dict[str, float] = {
            "prefill_tokens": 0, "prefill_launches": 0,
            "decode_tokens": 0, "decode_segments": 0, "decode_steps": 0,
            "spec_tokens": 0, "spec_segments": 0, "spec_live_steps": 0,
            "preemptions": 0, "swap_bytes": 0,
            "brownout_changes": 0, "brownout_level_peak": 0,
            "flops": 0.0, "hbm_bytes": 0.0,
        }
        # segments repeat the same (batch, steps) shape thousands of times;
        # memoize the per-step analytic price
        self._decode_memo: dict[int, StepCost] = {}
        self._spec_memo: dict[int, StepCost] = {}
        # spans (module docstring), the spans still open (innermost last),
        # when each queued request (re)entered the queue, and the counters
        # kept at the spans' boundaries
        self.spans: list[Span] = []
        self._open: list[Span] = []
        self._queued: dict[int, int] = {}
        self._next_sid = 0
        self.counts = dict.fromkeys((*READS.values(), "graph_replays"), 0)

    # -- pricing ----------------------------------------------------------
    def _decode_cost(self, batch: int) -> StepCost:
        c = self._decode_memo.get(batch)
        if c is None:
            c = decode_step_cost(self.cfg, batch, self.max_len,
                                 self.cache_bytes_per_elem,
                                 self.weight_bytes_per_elem)
            self._decode_memo[batch] = c
        return c

    def _spec_cost(self, batch: int) -> StepCost:
        c = self._spec_memo.get(batch)
        if c is None:
            c = spec_verify_cost(self.cfg, self.spec_k, batch, self.max_len,
                                 self.draft_layers, self.cache_bytes_per_elem,
                                 self.weight_bytes_per_elem)
            self._spec_memo[batch] = c
        return c

    def _push(self, rec: PhaseRecord) -> None:
        self.events.append(rec)
        self.totals["flops"] += rec.flops
        if rec.phase != "preempt":
            self.totals["hbm_bytes"] += rec.hbm_bytes

    # -- hooks (called by ContinuousScheduler) ----------------------------
    def record_prefill(self, segment: int, width: int, chunk: int,
                       real_tokens: int, starts: Sequence[int]) -> None:
        """One prefill launch: ``width`` rows × ``chunk`` tokens (padded
        rows implicit at start 0), ``real_tokens`` of which are real."""
        ctx = sum(chunk * s + chunk * (chunk + 1) / 2.0 for s in starts)
        ctx += (width - len(starts)) * chunk * (chunk + 1) / 2.0
        cost = prefill_chunk_cost(self.cfg, width, chunk, ctx_sum=ctx,
                                  cache_bytes_per_elem=self.cache_bytes_per_elem,
                                  weight_bytes_per_elem=self.weight_bytes_per_elem)
        self.totals["prefill_tokens"] += real_tokens
        self.totals["prefill_launches"] += 1
        self._push(PhaseRecord("prefill", segment, width, chunk, real_tokens,
                               cost.flops, cost.hbm_bytes))

    def record_decode(self, segment: int, batch: int, steps: int,
                      tokens: int) -> None:
        """One plain decode segment: ``steps`` executed loop steps over
        ``batch`` slot rows, ``tokens`` live emissions."""
        c = self._decode_cost(batch)
        self.totals["decode_tokens"] += tokens
        self.totals["decode_segments"] += 1
        self.totals["decode_steps"] += steps
        self._push(PhaseRecord("decode", segment, batch, steps, tokens,
                               c.flops * steps, c.hbm_bytes * steps))

    def record_spec(self, segment: int, batch: int, steps: int,
                    live_steps: int, tokens: int) -> None:
        """One speculative segment: ``steps`` draft-and-verify rounds,
        ``live_steps`` of them on live slots, ``tokens`` accepted+bonus
        emissions."""
        c = self._spec_cost(batch)
        self.totals["spec_tokens"] += tokens
        self.totals["spec_segments"] += 1
        self.totals["spec_live_steps"] += live_steps
        self._push(PhaseRecord("spec", segment, batch, steps, tokens,
                               c.flops * steps, c.hbm_bytes * steps))

    def record_preempt(self, segment: int, emitted: int,
                       swap_bytes: int = 0) -> None:
        """A slot eviction; ``emitted`` tokens at eviction time, plus the
        device→host KV payload when the swap path was taken."""
        self.totals["preemptions"] += 1
        self.totals["swap_bytes"] += swap_bytes
        self._push(PhaseRecord("preempt", segment, 1, 0, emitted,
                               0.0, float(swap_bytes)))

    def record_swap_in(self, segment: int, swap_bytes: int) -> None:
        """Host→device KV re-upload at readmission of a swapped request."""
        self.totals["swap_bytes"] += swap_bytes
        self._push(PhaseRecord("preempt", segment, 1, 0, 0,
                               0.0, float(swap_bytes)))

    def record_brownout(self, segment: int, level: int) -> None:
        """A brownout-ladder transition: the new level rides in the
        ``steps`` field; zero priced work — the event marks WHEN the
        overload controller moved, for correlating energy/goodput phases."""
        self.totals["brownout_changes"] += 1
        self.totals["brownout_level_peak"] = max(
            self.totals["brownout_level_peak"], level)
        self._push(PhaseRecord("brownout", segment, 0, level, 0, 0.0, 0.0))

    def note_tenant_tokens(self, tenant: str, n: int = 1) -> None:
        """One (or ``n``) live emissions billed to ``tenant``."""
        self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + n

    # -- spans (called by ContinuousScheduler and ServeEngine) -------------
    def open(self, name: str, timed: bool = False, **attrs) -> Span:
        """Start a span inside the innermost open one; ``timed`` (an engine
        call on the card) records its start CUDA event now."""
        sp = Span(self._next_sid, name, now_ns(), self._open[-1].sid if self._open else None,
                  attrs=attrs)
        self._next_sid += 1
        if timed:
            sp.events = [torch.cuda.Event(enable_timing=True)]
            sp.events[0].record()
        self.spans.append(sp)
        self._open.append(sp)
        return sp

    def close(self, sp: Span, **attrs) -> None:
        """End ``sp`` (its end CUDA event first, if timed) and count what it
        stands for: a blocking read (``READS``), ``replays`` graph replays."""
        if sp.events is not None:
            sp.events.append(torch.cuda.Event(enable_timing=True))
            sp.events[1].record()
        sp.end_ns = now_ns()
        sp.attrs.update(attrs)
        while self._open and self._open.pop() is not sp:
            pass  # a span an exception left open ends with its parent
        if sp.name in READS:
            self.counts[READS[sp.name]] += 1
        self.counts["graph_replays"] += attrs.get("replays", 0)

    @contextlib.contextmanager
    def segment_span(self, segment: int):
        """The root span of one ``run_segment``, with the blocking reads by
        kind and the graph replays it made."""
        sp = self.open("serve.segment", segment=segment)
        before = dict(self.counts)
        try:
            yield sp
        finally:
            self.close(sp, **{k: v - before[k] for k, v in self.counts.items()})

    def annotate(self, name: str, rids: Sequence[int] | None = None, **attrs) -> None:
        """What the caller knows after an engine call, onto the latest span
        of ``name`` (the call's)."""
        for sp in reversed(self.spans):
            if sp.name == name:
                if rids is not None:
                    sp.rids = tuple(int(r) for r in rids)
                sp.attrs.update(attrs)
                return

    def enqueue(self, rid: int) -> None:
        """Request ``rid`` entered the queue (submitted, or preempted)."""
        self._queued[rid] = now_ns()

    def left_queue(self, rid: int) -> None:
        """Request ``rid`` retired without a slot (cancelled or expired
        while queued): no span."""
        self._queued.pop(rid, None)

    def claimed(self, rid: int) -> None:
        """Request ``rid`` claimed a slot: its ``serve.queue`` span, a root."""
        start = self._queued.pop(rid, None)
        if start is not None:
            self.spans.append(Span(self._next_sid, "serve.queue", start, None, now_ns(), (rid,)))
            self._next_sid += 1

    def clear_spans(self) -> None:
        """Drop the spans and counters so far (between segments: a measured
        window starts here); requests already queued keep their stamps."""
        self.spans = []
        self.counts = dict.fromkeys(self.counts, 0)

    def resolve(self) -> None:
        """After the run: each timed span's device milliseconds
        (``device_ms``), and on each decode span the device milliseconds
        from the previous decode call's end event to its start event
        (``gap_ms``).  Waits for the last event."""
        timed = [s for s in self.spans if s.events is not None and len(s.events) == 2]
        if not timed:
            return
        timed[-1].events[1].synchronize()
        prev = None
        for sp in timed:
            sp.attrs["device_ms"] = sp.events[0].elapsed_time(sp.events[1])
            if sp.name == "serve.decode":
                if prev is not None:
                    sp.attrs["gap_ms"] = prev.events[1].elapsed_time(sp.events[0])
                prev = sp

    def span_summary(self) -> dict:
        """The spans read out (after :meth:`resolve`): per name the count,
        host total and self milliseconds (duration less its children's);
        the decode calls' rounds, live slot-steps, device ms and stall (Σ
        over consecutive calls of the device gap between them × the
        requests active in both; device values None off the card); the
        prefill calls' real tokens and device ms; ``serve.queue``'s p50 and
        p90 ms; the counters; and every span but ``serve.queue`` as (start
        ns, end ns, name), the host's nesting to lay a profile over."""
        self.resolve()
        child_ms: dict[int, float] = {}
        for sp in self.spans:
            if sp.parent is not None:
                child_ms[sp.parent] = child_ms.get(sp.parent, 0.0) + sp.ms
        names: dict[str, dict] = {}
        for sp in self.spans:
            row = names.setdefault(sp.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += sp.ms
            row["self_ms"] += sp.ms - child_ms.get(sp.sid, 0.0)

        def device_ms(spans):
            return (sum(s.attrs["device_ms"] for s in spans)
                    if spans and all("device_ms" in s.attrs for s in spans) else None)

        dec = [s for s in self.spans if s.name == "serve.decode"]
        pre = [s for s in self.spans if s.name == "serve.prefill"]
        pairs = [(a, b) for a, b in zip(dec, dec[1:]) if "gap_ms" in b.attrs]
        queue = [s.ms for s in self.spans if s.name == "serve.queue"]
        return {
            "spans": names,
            "decode": {
                "calls": len(dec), "rounds": sum(s.attrs.get("rounds", 0) for s in dec),
                "live_slot_steps": sum(s.attrs.get("live_slot_steps", 0) for s in dec),
                "device_ms": device_ms(dec),
                "stall_ms": (sum(b.attrs["gap_ms"] * len(set(a.rids) & set(b.rids))
                                 for a, b in pairs) if pairs else None),
            },
            "prefill": {"calls": len(pre),
                        "real_tokens": sum(s.attrs.get("real_tokens", 0) for s in pre),
                        "device_ms": device_ms(pre)},
            "queue_ms": {"p50": _nearest_rank(queue, 0.5), "p90": _nearest_rank(queue, 0.9)},
            "counts": dict(self.counts),
            "intervals": [(s.start_ns, s.end_ns, s.name) for s in self.spans
                          if s.name != "serve.queue"],
        }

    # -- views ------------------------------------------------------------
    @property
    def tokens_total(self) -> int:
        t = self.totals
        return int(t["prefill_tokens"] + t["decode_tokens"] + t["spec_tokens"])

    def spec_accept_len(self) -> float | None:
        """Measured mean emitted tokens per live speculative step (1..k+1),
        or None when no speculative step ran.  This is the acceptance length
        ``roofline/autotune.predict`` prices speculation with (its default
        acceptance of 1.0 makes speculation never recommendable)."""
        steps = self.totals["spec_live_steps"]
        if steps <= 0:
            return None
        return float(self.totals["spec_tokens"]) / float(steps)

    def summary(self) -> dict:
        out = dict(self.totals)
        out["tokens_total"] = self.tokens_total
        out["events"] = len(self.events)
        if self.tenant_tokens:
            out["tenant_tokens"] = dict(self.tenant_tokens)
        return out


def trace_energy(trace, cfg=None, weight_sparsity: float = 0.0,
                 act_sparsity: float = 0.0,
                 platforms: Sequence[str] = ("SONIC", "NullHop")) -> dict:
    """Energy-per-token + perf-per-watt for a finished trace.

    Prices one token's worth of the model's LINEAR layers (qkv/o + ffn +
    lm_head via ``lm_workload(seq_len=1)`` — energy is linear in tokens, so
    prefill and decode tokens price identically) on each named platform
    from ``photonic.baselines.BASELINES``, then scales by the trace's total
    token count.  ``weight_sparsity`` is the SONIC-style pruned fraction,
    ``act_sparsity`` the runtime activation zero fraction (both also honored
    by the zero-skipping electronic baselines).
    """
    from repro_torch.photonic.baselines import BASELINES
    from repro_torch.photonic.mapper import lm_workload

    cfg = cfg if cfg is not None else trace.cfg
    work = lm_workload(cfg, weight_sparsity=weight_sparsity,
                       act_sparsity=act_sparsity, seq_len=1)
    tokens = trace.tokens_total
    out = {
        "tokens": tokens,
        "weight_sparsity": weight_sparsity,
        "act_sparsity": act_sparsity,
        "platforms": {},
    }
    for name in platforms:
        rep = BASELINES[name]().evaluate(work)
        j_tok = rep.power_w / rep.fps  # one frame == one token at seq_len=1
        out["platforms"][name] = {
            "j_per_token": j_tok,
            "tok_per_s_model": rep.fps,
            "power_w": rep.power_w,
            "tok_per_s_per_w": rep.fps_per_w,
            "trace_energy_j": j_tok * tokens,
        }
    return out


def tenant_report(trace, energy: dict | None = None, wall_s: float | None = None,
                  platform: str = "SONIC") -> dict:
    """Per-tenant pricing view: each tenant's emitted-token share of
    the traced run, with priced tok/s (``wall_s`` given) and J/token
    (``energy`` = a ``trace_energy`` result).

    Billing model: the platform's TOTAL traced energy — including the
    masked/padded work no single request asked for — is apportioned to
    tenants by their share of live emissions, so each tenant's J/token
    carries its share of the serving overhead rather than the bare
    marginal token price.
    """
    billed = dict(trace.tenant_tokens)
    total = sum(billed.values())
    plat = (energy or {}).get("platforms", {}).get(platform)
    out: dict = {}
    for tenant, tokens in sorted(billed.items()):
        share = tokens / total if total else 0.0
        row = {"tokens": tokens, "share": share}
        if wall_s is not None and wall_s > 0:
            row["tok_s"] = tokens / wall_s
        if plat is not None and tokens:
            energy_j = plat["trace_energy_j"] * share
            row["energy_j"] = energy_j
            row["j_per_token"] = energy_j / tokens
        out[tenant] = row
    return out

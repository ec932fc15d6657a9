"""Per-segment serving trace: cheap host-side counters + analytic pricing.

The port of ``repro.serve.trace``, whole; it reads the port's engine
(``engine.cache_quant_int8`` where the reference reads
``engine.plan.cache_quant_int8``) and prices through the port's
``roofline.analytic`` and ``photonic`` packages, so the same events give
the same FLOPs, bytes and Joules in both packages.  No hook touches the
device: every count is read from host state the scheduler already holds.

Opt-in via ``ServeConfig.trace=True``.  The scheduler then owns a
:class:`TraceRecorder` and calls its ``record_*`` hooks from the launch
sites (prefill dispatch, decode/spec segment, preemption/swap).  With
tracing off the scheduler's ``trace`` attribute is ``None`` and every hook
site is a single ``is not None`` check — the zero-overhead path.

Conventions (shared with roofline/analytic.py's step-cost models):

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

import dataclasses
from typing import Sequence

from repro_torch.roofline.analytic import (
    StepCost,
    decode_step_cost,
    prefill_chunk_cost,
    spec_verify_cost,
)

PHASES = ("prefill", "decode", "spec", "preempt", "brownout")


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

"""Analytic scheduler-knob autotuner and the front door's drain predictor.

The port of ``repro.roofline.autotune``, whole.  ``predict`` runs a
deterministic host-side simulation of the continuous scheduler's policy
loop — admit → (chunked) prefill → "while"-mode decode segment → retire —
pricing every launch through the step-cost models in
``roofline/analytic.py`` (device time = roofline max(compute, memory) on
the ``hw`` target, by default the port's card, ``hw.H100``) plus
calibratable per-launch host overheads (:class:`HostOverheads`, the
dispatch/download round-trips that dominate small-model serving).
``autotune`` sweeps a candidate knob grid and ranks by predicted useful
tok/s.  Given the same target (``hw=TPU_V5E``) both packages rank alike.

The prediction's absolute scale is in model units (its device times are
the ``hw`` target's peak rates, not a measurement); only the RANKING is
claimed.

Speculative decoding note: with ``spec_k > 0`` the model prices every step
as a full draft-and-verify round but credits only ``spec_accept_len``
emissions per step, defaulting to 1.0 — the acceptance rate is a property
of the model/workload the analytic layer cannot know, so speculation is
never recommended unless the caller feeds a measured acceptance length:
``TraceRecorder.spec_accept_len()`` from a traced run (``launch/serve.py
--autotune`` with ``--trace`` and a spec run re-ranks with it).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.configs.base import ModelConfig
from repro_torch.roofline.analytic import (
    decode_step_cost,
    prefill_chunk_cost,
    spec_verify_cost,
    step_time,
)
from repro_torch.roofline.hw import H100, HWTarget


@dataclasses.dataclass(frozen=True)
class KnobConfig:
    """The scheduler knobs the autotuner searches."""

    segment_len: int = 8
    prefill_chunk: int = 0  # 0 = per-request whole-prompt admission
    prefill_buckets: int = 4
    spec_k: int = 0  # 0 = plain decode
    block_len: int = 16  # paged layouts only

    def label(self) -> str:
        s = f"seg{self.segment_len}_chunk{self.prefill_chunk}"
        if self.spec_k:
            s += f"_spec{self.spec_k}"
        return s


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What the autotuner optimizes for: the request mix + slot budget."""

    prompt_lens: tuple[int, ...]
    new_tokens: tuple[int, ...]
    n_slots: int = 4
    max_len: int = 192


@dataclasses.dataclass(frozen=True)
class HostOverheads:
    """Per-launch host costs (seconds) — dispatch, policy bookkeeping and
    the one device download each launch pays.  The reference's defaults;
    they only matter relative to each other and to the device step time,
    which is what the ranking consumes."""

    segment_s: float = 3e-3  # per decode-segment launch + toks download
    prefill_s: float = 2.5e-3  # per prefill launch (upload + dispatch)
    admit_s: float = 5e-4  # per admit round of host bookkeeping
    step_s: float = 1e-3  # per compiled loop step (CPU backend dispatch)
    table_entry_s: float = 1e-6  # per block-table entry refreshed per segment


@dataclasses.dataclass(frozen=True)
class Prediction:
    knobs: KnobConfig
    time_s: float
    tok_s: float  # useful tokens (Σ new_tokens) per predicted second
    n_segments: int
    n_prefill_launches: int


def predict(
    knobs: KnobConfig,
    workload: WorkloadSpec,
    cfg: ModelConfig,
    hw: HWTarget = H100,
    oh: HostOverheads | None = None,
    spec_accept_len: float | None = None,
    paged: bool = False,
    cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> Prediction:
    """Simulate the scheduler's policy loop under ``knobs`` and return the
    predicted useful throughput.  Mirrors the "while" segment mode: a
    segment early-exits at the first retirement whenever admission work is
    pending, else runs to ``segment_len`` (or until every live slot
    finishes)."""
    oh = oh or HostOverheads()
    w = workload
    k = knobs.spec_k
    emit = max(1.0, float(spec_accept_len or 1.0)) if k else 1.0
    if k:
        c = spec_verify_cost(cfg, k, w.n_slots, w.max_len,
                             cache_bytes_per_elem=cache_bytes_per_elem,
                             weight_bytes_per_elem=weight_bytes_per_elem)
    else:
        c = decode_step_cost(cfg, w.n_slots, w.max_len, cache_bytes_per_elem,
                             weight_bytes_per_elem)
    t_step = step_time(c, hw) + oh.step_s
    seg_fixed = oh.segment_s
    if paged:
        seg_fixed += w.n_slots * (w.max_len // knobs.block_len) * oh.table_entry_s

    chunk = knobs.prefill_chunk
    buckets = (tuple(chunk >> i for i in reversed(range(knobs.prefill_buckets)))
               if chunk else ())

    queue = deque(zip(w.prompt_lens, w.new_tokens))
    slots: list[dict | None] = [None] * w.n_slots
    t = 0.0
    n_seg = n_pre = 0
    for _ in range(1_000_000):  # bounded: every iteration makes progress
        if not queue and all(s is None for s in slots):
            break
        t += oh.admit_s
        for i in range(w.n_slots):
            if slots[i] is None and queue:
                plen, nnew = queue.popleft()
                slots[i] = {"pre": plen, "plen": plen, "rem": nnew,
                            "live": False}

        def _free(s: dict) -> None:
            for j, x in enumerate(slots):  # identity, not dict equality
                if x is s:
                    slots[j] = None
                    return

        def _activate(s: dict) -> None:
            # the prefill launch samples the request's first token
            s["live"] = True
            s["rem"] -= 1
            if s["rem"] <= 0:
                _free(s)

        if chunk == 0:
            for s in list(slots):
                if s is not None and not s["live"]:
                    cost = prefill_chunk_cost(
                        cfg, 1, s["plen"],
                        cache_bytes_per_elem=cache_bytes_per_elem,
                        weight_bytes_per_elem=weight_bytes_per_elem)
                    t += oh.prefill_s + step_time(cost, hw)
                    n_pre += 1
                    s["pre"] = 0
                    _activate(s)
        else:
            # one chunk per prefilling slot per round, bucket-grouped
            # launches; rounds drain back-to-back while <= 1 decode is live
            while any(s is not None and not s["live"] for s in slots):
                groups: dict[int, list] = {}
                for s in slots:
                    if s is None or s["live"]:
                        continue
                    rem = s["pre"]
                    if rem > chunk:
                        b, real = chunk, chunk
                    else:
                        b = next(x for x in buckets if x >= rem)
                        real = rem
                    groups.setdefault(b, []).append(
                        (s, real, s["plen"] - s["pre"]))
                for b in sorted(groups):
                    rows = groups[b]
                    width = 1 << (len(rows) - 1).bit_length()
                    ctx = sum(b * st + b * (b + 1) / 2.0 for _, _, st in rows)
                    ctx += (width - len(rows)) * b * (b + 1) / 2.0
                    cost = prefill_chunk_cost(
                        cfg, width, b, ctx_sum=ctx,
                        cache_bytes_per_elem=cache_bytes_per_elem,
                        weight_bytes_per_elem=weight_bytes_per_elem)
                    t += oh.prefill_s + step_time(cost, hw)
                    n_pre += 1
                    for s, real, _ in rows:
                        s["pre"] -= real
                        if s["pre"] <= 0:
                            _activate(s)
                n_live = sum(1 for s in slots
                             if s is not None and s["live"])
                if n_live > 1:
                    break

        live = [s for s in slots if s is not None and s["live"]]
        if not live:
            continue
        finish = [math.ceil(s["rem"] / emit) for s in live]
        pending = bool(queue) or any(
            s is not None and not s["live"] for s in slots)
        steps = min(knobs.segment_len,
                    min(finish) if pending else max(finish))
        t += seg_fixed + steps * t_step
        n_seg += 1
        for s in live:
            got = min(s["rem"], int(steps * emit))
            s["rem"] -= got
            if s["rem"] <= 0:
                _free(s)
    useful = float(sum(w.new_tokens))
    return Prediction(knobs, t, useful / t if t > 0 else 0.0, n_seg, n_pre)


def default_candidates(
    workload: WorkloadSpec,
    paged: bool = False,
    spec_ks: tuple[int, ...] = (0,),
) -> list[KnobConfig]:
    """The default search grid, respecting the scheduler's structural
    constraints (chunk and block_len divide max_len; spec_k needs
    ``spec_k < block_len`` under paging; buckets fit the chunk)."""
    ml = workload.max_len
    segs = (4, 8, 16, 32)
    chunks = [0] + [c for c in (16, 32, 64, 128) if c <= ml and ml % c == 0]
    bls = tuple(b for b in ((16, 32) if paged else (16,)) if ml % b == 0)
    bls = bls or (16,)
    out = []
    for seg in segs:
        for ch in chunks:
            nb = min(4, ch.bit_length()) if ch else 4
            for bl in bls:
                for k in spec_ks:
                    if paged and k and k >= bl:
                        continue
                    out.append(KnobConfig(seg, ch, nb, k, bl))
    return out


@dataclasses.dataclass
class AutotuneResult:
    best: KnobConfig
    ranked: list[Prediction]  # descending predicted tok/s

    def report(self) -> str:
        lines = [f"{'config':<24}{'pred tok/s':>12}{'segments':>10}"
                 f"{'prefills':>10}"]
        for p in self.ranked:
            lines.append(f"{p.knobs.label():<24}{p.tok_s:>12.1f}"
                         f"{p.n_segments:>10d}{p.n_prefill_launches:>10d}")
        return "\n".join(lines)


def autotune(
    cfg: ModelConfig,
    workload: WorkloadSpec,
    candidates: list[KnobConfig] | None = None,
    hw: HWTarget = H100,
    oh: HostOverheads | None = None,
    spec_accept_len: float | None = None,
    paged: bool = False,
    spec_ks: tuple[int, ...] = (0,),
    cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> AutotuneResult:
    """Rank ``candidates`` (default grid when None) by predicted tok/s."""
    cands = candidates or default_candidates(workload, paged, spec_ks)
    preds = [predict(kc, workload, cfg, hw, oh, spec_accept_len, paged,
                     cache_bytes_per_elem=cache_bytes_per_elem,
                     weight_bytes_per_elem=weight_bytes_per_elem)
             for kc in cands]
    ranked = sorted(preds, key=lambda p: p.tok_s, reverse=True)
    return AutotuneResult(best=ranked[0].knobs, ranked=ranked)


class DrainPredictor:
    """Queue-drain time prediction for the serving front door.

    ``predict`` speaks model units (its device times are the ``hw``
    target's, not the serving box's), so the predictor calibrates the
    model→wall scale online: ``observe`` folds each finished request's
    measured wall time into an EWMA of measured/modelled per-request time,
    and ``drain_s`` then prices an arbitrary queue composition through ONE
    ``predict`` call and scales it to wall seconds — the ``Retry-After``
    a 429 carries tracks what is actually queued instead of a scalar
    request-rate EWMA.

    Single-request model times are memoized on power-of-two shape buckets,
    so a steady-state ``observe`` costs one dict lookup; ``drain_s``
    returns ``None`` until the first observation lands (callers fall back
    to their own heuristic).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        knobs: KnobConfig,
        n_slots: int,
        max_len: int,
        paged: bool = False,
        alpha: float = 0.2,
        hw: HWTarget = H100,
    ):
        assert 0.0 < alpha <= 1.0, alpha
        self.cfg = cfg
        self.knobs = knobs
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.paged = paged
        self.alpha = float(alpha)
        self.hw = hw
        self.scale: float | None = None  # model s -> wall s (None = cold)
        self.n_obs = 0
        self._single: dict[tuple[int, int], float] = {}

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, int(n) - 1).bit_length()

    def _model_s(self, plens, news) -> float:
        w = WorkloadSpec(tuple(int(p) for p in plens),
                         tuple(int(n) for n in news),
                         n_slots=self.n_slots, max_len=self.max_len)
        return predict(self.knobs, w, self.cfg, hw=self.hw,
                       paged=self.paged).time_s

    def _single_model_s(self, plen: int, nnew: int) -> float:
        key = (self._bucket(plen), self._bucket(nnew))
        t = self._single.get(key)
        if t is None:
            t = self._single[key] = self._model_s([key[0]], [key[1]])
        return t

    @property
    def calibrated(self) -> bool:
        return self.scale is not None

    def observe(self, plen: int, nnew: int, measured_s: float) -> None:
        """Fold one finished request's measured wall time into the
        model→wall scale.  The measured wall includes queueing and slot
        sharing, so the EWMA absorbs the serving box's average concurrency
        — exactly the bias a drain estimate wants."""
        if measured_s <= 0 or nnew < 1:
            return
        model = self._single_model_s(plen, nnew)
        if model <= 0:
            return
        ratio = measured_s / model
        self.scale = (ratio if self.scale is None
                      else (1 - self.alpha) * self.scale + self.alpha * ratio)
        self.n_obs += 1

    def drain_s(self, plens, news) -> float | None:
        """Predicted wall seconds to drain the given composition (see
        ``ContinuousScheduler.queue_composition``); ``None`` while
        uncalibrated or when nothing is queued."""
        if self.scale is None or not plens:
            return None
        return self._model_s(plens, news) * self.scale

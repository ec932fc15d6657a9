"""Multi-tenant admission policy for the continuous scheduler.

The port of ``repro.serve.policy``, whole (host Python; the port keeps its
own copy so that it imports nothing of the JAX package).  The same call
sequence gives the same picks, sheds and levels in both packages: the
shedding draws come from the same seeded ``random.Random``.

``TenantPolicy`` decides WHICH queued request the scheduler admits next and
WHETHER a submission is accepted at all; the scheduler stays the only owner
of slots, blocks, and segments.  Three mechanisms compose:

* **Priority classes** (``PriorityClass``): strict ordering across
  ``level``s — a queued interactive request always admits before a queued
  batch request — plus per-class serving knobs the scheduler consults:
  ``prefill_chunk_cap`` (cap the chunked-prefill chunk length so a batch
  tenant's long prompt cannot monopolize a prefill launch; must be a member
  of the scheduler's bucket set), ``prefill_token_budget`` (Sarathi-style
  per-round token budget override), and ``ttft_deadline_s`` (default TTFT
  deadline stamped on submissions that carry none).
* **Deficit round-robin** within a level (``TenantSpec.weight``): each
  tenant accumulates ``quantum × weight`` credit per scheduling visit and
  spends ``prompt_len + max_new_tokens`` per admission, so over any
  backlogged window tenants receive token-weighted shares proportional to
  their weights, and no backlogged tenant is ever starved (every RR cycle
  either serves it or moves it ``quantum × weight`` closer to service).
  Deficits are never banked while a tenant is idle: a tenant with nothing
  queued at a level has its deficit dropped at the next commit.
* **Token-bucket rate limiting** (``TenantSpec.rate``/``burst``): a
  sustained requests/s bound enforced at ``submit`` — an over-rate
  submission raises :class:`RateLimited` carrying the retry-after hint the
  HTTP front door surfaces as ``429`` + ``Retry-After``.
* **SLO feedback** (``SloConfig``/``SloMonitor``): a windowed monitor
  of per-class observed TTFT drives the brownout ladder — shed victim-class
  submissions (:class:`Overloaded`), clamp victim prefill knobs, close
  victim admission — with hysteresis.  DRR is elastic: idle tenants' unused
  share is redistributed pro-rata to the backlogged set each round.

The select/commit split keeps the scheduler's deferral semantics intact:
``select(queue)`` is a PURE peek (no deficit/cursor mutation) so a paged
deferral of the picked head leaves the policy state untouched;
``on_admitted(queue, req)`` replays the identical walk and commits it.
Preempted requests (non-empty ``slot_history``) bypass the policy entirely:
they were already charged at first admission and requeue at the queue
front, where both the FIFO path and ``select`` honor them first.

Thread-safety: none — the policy mutates plain dicts.  The HTTP front door
serializes all submissions and admissions through the scheduler worker
thread, and the offline launcher is single-threaded, so no lock is needed.
"""
from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Iterable, Sequence

from repro_torch.serve.request import Request


class RateLimited(Exception):
    """A tenant exceeded its token-bucket rate; retry after the hint."""

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"tenant '{tenant}' over rate limit; retry after "
            f"{self.retry_after_s:.2f}s"
        )


class Overloaded(RateLimited):
    """Shed by the brownout controller: the victim class is turned away
    while the target class's observed TTFT is over its deadline.  Subclasses
    :class:`RateLimited` so every 429 path (front door, launcher) handles it
    unchanged; carries the brownout level for observability."""

    def __init__(self, tenant: str, retry_after_s: float, priority: str,
                 level: int):
        self.priority = priority
        self.level = level
        Exception.__init__(
            self,
            f"'{priority}' submission shed at brownout level {level}; "
            f"retry after {float(retry_after_s):.2f}s"
        )
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """A named service class: strict admission level + per-class knobs.

    ``prefill_chunk_cap=0`` and ``prefill_token_budget=None`` inherit the
    scheduler's settings; ``ttft_deadline_s=None`` leaves submissions
    unbounded unless they carry their own deadline."""

    name: str
    level: int
    prefill_chunk_cap: int = 0
    prefill_token_budget: int | None = None
    ttft_deadline_s: float | None = None


# the built-in ladder: strict interactive > standard > batch ordering with
# every serving knob inherited from the scheduler (callers override by
# passing their own classes with caps/budgets/deadlines)
DEFAULT_CLASSES = (
    PriorityClass("interactive", level=2),
    PriorityClass("standard", level=1),
    PriorityClass("batch", level=0),
)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Closed-loop overload control (the brownout ladder).

    The controller watches the ``target_class``'s observed TTFT quantile
    (completed requests + currently-waiting ages, so it reacts before the
    damage completes) against that class's ``ttft_deadline_s``.  When the
    quantile crosses ``enter[i] × deadline`` the ladder steps to level
    ``i+1``; each level degrades every class at or below the
    ``victim_class``'s level:

        level 1   shed ``shed_frac[0]`` of victim submissions with 429s
        level 2   + clamp victim prefill chunk cap / token budget to the
                  scheduler's smallest prefill bucket
        level 3   stop admitting victim submissions entirely

    Hysteresis: stepping UP is immediate (possibly multiple levels);
    stepping DOWN requires ``dwell`` consecutive updates below
    ``exit_ratio × enter[level-1] × deadline``, one level at a time — the
    gap between the entry and exit thresholds is what stops the controller
    flapping at a threshold boundary."""

    target_class: str = "interactive"
    victim_class: str = "batch"
    quantile: float = 0.9
    window: int = 64
    min_obs: int = 4
    enter: tuple[float, float, float] = (0.6, 0.85, 1.1)
    exit_ratio: float = 0.7
    dwell: int = 4
    shed_frac: tuple[float, float] = (0.5, 0.85)
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1): {self.quantile}")
        if self.window < 1 or self.min_obs < 1:
            raise ValueError("window and min_obs must be >= 1")
        if len(self.enter) != 3 or any(
                a >= b for a, b in zip(self.enter, self.enter[1:])):
            raise ValueError(
                f"enter must be 3 increasing fractions: {self.enter}")
        if not 0.0 < self.exit_ratio < 1.0:
            raise ValueError(f"exit_ratio must be in (0, 1): {self.exit_ratio}")
        if self.dwell < 1:
            raise ValueError(f"dwell must be >= 1: {self.dwell}")
        if len(self.shed_frac) != 2 or any(
                not 0.0 <= f <= 1.0 for f in self.shed_frac):
            raise ValueError(
                f"shed_frac must be 2 fractions in [0, 1]: {self.shed_frac}")


def _quantile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of a non-empty sample (no numpy: the policy
    layer stays stdlib-only)."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


class SloMonitor:
    """Windowed per-class TTFT/latency observation + the brownout ladder.

    Host-side and allocation-free on the hot path: ``observe_*`` appends to
    a bounded deque, ``update`` runs once per segment.  Shedding draws from
    its own seeded ``random.Random`` so a workload replays its shed
    decisions exactly."""

    def __init__(self, cfg: SloConfig, classes: dict[str, PriorityClass]):
        for role in ("target_class", "victim_class"):
            name = getattr(cfg, role)
            if name not in classes:
                raise ValueError(
                    f"SloConfig.{role} '{name}' is not a priority class "
                    f"(have {sorted(classes)})"
                )
        target = classes[cfg.target_class]
        if target.ttft_deadline_s is None:
            raise ValueError(
                f"SloConfig target class '{target.name}' has no "
                "ttft_deadline_s — the controller needs a deadline to "
                "steer toward"
            )
        if classes[cfg.victim_class].level >= target.level:
            raise ValueError(
                f"victim class '{cfg.victim_class}' must rank below target "
                f"'{cfg.target_class}'"
            )
        self.cfg = cfg
        self.deadline = float(target.ttft_deadline_s)
        self._level_of = {name: c.level for name, c in classes.items()}
        self._victim_level = classes[cfg.victim_class].level
        self.level = 0
        self._dwell = 0
        self._rng = random.Random(cfg.seed)
        self._ttft: dict[str, deque] = {
            name: deque(maxlen=cfg.window) for name in classes}
        self._lat: dict[str, deque] = {
            name: deque(maxlen=cfg.window) for name in classes}
        self.shed: dict[str, int] = {}
        self.level_changes = 0
        self.last_quantile: float | None = None

    def degrades(self, priority: str) -> bool:
        """Whether the brownout ladder degrades this class (at or below the
        victim class's level — never the target or anything above it)."""
        return self._level_of[priority] <= self._victim_level

    # ------------------------------------------------------- observation

    def observe_ttft(self, priority: str, ttft_s: float) -> None:
        self._ttft[priority].append(float(ttft_s))

    def observe_latency(self, priority: str, latency_s: float) -> None:
        self._lat[priority].append(float(latency_s))

    def update(self, waiting_ages: Sequence[float] = ()) -> int | None:
        """One controller step: recompute the target class's TTFT quantile
        over completed observations + the target class's currently-waiting
        ages, move the ladder, return the new level on a change (else
        ``None``)."""
        cfg = self.cfg
        sample = list(self._ttft[cfg.target_class])
        sample.extend(float(a) for a in waiting_ages)
        if len(sample) < cfg.min_obs:
            return None
        p = self.last_quantile = _quantile(sample, cfg.quantile)
        want = 0
        for i, frac in enumerate(cfg.enter):
            if p >= frac * self.deadline:
                want = i + 1
        old = self.level
        if want > self.level:
            self.level, self._dwell = want, 0  # step up immediately
        elif (self.level
              and p < cfg.exit_ratio * cfg.enter[self.level - 1]
              * self.deadline):
            self._dwell += 1
            if self._dwell >= cfg.dwell:  # step down one level, slowly
                self.level, self._dwell = self.level - 1, 0
        else:
            self._dwell = 0  # inside the hysteresis band: hold
        if self.level != old:
            self.level_changes += 1
            return self.level
        return None

    # ---------------------------------------------------------- shedding

    def should_shed(self, priority: str) -> bool:
        """Seeded admission-shed decision for one submission at the current
        brownout level (counts what it sheds)."""
        if self.level == 0 or not self.degrades(priority):
            return False
        if self.level >= 3:
            shed = True  # level 3: victim admission fully closed
        else:
            shed = self._rng.random() < self.cfg.shed_frac[self.level - 1]
        if shed:
            self.shed[priority] = self.shed.get(priority, 0) + 1
        return shed

    def snapshot(self) -> dict:
        """Controller state for /v1/stats: ladder position, per-class
        observed quantiles, shed counters."""
        classes = {}
        for name in self._ttft:
            ttfts, lats = self._ttft[name], self._lat[name]
            classes[name] = {
                "observed": len(ttfts),
                "ttft_p50_s": _quantile(ttfts, 0.50) if ttfts else None,
                "ttft_p99_s": _quantile(ttfts, 0.99) if ttfts else None,
                "latency_p99_s": _quantile(lats, 0.99) if lats else None,
                "shed": self.shed.get(name, 0),
            }
        return {
            "brownout_level": self.level,
            "target_class": self.cfg.target_class,
            "victim_class": self.cfg.victim_class,
            "ttft_deadline_s": self.deadline,
            "last_quantile_s": self.last_quantile,
            "level_changes": self.level_changes,
            "classes": classes,
        }


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Per-tenant policy: DRR weight, optional token-bucket rate limit
    (sustained ``rate`` requests/s with ``burst`` depth), and the priority
    class used when a submission names none."""

    weight: float = 1.0
    rate: float | None = None
    burst: int = 1
    default_priority: str = "standard"

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


def _cost(req: Request) -> int:
    """DRR cost of admitting a request: its full token footprint (prompt
    prefill + generation budget) — what it will actually consume of the
    serving capacity it was admitted into."""
    return req.prompt_len + req.max_new_tokens


class TenantPolicy:
    def __init__(
        self,
        tenants: dict[str, TenantSpec] | None = None,
        classes: Sequence[PriorityClass] = DEFAULT_CLASSES,
        quantum: int = 64,
        default_spec: TenantSpec = TenantSpec(),
        slo: SloConfig | None = None,
    ):
        assert quantum >= 1, quantum
        self.quantum = int(quantum)
        self.default_spec = default_spec
        self.classes: dict[str, PriorityClass] = {}
        for cls in classes:
            if cls.name in self.classes:
                raise ValueError(f"duplicate priority class '{cls.name}'")
            cap = cls.prefill_chunk_cap
            if cap < 0 or (cap and cap & (cap - 1)):
                raise ValueError(
                    f"class '{cls.name}': prefill_chunk_cap must be 0 or a "
                    f"power of two, got {cap}"
                )
            if cls.prefill_token_budget is not None and cls.prefill_token_budget < 0:
                raise ValueError(
                    f"class '{cls.name}': prefill_token_budget must be >= 0"
                )
            self.classes[cls.name] = cls
        self.tenants: dict[str, TenantSpec] = {}
        self._tenant_order: list[str] = []  # registration order = RR order
        for name, spec in (tenants or {}).items():
            self._register(name, spec)
        # DRR state: (level, tenant) -> unspent credit; level -> the tenant
        # whose service visit is in progress (classic DRR: a visit is
        # granted ONE quantum and serves while its credit lasts; the RR
        # walk resumes after the visiting tenant)
        self._deficit: dict[tuple[int, str], float] = {}
        self._visit: dict[int, str] = {}
        # token buckets: tenant -> [tokens, last_refill_t]
        self._bucket: dict[str, list[float]] = {}
        # per-tenant counters (surfaced through stats + TraceRecorder)
        self.submitted: dict[str, int] = {}
        self.admitted: dict[str, int] = {}
        self.served_tokens: dict[str, int] = {}
        self.rate_rejections: dict[str, int] = {}
        # SLO feedback: the brownout controller (None = open-loop policy)
        # and the smallest scheduler prefill bucket its level-2 clamp
        # shrinks victim-class chunk caps / token budgets to (bound by the
        # scheduler at init via bind_chunk_buckets)
        self.slo = SloMonitor(slo, self.classes) if slo is not None else None
        self._min_bucket: int | None = None

    # ------------------------------------------------------------ tenants

    def _register(self, name: str, spec: TenantSpec) -> TenantSpec:
        if spec.default_priority not in self.classes:
            raise ValueError(
                f"tenant '{name}': unknown default priority "
                f"'{spec.default_priority}' (have {sorted(self.classes)})"
            )
        self.tenants[name] = spec
        self._tenant_order.append(name)
        return spec

    def spec_for(self, tenant: str) -> TenantSpec:
        """The tenant's spec, lazily registering unknown tenants with the
        default spec (first-contact order fixes their RR position)."""
        spec = self.tenants.get(tenant)
        if spec is None:
            spec = self._register(tenant, self.default_spec)
        return spec

    def class_for(self, priority: str) -> PriorityClass:
        cls = self.classes.get(priority)
        if cls is None:
            raise ValueError(
                f"unknown priority class '{priority}' "
                f"(have {sorted(self.classes)})"
            )
        return cls

    # ------------------------------------------------- per-class knobs

    def bind_chunk_buckets(self, buckets: Sequence[int]) -> None:
        """Scheduler handshake at init: the prefill bucket set, so the
        level-2 brownout clamp shrinks to a bucket member (any other cap
        would violate the scheduler's trace bound)."""
        self._min_bucket = min(buckets) if buckets else None

    def _braked(self, priority: str) -> bool:
        """Whether the level-2 brownout clamp applies to this class now."""
        return (self.slo is not None and self.slo.level >= 2
                and self.slo.degrades(priority)
                and self._min_bucket is not None)

    def chunk_cap(self, priority: str) -> int:
        """Chunked-prefill chunk cap for a class (0 = scheduler default);
        clamped to the smallest prefill bucket under brownout level >= 2."""
        cap = self.class_for(priority).prefill_chunk_cap
        if self._braked(priority):
            return self._min_bucket if cap == 0 else min(cap, self._min_bucket)
        return cap

    def token_budget(self, priority: str) -> int | None:
        """Per-round prefill token budget override (None = inherit);
        clamped to the smallest prefill bucket under brownout level >= 2."""
        budget = self.class_for(priority).prefill_token_budget
        if self._braked(priority):
            return (self._min_bucket if budget is None
                    else min(budget, self._min_bucket))
        return budget

    def ttft_default(self, priority: str) -> float | None:
        return self.class_for(priority).ttft_deadline_s

    # ------------------------------------------------------ SLO feedback

    @property
    def brownout_level(self) -> int:
        return self.slo.level if self.slo is not None else 0

    def should_shed(self, priority: str) -> bool:
        """Brownout admission shed for one submission (seeded, counted)."""
        return self.slo is not None and self.slo.should_shed(priority)

    def shed_retry_after(self) -> float:
        """Coarse retry hint for a shed 429 — the target deadline (the
        soonest the ladder could plausibly have stepped down); the front
        door overrides it with the predicted queue-drain time."""
        return max(1.0, self.slo.deadline) if self.slo is not None else 1.0

    def observe_ttft(self, priority: str, ttft_s: float) -> None:
        if self.slo is not None:
            self.slo.observe_ttft(priority, ttft_s)

    def observe_latency(self, priority: str, latency_s: float) -> None:
        if self.slo is not None:
            self.slo.observe_latency(priority, latency_s)

    def update_slo(self, waiting_ages: Sequence[float] = ()) -> int | None:
        """One controller step (call once per segment); returns the new
        brownout level on a change."""
        if self.slo is None:
            return None
        return self.slo.update(waiting_ages)

    def level_of(self, priority: str) -> int:
        return self.class_for(priority).level

    def slo_snapshot(self) -> dict | None:
        return self.slo.snapshot() if self.slo is not None else None

    # ------------------------------------------------------ rate limiting

    def charge_rate(self, tenant: str, now: float) -> float | None:
        """Charge one submission against the tenant's token bucket.
        Returns ``None`` when admitted, else the retry-after hint in
        seconds (and counts the rejection)."""
        spec = self.spec_for(tenant)
        if spec.rate is None:
            return None
        b = self._bucket.get(tenant)
        if b is None:
            b = self._bucket[tenant] = [float(spec.burst), now]
        b[0] = min(float(spec.burst), b[0] + (now - b[1]) * spec.rate)
        b[1] = now
        if b[0] >= 1.0:
            b[0] -= 1.0
            return None
        self.rate_rejections[tenant] = self.rate_rejections.get(tenant, 0) + 1
        return (1.0 - b[0]) / spec.rate

    # -------------------------------------------------------- accounting

    def note_submitted(self, tenant: str) -> None:
        self.submitted[tenant] = self.submitted.get(tenant, 0) + 1

    def note_tokens(self, tenant: str, n: int = 1) -> None:
        self.served_tokens[tenant] = self.served_tokens.get(tenant, 0) + n

    def snapshot(self) -> dict:
        """Per-tenant counters + policy config, for stats endpoints."""
        out = {}
        for name in self._tenant_order:
            spec = self.tenants[name]
            out[name] = {
                "weight": spec.weight,
                "rate": spec.rate,
                "default_priority": spec.default_priority,
                "submitted": self.submitted.get(name, 0),
                "admitted": self.admitted.get(name, 0),
                "served_tokens": self.served_tokens.get(name, 0),
                "rate_rejections": self.rate_rejections.get(name, 0),
            }
        return out

    # ------------------------------------------------------ DRR admission

    def select(self, queue: Iterable[Request]) -> Request | None:
        """PURE peek at the next request to admit (no state mutation):
        preempted requests first in queue order, then the highest backlogged
        priority level, then the level's DRR pick.  The scheduler may defer
        the pick (paged pool pressure) and re-select next round."""
        return self._pick(queue, commit=False)

    def on_admitted(self, queue: Iterable[Request], req: Request) -> None:
        """Commit the admission ``select`` peeked (call BEFORE removing
        ``req`` from the queue).  Readmissions of preempted requests were
        charged at first admission and commit nothing."""
        self.admitted[req.tenant] = self.admitted.get(req.tenant, 0) + 1
        if req.slot_history:
            return  # preempted readmit: already charged
        picked = self._pick(queue, commit=True)
        assert picked is req, (
            f"on_admitted(rid={req.rid}) does not match the policy pick "
            f"(rid={picked.rid if picked else None}); admit what select() "
            f"returned, in the same queue state"
        )

    def _pick(self, queue: Iterable[Request], commit: bool) -> Request | None:
        heads: dict[int, dict[str, Request]] = {}
        for r in queue:
            if r.slot_history:
                # preemption victims requeue at the front and resume first
                # regardless of tenant or class — they already hold charged
                # credit and dropping them would strand replay state
                return r
            lvl = self.class_for(r.priority).level
            heads.setdefault(lvl, {}).setdefault(r.tenant, r)
        if not heads:
            return None
        level = max(heads)
        return self._drr_pick(level, heads[level], commit)

    def _drr_pick(self, level: int, heads: dict[str, Request],
                  commit: bool) -> Request:
        for t in heads:  # queue-front tenants the submit path never saw
            self.spec_for(t)
        deficits = self._deficit if commit else dict(self._deficit)
        if commit:
            # idle tenants never bank credit: drop deficits for tenants
            # with nothing queued at this level
            for key in [k for k in deficits
                        if k[0] == level and k[1] not in heads]:
                del deficits[key]
        # continuing visit: the visiting tenant serves from its remaining
        # credit with NO new quantum; when its credit no longer covers its
        # head, the visit ends and the walk resumes after it
        v = self._visit.get(level)
        if v in heads and deficits.get((level, v), 0.0) >= _cost(heads[v]):
            if commit:
                deficits[(level, v)] -= _cost(heads[v])
            return heads[v]
        # RR order = registration order resuming AFTER the last visit
        # (the ended visit's tenant goes last, keeping its unspent credit)
        if v is not None and v in self._tenant_order:
            i = self._tenant_order.index(v)
            ordered = self._tenant_order[i + 1:] + self._tenant_order[:i + 1]
        else:
            ordered = self._tenant_order
        order = [t for t in ordered if t in heads]
        # elastic DRR: idle tenants' share is redistributed pro-rata to the
        # backlogged set each round instead of going unused — every visit's
        # credit is scaled by total_weight / active_weight, so relative
        # shares among ACTIVE tenants are unchanged (the scale cancels in
        # any credit ratio) but the round serves the same token volume the
        # full tenant set would have
        total_w = sum(self.tenants[t].weight for t in self._tenant_order)
        active_w = sum(self.tenants[t].weight for t in order)
        scale = total_w / active_w if active_w else 1.0
        # each cycle opens a quantum×weight visit for every tenant in turn,
        # so service is reached within ceil(max_cost / min_credit) cycles
        max_cost = max(_cost(r) for r in heads.values())
        min_credit = self.quantum * scale * min(
            self.tenants[t].weight for t in order)
        cycles = int(max_cost / min_credit) + 2
        for _ in range(cycles):
            for t in order:
                key = (level, t)
                d = (deficits.get(key, 0.0)
                     + self.quantum * self.tenants[t].weight * scale)
                if d >= _cost(heads[t]):
                    if commit:
                        deficits[key] = d - _cost(heads[t])
                        self._visit[level] = t
                    return heads[t]
                deficits[key] = d  # visit ends unserved; credit persists
        raise AssertionError(
            f"DRR walk did not converge in {cycles} cycles "
            f"(level={level}, tenants={order})"
        )  # unreachable: the credit bound above guarantees service

"""The port's continuous scheduler with a tenant policy held against the JAX
package's (``tests/test_serve_deadlines.py`` and the scheduler-facing cases
of ``tests/test_serve_policy.py`` and ``tests/test_serve_slo.py`` are the
checklist): DRR admission order, per-class chunk caps and prefill token
budgets, the class-ordered preemption victim, the brownout ladder stepped
once per segment, ``Overloaded`` / ``RateLimited`` / unknown-class
``ValueError`` at ``submit``, class-default TTFT deadlines and the SLO
observations at expiry, and every per-class and per-tenant counter.

Setup as ``tests/torch_scheduler_pair.py`` says (reduced tinyllama, fp32
compute, int8 weights at (16, 16), the port on its plain versions).  Each
case is one script run against both packages (``twin``) with a fake clock
the script advances, the same policy built from each package's own
classes, and ``debug_invariants`` on: the scripts' logs (which requests
sit in which slot and in which queue order after every segment, the
brownout level, what each ``submit`` raised), every request's tokens,
state, finish reason, TTFT and latency, the scheduler's counters and the
policy's and SLO monitor's snapshots must be equal.  Survivors' tokens are
also ``generate``'s at B = 1.
"""
from __future__ import annotations

import types

import pytest

import repro.serve as jax_serve
import repro_torch.serve.chaos as port_chaos
import repro_torch.serve.policy as port_policy
import repro_torch.serve.scheduler as port_scheduler
from torch_scheduler_pair import COUNTERS, generate, prompts_of, sides_fixture

JAX = types.SimpleNamespace(
    name="jax", Scheduler=jax_serve.ContinuousScheduler, ChaosConfig=jax_serve.ChaosConfig,
    **{n: getattr(jax_serve, n) for n in ("Overloaded", "PriorityClass", "RateLimited",
                                          "SloConfig", "TenantPolicy", "TenantSpec")})
PORT = types.SimpleNamespace(
    name="port", Scheduler=port_scheduler.ContinuousScheduler,
    ChaosConfig=port_chaos.ChaosConfig,
    **{n: getattr(port_policy, n) for n in ("Overloaded", "PriorityClass", "RateLimited",
                                            "SloConfig", "TenantPolicy", "TenantSpec")})
POLICY_STATS = ("tenant_tokens", "preemptions_by_class", "brownout_changes",
                "prefill_tokens_per_round", "prefill_batch_hist", "admissions_per_slot",
                "prefill_launches", "chunks_prefilled", "blocks_reclaimed_cancel")
DEBUG = dict(debug_invariants=True)


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


def _view(sched):
    """Who holds which slot, the queue order, the ladder: after a segment."""
    return ([r.rid if r is not None else None for r in sched.slots],
            [r.rid for r in sched.queue], sched.policy.brownout_level,
            sched.stats["segments"])


def _submit(side, sched, log, prompt, n, **kw):
    """``submit`` that logs what it returned or raised."""
    try:
        h = sched.submit(prompt, n, **kw)
    except side.RateLimited as e:  # Overloaded too
        log.append((type(e).__name__, e.tenant, e.retry_after_s, getattr(e, "level", None)))
        return None
    except ValueError as e:
        log.append(("ValueError", str(e)))
        return None
    log.append(("ok", h.rid, h.tenant, h.priority, h.ttft_deadline_s))
    return h


def _summary(sched, handles):
    st = sched.stats
    return ([(h.rid, h.tokens, h.state, h.finish_reason, h.tenant, h.priority, h.ttft,
              h.latency, h.preempts) for h in handles],
            {k: st[k] for k in COUNTERS + POLICY_STATS},
            sched.policy.snapshot(), sched.policy.slo_snapshot())


def twin(sides, script, make_policy, layout="dense", chaos=None, **kw):
    """``script(side, sched, clock) -> (log, handles)`` on the JAX
    scheduler and the port's, each with ``make_policy(side)`` and a fake
    clock (``clock["now"]``, set by the script).  Requires equal logs and
    summaries; returns the port's (log, handles, scheduler)."""
    jeng, teng = sides(layout, **DEBUG)
    runs = []
    for side, eng in ((JAX, jeng), (PORT, teng)):
        clock = {"now": 0.0}
        sched = side.Scheduler(eng, clock=lambda c=clock: c["now"], policy=make_policy(side),
                               chaos=chaos and side.ChaosConfig(**chaos), **kw)
        log, handles = script(side, sched, clock)
        runs.append((log, _summary(sched, handles), handles, sched))
    (jlog, jsum, _, _), (tlog, tsum, th, ts) = runs
    assert tlog == jlog
    assert tsum[0] == jsum[0]
    assert tsum[1:] == jsum[1:]
    return tlog, th, ts


def _oracle(sides, prompts, news):
    eng = sides("dense")[1]
    return [generate(eng, p, n) for p, n in zip(prompts, news)]


def _drain(sched, clock, log, dt=0.05, max_segments=2_000):
    for _ in range(max_segments):
        if not sched.has_work():
            return
        sched.run_segment()
        clock["now"] += dt
        log.append(_view(sched))
    raise RuntimeError("scheduler did not drain")


# --------------------------------------------- DRR order and class knobs

KNOB_CLASSES = (("interactive", 2, 0, None), ("standard", 1, 8, None), ("batch", 0, 4, 4))


def _knob_policy(side):
    return side.TenantPolicy(
        tenants={"acme": side.TenantSpec(weight=3.0), "hobby": side.TenantSpec(),
                 "bulk": side.TenantSpec(default_priority="batch")},
        classes=tuple(side.PriorityClass(n, lv, prefill_chunk_cap=cap,
                                         prefill_token_budget=budget)
                      for n, lv, cap, budget in KNOB_CLASSES),
        quantum=16)


KNOB_LENS = [5, 19, 11, 23, 7, 14, 9, 17, 6]
KNOB_NEWS = [6, 4, 9, 3, 7, 5, 8, 2, 6]
KNOB_WHO = [("acme", None), ("bulk", None), ("hobby", "interactive"), ("acme", None),
            ("bulk", "standard"), ("hobby", None), ("acme", "batch"), ("hobby", None),
            ("bulk", None)]


@pytest.mark.parametrize("layout,budget", [("dense", 0), ("paged", 0), ("dense", 16)])
def test_drr_admission_and_class_knobs_match_jax(sides, layout, budget):
    """Nine requests of three tenants over three classes, queued up front
    over two slots with chunked admission (chunk 8, buckets (4, 8)): the
    DRR pick (interactive first, then weighted shares), batch chunks capped
    at 4 and its round budget at 4 tokens (``budget``: a scheduler budget
    the batch override replaces), per-class and per-tenant counters."""
    prompts = prompts_of(KNOB_LENS, 11)

    def script(side, sched, clock):
        log = []
        handles = [_submit(side, sched, log, p, n, tenant=t, priority=pr)
                   for p, n, (t, pr) in zip(prompts, KNOB_NEWS, KNOB_WHO)]
        _drain(sched, clock, log)
        return log, handles

    kw = dict(n_blocks=40) if layout == "paged" else {}
    _, handles, sched = twin(sides, script, _knob_policy, layout, n_slots=2, segment_len=4,
                             prefill_chunk=8, prefill_buckets=2,
                             prefill_token_budget=budget, **kw)
    assert [h.tokens for h in handles] == _oracle(sides, prompts, KNOB_NEWS)
    # the one interactive request is admitted first, though submitted third
    assert handles[2].priority == "interactive"
    assert handles[2].first_token_t == min(h.first_token_t for h in handles)
    assert sched.stats["tenant_tokens"] == {
        t: sum(n for n, (who, _) in zip(KNOB_NEWS, KNOB_WHO) if who == t)
        for t in ("acme", "bulk", "hobby")}
    assert max(sched.stats["prefill_batch_hist"]) <= 2


# --------------------------------------------------- brownout and submit


def _slo_policy(side):
    return side.TenantPolicy(
        tenants={"acme": side.TenantSpec(default_priority="interactive"),
                 "hobby": side.TenantSpec(rate=8.0, burst=1),
                 "bulk": side.TenantSpec(default_priority="batch")},
        classes=(side.PriorityClass("interactive", 2, ttft_deadline_s=0.4),
                 side.PriorityClass("standard", 1),
                 side.PriorityClass("batch", 0)),
        slo=side.SloConfig(min_obs=2, window=8, dwell=2, seed=3))


@pytest.mark.parametrize("chunked", [False, True])
def test_brownout_ladder_sheds_and_rate_limits_match_jax(sides, chunked):
    """A burst of interactive and batch work over one slot: interactive
    TTFTs (completed and still waiting) climb past the 0.4 s class deadline
    and the ladder steps up — batch submissions are shed with
    ``Overloaded`` (level 3 closes them), the rate-limited tenant gets
    ``RateLimited``, an unknown class ``ValueError`` — then the load drains
    and it steps back down; at level ≥ 2 a batch chunk is clamped to the
    smallest bucket.  The same submissions raise, and the same levels show,
    in both packages."""
    prompts = prompts_of([6, 9, 5, 12, 7, 8, 10, 4, 6, 11, 5, 9], 21)
    news = [5, 8, 6, 4, 9, 3, 7, 5, 6, 4, 8, 5]
    who = ["acme", "bulk", "acme", "bulk", "hobby", "hobby", "acme", "bulk", "hobby",
           "acme", "bulk", "acme"]

    def script(side, sched, clock):
        log, handles = [], []
        for i, (p, n, t) in enumerate(zip(prompts, news, who)):
            h = _submit(side, sched, log, p, n, tenant=t)
            if h is not None:
                handles.append(h)
            if i % 3 == 2:
                _submit(side, sched, log, p, 2, tenant="acme", priority="gold")
                sched.run_segment()
                clock["now"] += 0.15
                log.append(_view(sched))
        # the backlog builds: a batch and a rate-limited submission each
        # segment meet the climbing ladder
        for i in range(8):
            for t in ("bulk", "hobby"):
                h = _submit(side, sched, log, prompts[i], 3, tenant=t)
                if h is not None:
                    handles.append(h)
            sched.run_segment()
            clock["now"] += 0.15
            log.append(_view(sched))
        _drain(sched, clock, log, dt=0.15)
        # quiet period: the ladder steps down once the window fills with
        # healthy TTFTs
        for i in range(20):
            h = _submit(side, sched, log, prompts[i % len(prompts)], 2, tenant="acme")
            if h is not None:
                handles.append(h)
            _drain(sched, clock, log, dt=0.01)
        return log, handles

    kw = dict(prefill_chunk=8, prefill_buckets=2) if chunked else {}
    log, handles, sched = twin(sides, script, _slo_policy, n_slots=1, segment_len=4, **kw)
    kinds = [e[0] for e in log if isinstance(e[0], str)]
    assert {"Overloaded", "RateLimited", "ValueError"} <= set(kinds), kinds
    levels = [e[2] for e in log if isinstance(e[0], list)]
    assert max(levels) >= 2 and levels[-1] < max(levels), levels
    assert sched.stats["brownout_changes"] >= 2
    assert sched.policy.slo_snapshot()["classes"]["batch"]["shed"] == kinds.count("Overloaded")


def test_class_default_ttft_and_rate_gate_order(sides):
    """``submit`` stamps the class's TTFT deadline on submissions that carry
    none and keeps an explicit one; a malformed request from an over-rate
    tenant fails as ``ValueError`` before the rate gate charges it."""
    def make(side):
        return side.TenantPolicy(
            tenants={"lim": side.TenantSpec(rate=1.0, burst=1)},
            classes=(side.PriorityClass("interactive", 2, ttft_deadline_s=0.25),
                     side.PriorityClass("standard", 1)))

    p = prompts_of([5], 31)[0]

    def script(side, sched, clock):
        log = []
        handles = [_submit(side, sched, log, p, 3, priority="interactive"),
                   _submit(side, sched, log, p, 3, priority="interactive",
                           ttft_deadline_s=9.0),
                   _submit(side, sched, log, p, 3, tenant="lim")]
        _submit(side, sched, log, p, 0, tenant="lim")  # ValueError, not charged
        _submit(side, sched, log, p, 3, tenant="lim")  # RateLimited
        clock["now"] = 1.5
        handles.append(_submit(side, sched, log, p, 3, tenant="lim"))  # refilled
        _drain(sched, clock, log)
        return log, handles

    log, handles, sched = twin(sides, script, make, n_slots=2, segment_len=4)
    assert [h.ttft_deadline_s for h in handles] == [0.25, 9.0, None, None]
    assert [e[0] for e in log[:6]] == ["ok", "ok", "ok", "ValueError", "RateLimited", "ok"]
    assert sched.policy.snapshot()["lim"]["rate_rejections"] == 1


# -------------------------------------------------- deadlines (mirrored)


def _deadline_policy(side):
    return side.TenantPolicy(
        tenants={"it": side.TenantSpec(default_priority="interactive"),
                 "bt": side.TenantSpec(default_priority="batch")},
        classes=(side.PriorityClass("interactive", 2, ttft_deadline_s=1.0),
                 side.PriorityClass("standard", 1),
                 side.PriorityClass("batch", 0)),
        slo=side.SloConfig(min_obs=1))


def _slot_of(sched, req):
    return next((s for s, r in enumerate(sched.slots) if r is req), None)


def test_ttft_expiry_mid_prefill_chunk_matches_jax(sides):
    """A long interactive prompt (the class's 1 s TTFT deadline) walking
    8-token chunks under an 8-token budget blows its deadline between
    chunks: it expires with no tokens, its blocks return, the SLO monitor
    observes its waiting age, and the short survivor equals ``generate``."""
    prompts = [prompts_of([40], 20)[0], prompts_of([6], 21)[0]]

    def script(side, sched, clock):
        log = []
        hv = _submit(side, sched, log, prompts[0], 8, tenant="it")
        hs = _submit(side, sched, log, prompts[1], 10, tenant="bt")
        sched.run_segment()
        slot = _slot_of(sched, hv)
        assert slot is not None and slot in sched._prefill_start and hv.first_token_t is None
        held = len(sched.allocator.mapped.get(slot, ()))
        clock["now"] = 2.0
        sched.run_segment()
        assert hv.expired and hv.tokens == [] and held > 0
        assert slot not in sched._prefill_start and slot not in sched.allocator.mapped
        log.append(_view(sched))
        _drain(sched, clock, log)
        assert sched.allocator.n_free == sched.allocator.capacity
        return log, [hv, hs]

    _, (hv, hs), sched = twin(sides, script, _deadline_policy, "paged", n_slots=2,
                              segment_len=4, n_blocks=16, prefill_chunk=8,
                              prefill_buckets=2, prefill_token_budget=8)
    assert hs.done and hs.tokens == _oracle(sides, [prompts[1]], [10])[0]
    assert sched.stats["expired"] == 1
    assert sched.policy.slo_snapshot()["classes"]["interactive"]["observed"] == 1


def test_deadline_expiry_mid_replay_matches_jax(sides):
    """Preempt a request (white box), let its recompute readmission start
    replaying, then pass its total deadline with the replay pending: it
    expires holding a ``generate`` prefix and the pool recovers."""
    prompts, news = prompts_of([8, 6], 30), [24, 12]

    def script(side, sched, clock):
        log = []
        hv = _submit(side, sched, log, prompts[0], news[0], tenant="bt", deadline_s=50.0)
        hs = _submit(side, sched, log, prompts[1], news[1], tenant="it")
        while len(hv.tokens) < 6:
            sched.run_segment()
        sched._preempt_slot(_slot_of(sched, hv))
        assert sched.queue[0] is hv and hv.preempts == 1
        for _ in range(200):
            sched.run_segment()
            log.append(_view(sched))
            slot = _slot_of(sched, hv)
            if slot is not None and sched._replay.get(slot):
                break
        else:
            pytest.fail("readmission never reached a mid-replay boundary")
        clock["now"] = 60.0
        sched.run_segment()
        assert hv.expired and _slot_of(sched, hv) is None and not sched._replay
        _drain(sched, clock, log)
        assert sched.allocator.n_free == sched.allocator.capacity
        return log, [hv, hs]

    _, (hv, hs), _ = twin(sides, script, _deadline_policy, "paged", n_slots=2,
                          segment_len=4, n_blocks=16)
    want = _oracle(sides, prompts, news)
    assert hv.tokens == want[0][:len(hv.tokens)] and len(hv.tokens) >= 6
    assert hs.done and hs.tokens == want[1]


def test_cancel_races_victim_selection_matches_jax(sides):
    """A cancel lands in the segment a forced pool exhaustion selects
    victims: the sweep reclaims the cancelled slot first, nothing double
    frees, and the survivors equal ``generate``."""
    prompts, news = prompts_of([7, 7, 7], 40), [20, 20, 20]

    def script(side, sched, clock):
        log = []
        handles = [_submit(side, sched, log, p, n, tenant=t)
                   for p, n, t in zip(prompts, news, ("it", "bt", "it"))]
        while sched.stats["segments"] < 3:
            sched.run_segment()
            log.append(_view(sched))
        residents = [s for s in range(2) if sched.slots[s] is not None]
        victim = min(residents, key=sched._progress_key)
        cancelled = sched.slots[victim]
        cancelled.cancel()
        held = len(sched.allocator.mapped[victim])
        sched.run_segment()
        assert cancelled.cancelled and sched.stats["blocks_reclaimed_cancel"] >= held > 0
        log.append(("cancelled", cancelled.rid))
        _drain(sched, clock, log)
        return log, handles

    _, handles, sched = twin(sides, script, _deadline_policy, "paged", n_slots=2,
                             segment_len=4, n_blocks=8, overcommit=2.0,
                             chaos=dict(seed=0, exhaust_at=(3, 4, 5)))
    want = _oracle(sides, prompts, news)
    for h, w in zip(handles, want):
        assert h.tokens == (w if h.done else w[:len(h.tokens)]), h.rid
    assert sched.stats["chaos_exhausts"] >= 1
    assert sched.allocator.n_free == sched.allocator.capacity


@pytest.mark.parametrize("preempt_mode", ["recompute", "swap"])
def test_pool_exhaustion_evicts_batch_before_interactive(sides, preempt_mode):
    """Forced exhaustion evicts the batch resident though an interactive
    one has less progress (the class-ordered victim; without a policy the
    least progressed would go), in both packages, and every request then
    equals ``generate``."""
    prompts, news = prompts_of([6, 6, 6], 50), [24, 24, 24]

    def script(side, sched, clock):
        log = []
        ha = _submit(side, sched, log, prompts[0], news[0], tenant="it")
        sched.run_segment()
        sched.run_segment()
        hc = _submit(side, sched, log, prompts[1], news[1], tenant="bt")
        sched.run_segment()
        hb = _submit(side, sched, log, prompts[2], news[2], tenant="it")
        for _ in range(40):
            if sched.stats["preemptions"] >= 1:
                break
            sched.run_segment()
            log.append(_view(sched))
        else:
            pytest.fail("forced exhaustion never produced a preemption")
        assert len(ha.tokens) > len(hc.tokens)
        assert sched.stats["preemptions_by_class"] == {"batch": sched.stats["preemptions"]}
        assert hc.preempts >= 1 and hb.preempts == 0 and ha.preempts == 0
        sched.chaos = None
        _drain(sched, clock, log)
        return log, [ha, hc, hb]

    _, handles, sched = twin(sides, script, _deadline_policy, "paged", n_slots=3,
                             segment_len=4, n_blocks=12, overcommit=2.0,
                             preempt_mode=preempt_mode,
                             chaos=dict(seed=0, exhaust_at=tuple(range(3, 12))))
    assert [h.tokens for h in handles] == _oracle(sides, prompts, news)
    assert all(h.done for h in handles)
    assert sched.allocator.n_free == sched.allocator.capacity


def test_chunk_cap_outside_the_buckets_refused(sides):
    """A class cap that is no bucket of the scheduler would need a prefill
    shape nothing captured: both packages refuse it at construction."""
    for side, eng in zip((JAX, PORT), sides("dense", **DEBUG)):
        policy = side.TenantPolicy(
            classes=(side.PriorityClass("batch", 0, prefill_chunk_cap=2),))
        with pytest.raises(ValueError, match="bucket set"):
            side.Scheduler(eng, prefill_chunk=8, prefill_buckets=2, policy=policy)

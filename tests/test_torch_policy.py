"""The port's tenant policy, SLO monitor and drain predictor held against the
JAX package's (``tests/test_serve_policy.py`` and ``tests/test_serve_slo.py``
are the checklist).

Host Python on both sides, no engine.  Each scenario below is one call
sequence written once against a package namespace (``JAX`` or ``PORT``): it
drives ``TenantPolicy`` / ``SloMonitor`` / ``DrainPredictor``, checks the
reference test's properties, and returns a transcript of everything the
calls returned — DRR picks, deficits, sheds, brownout levels, snapshots,
exception types and messages, predictions.  The two packages must give
equal transcripts.  The drain predictor prices on ``TPU_V5E`` in both (the
port's default target is the H100).
"""
from __future__ import annotations

import collections
import importlib
import random
import types

import numpy as np
import pytest

import repro.configs.base as jax_configs
import repro.roofline.hw as jax_hw
import repro.serve.policy as jax_policy
import repro.serve.request as jax_request
import repro_torch.configs.base as port_configs
import repro_torch.roofline.hw as port_hw
import repro_torch.serve.policy as port_policy
import repro_torch.serve.request as port_request

# the packages' roofline namespaces export a function named ``autotune``
jax_autotune = importlib.import_module("repro.roofline.autotune")
port_autotune = importlib.import_module("repro_torch.roofline.autotune")


def _ns(policy, request, autotune, hw, configs):
    return types.SimpleNamespace(
        **{n: getattr(policy, n) for n in (
            "DEFAULT_CLASSES", "Overloaded", "PriorityClass", "RateLimited", "SloConfig",
            "SloMonitor", "TenantPolicy", "TenantSpec")},
        Request=request.Request, DrainPredictor=autotune.DrainPredictor,
        KnobConfig=autotune.KnobConfig, TPU_V5E=hw.TPU_V5E, get_config=configs.get_config)


JAX = _ns(jax_policy, jax_request, jax_autotune, jax_hw, jax_configs)
PORT = _ns(port_policy, port_request, port_autotune, port_hw, port_configs)
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _req(m, rid, tenant, priority="standard", cost=100, preempted=False):
    assert cost >= 11
    r = m.Request(rid=rid, prompt=np.zeros(cost - 10, np.int32), max_new_tokens=10,
                  tenant=tenant, priority=priority)
    if preempted:
        r.slot_history.append(0)
    return r


def _admit_next(policy, queue):
    """One scheduler admission: pure select, then commit + dequeue (the
    ``_claim_queue_head`` call sequence)."""
    req = policy.select(queue)
    if req is None:
        return None
    policy.on_admitted(queue, req)
    queue.remove(req)
    return req


def _state(policy):
    return sorted(policy._deficit.items()), sorted(policy._visit.items())


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the transcript compares type and message
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------ weighted DRR


@scenario
def weighted_shares_converge(m):
    weights = {"a": 3.0, "b": 1.0, "c": 2.0}
    policy = m.TenantPolicy(tenants={t: m.TenantSpec(weight=w) for t, w in weights.items()})
    queue = collections.deque()
    rid = 0
    for t in weights:
        for _ in range(2):
            queue.append(_req(m, rid, t))
            rid += 1
    picks = []
    for _ in range(600):
        got = _admit_next(policy, queue)
        picks.append((got.rid, got.tenant))
        queue.append(_req(m, rid, got.tenant))
        rid += 1
    served = collections.Counter(t for _, t in picks)
    for t, w in weights.items():
        assert abs(served[t] / 600 - w / sum(weights.values())) < 0.05
    return picks, _state(policy), policy.snapshot()


@scenario
def weighted_shares_cost_weighted(m):
    policy = m.TenantPolicy(tenants={"small": m.TenantSpec(), "big": m.TenantSpec()})
    costs = {"small": 50, "big": 200}
    queue = collections.deque(_req(m, i, t, cost=costs[t]) for i, t in enumerate(costs))
    rid, tokens, picks = 2, collections.Counter(), []
    for _ in range(500):
        got = _admit_next(policy, queue)
        picks.append(got.rid)
        tokens[got.tenant] += costs[got.tenant]
        queue.append(_req(m, rid, got.tenant, cost=costs[got.tenant]))
        rid += 1
    assert abs(tokens["small"] / sum(tokens.values()) - 0.5) < 0.06
    return picks, _state(policy)


def _no_starvation(m, seed):
    rng = random.Random(seed)
    names = [f"t{i}" for i in range(rng.randint(2, 5))]
    quantum = rng.choice([16, 64, 128])
    weights = {t: rng.choice([0.5, 1.0, 2.0, 4.0]) for t in names}
    policy = m.TenantPolicy(tenants={t: m.TenantSpec(weight=w) for t, w in weights.items()},
                            quantum=quantum)
    max_cost, queue, rid = 300, collections.deque(), 0

    def refill(t):
        nonlocal rid
        queue.append(_req(m, rid, t, cost=rng.randint(11, max_cost)))
        rid += 1

    for t in names:
        for _ in range(rng.randint(1, 3)):
            refill(t)

    def bound(t):
        c_t = -(-max_cost // int(quantum * weights[t]))
        return sum(quantum * weights[u] * c_t + max_cost for u in names if u != t)

    others, picks = dict.fromkeys(names, 0.0), []
    for _ in range(400):
        got = _admit_next(policy, queue)
        picks.append(got.rid)
        for t in names:
            others[t] = 0.0 if t == got.tenant else others[t] + got.prompt_len + \
                got.max_new_tokens
            assert others[t] <= bound(t), (seed, t)
        refill(got.tenant)
    return picks, _state(policy)


for _seed in range(6):
    SCENARIOS[f"no_starvation_seed{_seed}"] = (
        lambda m, s=_seed: _no_starvation(m, s))


# ------------------------------------------------------------- priorities


@scenario
def strict_priority_ordering(m):
    policy = m.TenantPolicy(tenants={"a": m.TenantSpec(weight=0.5),
                                     "b": m.TenantSpec(weight=8.0)})
    queue = collections.deque([
        _req(m, 0, "b", "batch"), _req(m, 1, "a", "interactive"),
        _req(m, 2, "b", "standard"), _req(m, 3, "a", "batch"),
        _req(m, 4, "b", "interactive"), _req(m, 5, "a", "standard")])
    order = [_admit_next(policy, queue) for _ in range(6)]
    levels = {c.name: c.level for c in m.DEFAULT_CLASSES}
    got = [levels[r.priority] for r in order]
    assert got == sorted(got, reverse=True)
    return [r.rid for r in order], _state(policy)


@scenario
def preempted_requests_first(m):
    policy = m.TenantPolicy()
    victim = _req(m, 7, "z", "batch", preempted=True)
    queue = collections.deque([_req(m, 0, "a", "interactive"), victim,
                               _req(m, 1, "b", "interactive")])
    assert policy.select(queue) is victim
    policy.on_admitted(queue, victim)
    queue.remove(victim)
    assert policy.select(queue).rid == 0
    return policy.admitted, _state(policy)


@scenario
def select_is_pure_and_deterministic(m):
    policy = m.TenantPolicy(tenants={"a": m.TenantSpec(weight=2.0), "b": m.TenantSpec()})
    queue = collections.deque(_req(m, i, t) for i, t in enumerate("abab"))
    before = _state(policy)
    first = policy.select(queue)
    assert policy.select(queue) is first and _state(policy) == before
    policy.on_admitted(queue, first)
    queue.remove(first)
    assert _state(policy) != before
    return first.rid, _state(policy)


@scenario
def idle_tenants_bank_no_credit(m):
    policy = m.TenantPolicy(tenants={"a": m.TenantSpec(), "b": m.TenantSpec()}, quantum=64)
    queue = collections.deque([_req(m, 0, "a", cost=64)])
    rid = 1
    for _ in range(50):
        assert _admit_next(policy, queue).tenant == "a"
        queue.append(_req(m, rid, "a", cost=64))
        rid += 1
    assert policy._deficit.get((1, "b"), 0.0) == 0.0
    for _ in range(4):
        queue.append(_req(m, rid, "b", cost=64))
        rid += 1
    served = [_admit_next(policy, queue).tenant for _ in range(4)]
    assert served.count("b") <= 3
    return served, _state(policy)


# ------------------------------------------------------------ rate limits


@scenario
def token_bucket_rate_limit(m):
    policy = m.TenantPolicy(tenants={"a": m.TenantSpec(rate=1.0, burst=2)})
    now = 100.0
    out = [policy.charge_rate("a", t) for t in (now, now, now, now + 0.5, now + 1.6)]
    assert out[0] is None and out[1] is None and 0 < out[2] <= 1.0
    assert out[3] is not None and out[4] is None
    assert policy.rate_rejections["a"] == 2
    out.append(policy.charge_rate("free", now))
    assert out[-1] is None
    return out, policy.snapshot()


@scenario
def exceptions_carry_hints(m):
    rl, ov = m.RateLimited("a", 2.5), m.Overloaded("acme", 2.5, "batch", 3)
    assert isinstance(ov, m.RateLimited) and "retry" in str(rl)
    return ([rl.tenant, rl.retry_after_s, str(rl)],
            [ov.tenant, ov.retry_after_s, ov.priority, ov.level, str(ov)])


@scenario
def class_knob_accessors(m):
    classes = (m.PriorityClass("interactive", level=2, prefill_chunk_cap=0,
                               ttft_deadline_s=0.5),
               m.PriorityClass("batch", level=0, prefill_chunk_cap=16,
                               prefill_token_budget=128))
    policy = m.TenantPolicy(classes=classes,
                            default_spec=m.TenantSpec(default_priority="batch"))
    out = [policy.chunk_cap("interactive"), policy.chunk_cap("batch"),
           policy.token_budget("interactive"), policy.token_budget("batch"),
           policy.ttft_default("interactive"), policy.spec_for("anyone").default_priority]
    assert out == [0, 16, None, 128, 0.5, "batch"]
    return out


@scenario
def validation_errors(m):
    out = [
        _raises(lambda: m.TenantPolicy(classes=(m.PriorityClass("a", 0),
                                                m.PriorityClass("a", 1)))),
        _raises(lambda: m.TenantPolicy(classes=(m.PriorityClass("a", 0,
                                                                prefill_chunk_cap=24),))),
        _raises(lambda: m.TenantPolicy(classes=(m.PriorityClass(
            "a", 0, prefill_token_budget=-1),))),
        _raises(lambda: m.TenantSpec(weight=0.0)),
        _raises(lambda: m.TenantSpec(rate=-1.0)),
        _raises(lambda: m.TenantSpec(burst=0)),
        _raises(lambda: m.TenantPolicy().class_for("platinum")),
        _raises(lambda: m.TenantPolicy(tenants={"a": m.TenantSpec(default_priority="gold")})),
    ]
    assert all(e is not None and e[0] == "ValueError" for e in out), out
    return out


# ---------------------------------------------------------- SLO monitor

SLO_CLASS_ARGS = (("interactive", 2, 1.0), ("standard", 1, None), ("batch", 0, None))


def _slo_classes(m):
    return tuple(m.PriorityClass(n, level=lv, ttft_deadline_s=d)
                 for n, lv, d in SLO_CLASS_ARGS)


def _monitor(m, **kw):
    return m.SloMonitor(m.SloConfig(**{"min_obs": 1, **kw}),
                        {c.name: c for c in _slo_classes(m)})


@scenario
def slo_config_validation(m):
    out = [_raises(lambda kw=kw: m.SloConfig(**kw)) for kw in (
        dict(quantile=1.0), dict(enter=(0.9, 0.8, 1.1)), dict(exit_ratio=1.5),
        dict(dwell=0), dict(shed_frac=(0.5, 1.5)), dict(window=0))]
    classes = {c.name: c for c in _slo_classes(m)}
    out += [_raises(lambda cfg=cfg: m.SloMonitor(cfg, classes)) for cfg in (
        m.SloConfig(target_class="gold"),
        m.SloConfig(target_class="standard", victim_class="batch"),
        m.SloConfig(victim_class="interactive"))]
    assert all(e is not None and e[0] == "ValueError" for e in out), out
    return out


@scenario
def ladder_steps_up_immediately_and_down_with_dwell(m):
    mon = _monitor(m, dwell=3)
    mon.observe_ttft("interactive", 0.2)
    out = [mon.update()]
    for _ in range(8):
        mon.observe_ttft("interactive", 2.0)
    out.append(mon.update())
    for _ in range(64):
        mon.observe_ttft("interactive", 0.1)
    out += [mon.update() for _ in range(9)]
    assert out == [None, 3, None, None, 2, None, None, 1, None, None, 0]
    assert mon.level == 0 and mon.level_changes == 4
    return out, mon.snapshot()


@scenario
def hysteresis_band_holds_level(m):
    mon = _monitor(m, dwell=2)
    out = []
    for burst, value, updates in ((8, 0.65, 1), (64, 0.5, 10), (64, 0.1, 1),
                                  (64, 0.5, 1), (64, 0.1, 2)):
        for _ in range(burst):
            mon.observe_ttft("interactive", value)
        out += [mon.update() for _ in range(updates)]
    assert out == [1] + [None] * 13 + [0]
    return out, mon.snapshot()


@scenario
def waiting_ages_raise_the_quantile(m):
    mon = _monitor(m, min_obs=4)
    mon.observe_ttft("interactive", 0.1)
    out = [mon.update(), mon.update([5.0, 5.0, 5.0]), mon.last_quantile]
    assert out == [None, 3, 5.0]
    return out


@scenario
def window_bounds_memory(m):
    mon = _monitor(m, window=8)
    for i in range(100):
        mon.observe_ttft("interactive", float(i))
        mon.observe_latency("interactive", float(i))
    snap = mon.snapshot()
    assert snap["classes"]["interactive"]["observed"] == 8
    assert snap["classes"]["interactive"]["ttft_p50_s"] >= 92.0
    return snap


@scenario
def shed_targets_only_degrading_classes(m):
    mon = _monitor(m)
    for _ in range(8):
        mon.observe_ttft("interactive", 5.0)
    out = [mon.update()] + [mon.should_shed(c) for c in ("batch", "standard", "interactive")]
    out += [mon.degrades(c) for c in ("batch", "standard", "interactive")]
    assert out == [3, True, False, False, True, False, False] and mon.shed == {"batch": 1}
    return out, mon.shed


@scenario
def shed_is_seeded_and_fractional(m):
    mon = _monitor(m, shed_frac=(0.5, 0.85), seed=7)
    for _ in range(8):
        mon.observe_ttft("interactive", 0.65)
    assert mon.update() == 1
    sheds = [mon.should_shed("batch") for _ in range(400)]
    assert 0.4 < sum(sheds) / 400 < 0.6 and mon.shed["batch"] == sum(sheds)
    return sheds


@scenario
def no_shed_at_level_zero(m):
    mon = _monitor(m)
    assert not mon.should_shed("batch") and mon.shed == {}
    return mon.snapshot()


def _hot_policy(m, level, **kw):
    policy = m.TenantPolicy(classes=_slo_classes(m), slo=m.SloConfig(min_obs=1, **kw))
    if level:
        for _ in range(8):
            policy.observe_ttft("interactive", {1: 0.65, 2: 0.9, 3: 5.0}[level])
        assert policy.update_slo() == level
    return policy


@scenario
def policy_shed_delegation(m):
    policy = _hot_policy(m, 3)
    out = [policy.brownout_level, policy.should_shed("batch"),
           policy.should_shed("standard"), policy.shed_retry_after()]
    assert out[:3] == [3, True, False] and out[3] >= 1.0
    return out, policy.slo_snapshot()


@scenario
def level2_clamps_victim_prefill_knobs(m):
    out = []
    for level, bind in ((2, True), (1, True), (2, False)):
        policy = _hot_policy(m, level)
        if bind:
            policy.bind_chunk_buckets([8, 16, 32])
        out.append([policy.chunk_cap("batch"), policy.token_budget("batch"),
                    policy.chunk_cap("interactive"), policy.token_budget("interactive")])
    assert out == [[8, 8, 0, None], [0, None, 0, None], [0, None, 0, None]]
    return out


@scenario
def open_loop_policy_has_no_slo_surface(m):
    policy = m.TenantPolicy()
    policy.observe_ttft("batch", 1.0)
    policy.observe_latency("batch", 1.0)
    out = [policy.slo, policy.brownout_level, policy.should_shed("batch"),
           policy.update_slo([1.0]), policy.slo_snapshot(), policy.shed_retry_after()]
    assert out == [None, 0, False, None, None, 1.0]
    return out


@scenario
def slo_snapshot_shape(m):
    policy = _hot_policy(m, 1)
    policy.should_shed("batch")
    snap = policy.slo_snapshot()
    assert snap["brownout_level"] == 1 and snap["ttft_deadline_s"] == 1.0
    assert set(snap["classes"]) == {"interactive", "standard", "batch"}
    return snap


# ----------------------------------------------------------- elastic DRR


@scenario
def elastic_drr_redistributes_idle_share(m):
    tenants = {"a": m.TenantSpec(), "b": m.TenantSpec(), "idle": m.TenantSpec(weight=2.0)}
    policy = m.TenantPolicy(tenants=tenants, quantum=64)
    queue = collections.deque(_req(m, i, t, cost=100)
                              for i, t in enumerate(["a"] * 4 + ["b"] * 4))
    rid, served = 8, []
    for _ in range(40):
        got = _admit_next(policy, queue)
        served.append(got.tenant)
        queue.append(_req(m, rid, got.tenant, cost=100))
        rid += 1
    assert abs(served.count("a") - served.count("b")) <= 2
    fresh = m.TenantPolicy(tenants=tenants, quantum=64)
    q2 = collections.deque([_req(m, 100, "a", cost=120)])
    assert fresh.select(q2).rid == 100 and not fresh._deficit
    fresh.on_admitted(q2, q2[0])
    assert fresh._deficit[(1, "a")] == pytest.approx(136.0)
    return served, _state(policy), _state(fresh)


@scenario
def elastic_drr_preserves_relative_shares(m):
    tenants = {"a": m.TenantSpec(weight=3.0), "b": m.TenantSpec(weight=1.0),
               "idle": m.TenantSpec(weight=4.0)}
    policy = m.TenantPolicy(tenants=tenants)
    queue = collections.deque(_req(m, i, t) for i, t in enumerate("aabb"))
    rid, picks = 4, []
    for _ in range(400):
        got = _admit_next(policy, queue)
        picks.append(got.tenant)
        queue.append(_req(m, rid, got.tenant))
        rid += 1
    assert abs(picks.count("a") / 400 - 0.75) < 0.05
    return picks


# ------------------------------------------------------- drain predictor


def _predictor(m):
    return m.DrainPredictor(m.get_config("tinyllama-1.1b"), m.KnobConfig(segment_len=8),
                            n_slots=4, max_len=192, hw=m.TPU_V5E)


@scenario
def drain_predictor_calibration(m):
    pred = _predictor(m)
    out = [pred.calibrated, pred.drain_s([16], [32])]
    pred.observe(16, 32, measured_s=2.0)
    out += [pred.calibrated, pred.n_obs, pred.scale, pred.drain_s([16, 16], [32, 32])]
    s0 = pred.scale
    pred.observe(16, 32, measured_s=4.0)
    assert pred.scale > s0
    out += [pred.scale, pred.drain_s([], [])]
    s1 = pred.scale
    pred.observe(16, 0, measured_s=1.0)
    pred.observe(16, 32, measured_s=0.0)
    assert pred.scale == s1 and pred.n_obs == 2
    out.append(pred.drain_s([3, 40, 1, 1], [30, 7, 12, 50]))
    assert out[:2] == [False, None] and out[5] > 0
    return out


@scenario
def drain_predictor_memoizes_shape_buckets(m):
    pred = _predictor(m)
    pred.observe(15, 30, 1.0)
    pred.observe(16, 31, 1.0)
    n1 = len(pred._single)
    pred.observe(33, 30, 1.0)
    assert (n1, len(pred._single)) == (1, 2)
    return sorted(pred._single.items()), pred.scale


def _fuzz(m, seed):
    """Random interleavings of every policy call a scheduler makes
    (submit-side shed / rate / note, select + commit, observations, SLO
    steps, knob reads) over a policy with an SLO controller."""
    rng = random.Random(seed)
    classes = (m.PriorityClass("interactive", 2, ttft_deadline_s=0.5),
               m.PriorityClass("standard", 1, prefill_chunk_cap=8),
               m.PriorityClass("batch", 0, prefill_chunk_cap=16, prefill_token_budget=24))
    policy = m.TenantPolicy(
        tenants={"acme": m.TenantSpec(weight=3.0), "hobby": m.TenantSpec(rate=4.0, burst=2),
                 "bulk": m.TenantSpec(default_priority="batch")},
        classes=classes, quantum=rng.choice([16, 32, 64]),
        slo=m.SloConfig(min_obs=2, window=16, dwell=2, seed=seed))
    policy.bind_chunk_buckets([4, 8, 16])
    queue, rid, now, out = collections.deque(), 0, 0.0, []
    names = ["interactive", "standard", "batch"]
    for _ in range(300):
        now += rng.random() * 0.2
        op = rng.random()
        if op < 0.4:
            tenant = rng.choice(["acme", "hobby", "bulk", "walkin"])
            prio = rng.choice([None] + names)
            prio = prio or policy.spec_for(tenant).default_priority
            if policy.should_shed(prio):
                out.append(("shed", tenant, prio, policy.brownout_level))
                continue
            retry = policy.charge_rate(tenant, now)
            if retry is not None:
                out.append(("rate", tenant, retry))
                continue
            policy.note_submitted(tenant)
            queue.append(_req(m, rid, tenant, prio, cost=rng.randint(11, 200),
                              preempted=rng.random() < 0.05))
            rid += 1
        elif op < 0.7:
            got = _admit_next(policy, queue)
            out.append(("admit", got and got.rid))
            if got is not None:
                policy.note_tokens(got.tenant, rng.randint(1, 9))
        elif op < 0.9:
            cls = rng.choice(names)
            # mostly healthy TTFTs with bursts over the deadline, so the
            # ladder climbs and comes back down
            burst = (rng.random() < 0.3) == (len(out) // 60 % 2 == 0)
            policy.observe_ttft(cls, rng.random() * (1.0 if burst else 0.2))
            policy.observe_latency(cls, rng.random() * 3.0)
        else:
            waiting = [rng.random() for _ in range(rng.randint(0, 3))]
            out.append(("slo", policy.update_slo(waiting),
                        [policy.chunk_cap(c) for c in names],
                        [policy.token_budget(c) for c in names]))
    out.append((policy.snapshot(), policy.slo_snapshot(), _state(policy)))
    return out


for _seed in range(4):
    SCENARIOS[f"fuzz_seed{_seed}"] = (lambda m, s=_seed: _fuzz(m, s))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_matches_jax(name):
    """The same call sequence through both packages: equal transcripts."""
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want


def test_port_policy_is_its_own():
    """The port raises its own exception classes (the front door catches
    those), and they behave as the reference's."""
    assert port_policy.RateLimited is not jax_policy.RateLimited
    assert issubclass(port_policy.Overloaded, port_policy.RateLimited)
    assert port_policy.TenantPolicy.__module__ == "repro_torch.serve.policy"

"""Overcommit-safe serving on the port held against the JAX package's
(``tests/test_serve_robust.py``, the non-policy cases of
``tests/test_serve_deadlines.py`` and the non-speculative cases of
``tests/test_serve_stress.py`` are the checklist): preemption by recompute
and by swap, chaos, cancellation and deadlines, the invariants after every
segment, and seeded random workloads.  Port against port, bit for bit: a
preempted run ≡ the never-preempted run ≡ ``generate``.  Setup and parity
as ``tests/torch_scheduler_pair.py`` says."""
import numpy as np
import pytest
import torch

from repro.serve import ChaosConfig as JaxChaosConfig
from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.serve.chaos import ChaosConfig
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import (BLOCK_LEN, MAX_LEN, check_parity, drain, generate,
                                  parity, prompts_of, sides_fixture)

POISON = 1.0e9  # large finite garbage: NaN would leak through the masked softmax
DEBUG = dict(debug_invariants=True)
BF16 = dict(compute="bfloat16")  # the port's own bitwise contracts (see make_sides)


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


def _oracle(sides, prompts, news, quant=False, compute="float32"):
    eng = sides("dense", quant, compute)[1]
    return [generate(eng, p, n) for p, n in zip(prompts, news)]


def _chaos_pair(**kw):
    return {"chaos": (JaxChaosConfig(**kw), ChaosConfig(**kw))}


def _poison_free_blocks(sched):
    """Overwrite every free block of the port's pool with large garbage: a
    slot still reading a released block would leave the oracle's tokens."""
    if not isinstance(sched, ContinuousScheduler) or not sched.allocator.free:
        return
    ids = torch.tensor(list(sched.allocator.free))
    for leaf in sched.cache.values():
        leaf.index_fill_(1, ids, POISON)


# ------------------------------------------------------- overcommit stress


@pytest.mark.parametrize("preempt_mode", ["recompute", "swap"])
def test_overcommit_pool_preempts_and_stays_bit_identical(sides, preempt_mode):
    """Summed block demand ≥ 1.5× the pool under overcommit 2: the JAX
    scheduler's tokens and counters, ≥ 1 preemption, and the tokens of the
    uncontended run and of ``generate``."""
    lens = [6, 8, 5, 8, 6, 7]
    news = [30, 24, 28, 22, 30, 26]
    prompts = prompts_of(lens, 300)
    demand = sum(-(-(len(p) + n) // BLOCK_LEN) for p, n in zip(prompts, news))
    pool = 9
    assert demand >= 1.5 * pool
    _, teng = sides("paged", **DEBUG)
    base = ContinuousScheduler(teng, n_slots=3, segment_len=4, n_blocks=demand)
    hb = [base.submit(p, n) for p, n in zip(prompts, news)]
    drain(base)
    assert base.stats["preemptions"] == 0
    handles, sched = parity(sides, prompts, news, layout="paged", engine_kw=DEBUG,
                            n_slots=3, segment_len=4, n_blocks=pool, overcommit=2.0,
                            preempt_mode=preempt_mode)
    st = sched.stats
    assert st["preemptions"] >= 1 and st["readmits"] >= 1 and st["blocks_grown"] > 0
    if preempt_mode == "swap":
        assert st["swap_outs"] >= 1 and st["swap_ins"] >= 1
    else:
        assert st["replayed_tokens"] >= 1
    want = _oracle(sides, prompts, news)
    for h, b, w in zip(handles, hb, want):
        assert h.done and h.tokens == b.tokens == w, h.rid
    assert sched.allocator.n_free == sched.allocator.capacity


def test_dense_chaos_preemption_bit_identical(sides):
    prompts, news = prompts_of([5, 8, 6, 7, 5, 8], 400), [14, 9, 16, 12, 16, 9]
    handles, sched = parity(sides, prompts, news, engine_kw=DEBUG, n_slots=2, segment_len=4,
                            **_chaos_pair(seed=5, slot_fail_prob=0.4))
    assert sched.stats["preemptions"] >= 1
    for h, w in zip(handles, _oracle(sides, prompts, news)):
        assert h.done and h.tokens == w, h.rid


def test_overcommit_one_never_preempts(sides):
    handles, sched = parity(sides, prompts_of([8] * 6, 500), [16] * 6, layout="paged",
                            engine_kw=DEBUG, n_slots=3, segment_len=4, n_blocks=6)
    assert sched.stats["preemptions"] == 0 and sched.stats["admit_deferred"] > 0
    assert all(h.done for h in handles)


# --------------------------------------------------------- fault injection


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunked", [False, True])
def test_chaos_schedule_never_corrupts_survivors(sides, seed, chunked):
    """Seeded chaos (exhaustion, cancels, slot failures) over an
    overcommitted pool, the port's free blocks poisoned after every
    segment: the JAX scheduler's tokens and counters; survivors get the
    tokens of the same scheduler run without faults on an uncontended
    pool, cancelled ones a prefix of them; terminal requests hold no slot
    after the segment that retired them."""
    rng = np.random.RandomState(seed)
    lens = [int(rng.randint(3, 14)) for _ in range(8)]
    news = [int(rng.randint(2, 24)) for _ in range(8)]
    prompts = prompts_of(lens, 600 + 10 * seed)
    kw = dict(prefill_chunk=8, prefill_buckets=2) if chunked else {}

    def each(sched):
        assert all(r is None or not r.terminal for r in sched.slots)
        _poison_free_blocks(sched)

    handles, sched = parity(
        sides, prompts, news, layout="paged", engine_kw=DEBUG, each=each, n_slots=3,
        segment_len=4, n_blocks=10, overcommit=2.0,
        **_chaos_pair(seed=seed, exhaust_prob=0.15, cancel_prob=0.15, slot_fail_prob=0.15),
        **kw)
    calm = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=3, segment_len=4,
                               n_blocks=40, **kw)
    want = [calm.submit(p, n) for p, n in zip(prompts, news)]
    drain(calm)
    assert calm.stats["preemptions"] == 0
    if not chunked:
        assert [h.tokens for h in want] == _oracle(sides, prompts, news)
    n_done = 0
    for h, w in zip(handles, (h.tokens for h in want)):
        assert h.terminal
        if h.done:
            n_done += 1
            assert h.tokens == w, h.rid
        else:
            assert h.state in ("cancelled", "expired") and h.tokens == w[:len(h.tokens)]
    assert sched.allocator.n_free == sched.allocator.capacity
    assert sched.stats["cancelled"] == sched.stats["chaos_cancels"]
    assert n_done == len(prompts) - sched.stats["cancelled"]


def test_forced_exhaustion_at_segment_forces_preemption(sides):
    prompts, news = prompts_of([7] * 4, 700), [22] * 4
    handles, sched = parity(sides, prompts, news, layout="paged", engine_kw=DEBUG,
                            n_slots=2, segment_len=4, n_blocks=16,
                            **_chaos_pair(seed=0, exhaust_at=(1, 2, 3)))
    assert sched.stats["chaos_exhausts"] == 3 and sched.stats["preemptions"] >= 1
    for h, w in zip(handles, _oracle(sides, prompts, news)):
        assert h.done and h.tokens == w, h.rid


# -------------------------------------------------- cancellation / deadlines


def test_cancel_queued_request_never_runs(sides):
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=1, segment_len=4,
                                n_blocks=4)
    h1 = sched.submit(prompts_of([8], 800)[0], 10)
    h2 = sched.submit(prompts_of([8], 801)[0], 10)
    h2.cancel()
    drain(sched)
    assert h1.done and len(h1.tokens) == 10
    assert h2.cancelled and h2.tokens == [] and not h2.slot_history
    assert sched.stats["cancelled"] == 1


def test_cancel_running_request_frees_blocks_within_one_segment(sides):
    want = _oracle(sides, prompts_of([8], 810), [24])[0]
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=2, segment_len=4,
                                n_blocks=12)
    mapped_at_cancel = {}

    def cancel_at_5(req, tok):
        if len(req.tokens) == 5:
            req.cancel()
            mapped_at_cancel["n"] = len(sched.allocator.mapped[req.slot_history[-1]])

    hv = sched.submit(prompts_of([8], 811)[0], 24, on_token=cancel_at_5)
    hs = sched.submit(prompts_of([8], 810)[0], 24)
    seen_free = False
    while sched.has_work():
        sched.run_segment()
        if hv.terminal:
            assert sched.slots[hv.slot_history[-1]] is not hv
            seen_free = True
    assert seen_free and hv.cancelled and len(hv.tokens) >= 5
    assert sched.stats["blocks_reclaimed_cancel"] >= mapped_at_cancel["n"] > 0
    assert hs.done and hs.tokens == want
    assert sched.allocator.n_free == sched.allocator.capacity


def test_cancel_after_finish_is_noop(sides):
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=1, n_blocks=4)
    h = sched.submit(prompts_of([8], 820)[0], 4)
    drain(sched)
    h.cancel()
    assert h.done and not h.cancel_requested


def test_deadlines_expire_with_fake_clock(sides):
    """A TTFT deadline passing in the queue and a total deadline passing
    mid-flight, on both schedulers driven by one fake clock: the same
    tokens, states and counters."""
    jeng, teng = sides("paged", **DEBUG)
    prompts = prompts_of([8, 8, 8], 830)
    out = []
    for cls, eng in ((JaxScheduler, jeng), (ContinuousScheduler, teng)):
        t = {"now": 0.0}
        sched = cls(eng, n_slots=1, segment_len=4, n_blocks=5, clock=lambda: t["now"])
        h1 = sched.submit(prompts[0], 8, deadline_s=100.0)
        h2 = sched.submit(prompts[1], 8, ttft_deadline_s=0.5)
        h3 = sched.submit(prompts[2], 30, deadline_s=5.0)
        t["now"] = 1.0
        sched.run_segment()
        assert h2.expired and h2.tokens == []
        while sched.has_work() and not (h1.done and len(h3.tokens) >= 1):
            sched.run_segment()
        t["now"] = 7.0
        drain(sched)
        assert h3.expired and 0 < len(h3.tokens) < 30
        assert sched.stats["expired"] == 2
        assert sched.allocator.n_free == sched.allocator.capacity
        out.append(([h1, h2, h3], sched))
    check_parity(*out)
    assert out[1][0][0].tokens == _oracle(sides, prompts[:1], [8])[0]


def test_ttft_expiry_mid_prefill_chunk(sides):
    """A long prompt walking 8-token chunks under a budget of 8 blows its
    TTFT deadline between chunks: expired with no token, its blocks back at
    once, the short survivor exact."""
    t = {"now": 0.0}
    sched = ContinuousScheduler(sides("paged", **DEBUG, **BF16)[1], n_slots=2,
                                segment_len=4, n_blocks=16, prefill_chunk=8,
                                prefill_buckets=2, prefill_token_budget=8,
                                clock=lambda: t["now"])
    want = _oracle(sides, prompts_of([6], 20), [10], compute="bfloat16")[0]
    hv = sched.submit(prompts_of([40], 21)[0], 8, ttft_deadline_s=1.0)
    hs = sched.submit(prompts_of([6], 20)[0], 10)
    sched.run_segment()
    slot = sched.slots.index(hv)
    assert slot in sched._prefill_start and hv.first_token_t is None
    held = len(sched.allocator.mapped.get(slot, ()))
    t["now"] = 2.0
    sched.run_segment()
    assert hv.expired and hv.tokens == []
    assert slot not in sched._prefill_start and held > 0
    assert slot not in sched.allocator.mapped or sched.slots[slot] is not hv
    drain(sched, check=True)
    assert hs.done and hs.tokens == want
    assert sched.stats["expired"] == 1
    assert sched.allocator.n_free == sched.allocator.capacity


def test_deadline_expiry_mid_replay(sides):
    """Preempt a request, let its recompute readmission start replaying,
    then pass its total deadline while the replay is pending: expired with
    an oracle prefix, the replay state dropped with the slot."""
    t = {"now": 0.0}
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=2, segment_len=4,
                                n_blocks=16, clock=lambda: t["now"])
    prompts, news = prompts_of([8], 30) + prompts_of([6], 31), [24, 12]
    want = _oracle(sides, prompts, news)
    hv = sched.submit(prompts[0], news[0], deadline_s=50.0)
    hs = sched.submit(prompts[1], news[1])
    while len(hv.tokens) < 6:
        sched.run_segment()
    sched._preempt_slot(sched.slots.index(hv))
    assert sched.queue[0] is hv and hv.preempts == 1
    emitted = len(hv.tokens)
    for _ in range(200):
        sched.run_segment()
        if hv in sched.slots and sched._replay.get(sched.slots.index(hv)):
            break
    else:
        pytest.fail("the readmission never reached a mid-replay boundary")
    t["now"] = 60.0
    sched.run_segment()
    assert hv.expired and hv not in sched.slots and not sched._replay
    assert len(hv.tokens) >= emitted and hv.tokens == want[0][:len(hv.tokens)]
    drain(sched, check=True)
    assert hs.done and hs.tokens == want[1]
    assert sched.allocator.n_free == sched.allocator.capacity


def test_cancel_races_victim_selection_same_segment(sides):
    """A resident cancelled in the segment a forced exhaustion picks
    victims: the sweep reclaims it first, nothing is freed twice, the
    survivors stay exact."""
    prompts, news = prompts_of([7] * 3, 40), [20] * 3
    want = _oracle(sides, prompts, news)
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=2, segment_len=4,
                                n_blocks=8, overcommit=2.0,
                                chaos=ChaosConfig(seed=0, exhaust_at=(3, 4, 5)))
    handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
    while sched.stats["segments"] < 3:
        sched.run_segment()
    residents = [s for s in range(2) if sched.slots[s] is not None]
    assert len(residents) == 2
    victim = min(residents, key=sched._progress_key)
    cancelled = sched.slots[victim]
    cancelled.cancel()
    held = len(sched.allocator.mapped[victim])
    sched.run_segment()
    assert sched.stats["chaos_exhausts"] >= 1 and cancelled.cancelled
    assert sched.stats["blocks_reclaimed_cancel"] >= held > 0
    drain(sched, check=True)
    for h, w in zip(handles, want):
        if h is cancelled:
            assert h.tokens == w[:len(h.tokens)]
        else:
            assert h.done and h.tokens == w, h.rid
    assert sched.allocator.n_free == sched.allocator.capacity


# --------------------------------------------------------- validation


def test_deadline_and_submit_validation_as_jax(sides):
    jeng, teng = sides("paged", **DEBUG)
    cases = [((prompts_of([4], 840)[0], 4), dict(ttft_deadline_s=0.0), "ttft_deadline_s"),
             ((prompts_of([4], 840)[0], 4), dict(deadline_s=-1.0), "deadline_s"),
             ((np.zeros(0, np.int32), 4), {}, "empty prompt"),
             ((prompts_of([4], 900)[0], 0), {}, "max_new_tokens"),
             ((prompts_of([MAX_LEN], 901)[0], 1), {}, "max_len"),
             ((prompts_of([32], 902)[0], 40), {}, "exceeds max_len")]
    for args, kw, match in cases:
        msgs = []
        for cls, eng in ((JaxScheduler, jeng), (ContinuousScheduler, teng)):
            sched = cls(eng, n_slots=1, n_blocks=8)
            with pytest.raises(ValueError, match=match) as err:
                sched.submit(*args, **kw)
            assert not sched.queue
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], match


def test_debug_invariants_catches_corruption_at_the_segment(sides):
    sched = ContinuousScheduler(sides("paged", **DEBUG)[1], n_slots=2, segment_len=4,
                                n_blocks=8)
    assert sched.engine.sc.debug_invariants
    sched.submit(prompts_of([8], 910)[0], 16)
    sched.run_segment()
    sched.allocator.mapped[1] = [sched.allocator.mapped[0][0]]  # double-map a block
    sched._committed[1] = 1
    with pytest.raises(AssertionError, match="mapped to two slots|live slots"):
        sched.run_segment()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_run_cap_leaves_resumable_state(sides, layout):
    prompts, news = prompts_of([8] * 5, 920), [18] * 5
    want = _oracle(sides, prompts, news)
    kw = {"n_blocks": 8} if layout == "paged" else {}
    sched = ContinuousScheduler(sides(layout, **DEBUG)[1], n_slots=2, segment_len=4, **kw)
    handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
    with pytest.raises(RuntimeError, match="did not drain"):
        sched.run(max_segments=2)
    sched.check_block_invariants()
    assert sched.has_work()
    in_flight = sum(r is not None for r in sched.slots) + len(sched.queue)
    assert in_flight + sum(h.done for h in handles) == len(handles)
    sched.run()
    for h, w in zip(handles, want):
        assert h.done and h.tokens == w, (layout, h.rid)


# ----------------------------------------------- seeded random workloads


def _random_run(eng, layout, prompts, news, rng, chunked):
    """The stress suite's run: random geometry and segment mode, the
    requests submitted in random bursts between segments."""
    n_slots = int(rng.randint(2, 4))
    kw = dict(n_slots=n_slots, segment_len=int(rng.randint(2, 8)),
              segment_mode=("scan", "while")[int(rng.randint(2))])
    if layout == "paged":
        need = max(-(-(len(p) + n) // BLOCK_LEN) for p, n in zip(prompts, news))
        kw["n_blocks"] = int(rng.randint(need, n_slots * (MAX_LEN // BLOCK_LEN) + 1))
    if chunked:
        kw.update(prefill_chunk=8, prefill_buckets=2)
    sched = ContinuousScheduler(eng, **kw)
    handles, order, i = [None] * len(prompts), rng.permutation(len(prompts)), 0
    while i < len(order) or sched.has_work():
        for _ in range(int(rng.randint(1, 4))):
            if i < len(order):
                j = int(order[i])
                handles[j] = sched.submit(prompts[j], news[j])
                i += 1
        if sched.has_work():
            sched.run_segment()
            sched.check_block_invariants()
    return handles, sched


def _random_workload(rng, n):
    lens = rng.choice((3, 5, 8, 13), n)
    news = [int(x) for x in rng.choice((1, 2, 5, 9, 16), n)]
    return [rng.randint(0, 256, (m,)).astype(np.int32) for m in lens], news


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_workload_matches_sequential_oracle(sides, seed):
    rng = np.random.RandomState(seed)
    prompts, news = _random_workload(rng, int(rng.randint(6, 12)))
    want = _oracle(sides, prompts, news, compute="bfloat16")
    for layout in ("dense", "paged"):
        for chunked in (False, True):
            handles, sched = _random_run(sides(layout, **BF16)[1], layout, prompts, news,
                                         np.random.RandomState(seed + 100), chunked)
            for h, w, n in zip(handles, want, news):
                assert h.done and len(h.tokens) == n and h.tokens == w, (layout, chunked)
            assert sched.stats["admitted"] == sched.stats["retired"] == len(prompts)
            if layout == "paged":
                assert sched.allocator.n_free == sched.allocator.capacity


@pytest.mark.parametrize("seed", [0, 1])
def test_random_workload_quantized_cache_matches_quant_oracle(sides, seed):
    """Under the int8 KV cache, dense and paged with chunked admission give
    the int8-KV ``generate``'s tokens bit for bit."""
    rng = np.random.RandomState(seed)
    prompts, news = _random_workload(rng, int(rng.randint(5, 9)))
    want = _oracle(sides, prompts, news, quant=True)
    for layout in ("dense", "paged"):
        handles, sched = _random_run(sides(layout, True)[1], layout, prompts, news,
                                     np.random.RandomState(seed + 100), True)
        assert sched.chunked and sched.stats["chunks_prefilled"] >= len(prompts)
        for h, w in zip(handles, want):
            assert h.done and h.tokens == w, layout

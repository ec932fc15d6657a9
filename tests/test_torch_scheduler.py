"""The port's ``ContinuousScheduler`` (dense slot cache, per-request
admission) held against the JAX package's (``tests/test_serve_scheduler.py``
is the checklist), and its own contracts.

Setup and parity as ``tests/torch_scheduler_pair.py`` says: for the same
workload, scheduler arguments and a fake clock, the two schedulers give
equal per-request greedy tokens, equal ``finish_reason``s and equal host
counters.  Port against port, bit for bit: uniform ≡
``generate``, ragged ≡ ``generate`` per request, and a while segment's
token block and state ≡ the scan segment's up to its stop.  On the CPU
every slot program runs eagerly; the graphs are held to eager on the card
(``tests/test_torch_scheduler_graphs.py``).
"""
import numpy as np
import pytest
import torch

from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.serve.engine import SLOT_PROGRAMS
from repro_torch.serve.request import SubmitRequest
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import generate as _generate
from torch_scheduler_pair import sides_fixture, parity
from torch_scheduler_pair import prompts_of as _prompts_of

LENS = [4, 7, 11, 5, 9, 3]
NEWS = [6, 12, 3, 1, 9, 14]


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


def _prompts(lens=LENS, seed=0):
    return _prompts_of(lens, seed)


@pytest.mark.parametrize("mode", ["scan", "while"])
def test_ragged_workload_matches_jax_scheduler(sides, mode):
    before = dict(sides()[1].call_counts)
    handles, sched = parity(sides, _prompts(), NEWS, n_slots=2, segment_len=5,
                             segment_mode=mode)
    assert all(h.done for h in handles)
    runs = {k: v - before[k] for k, v in sched.engine.call_counts.items()}
    seg = "slot_segment" + ("_while" if mode == "while" else "")
    assert runs["prefill_slot"] == len(LENS)
    assert runs[seg] == sched.stats["segments"] > 0


def test_eos_retires_request_as_jax(sides):
    _, eng = sides()
    eos = _generate(eng, _prompts([8], 40)[0], 12)[4]  # emitted mid-stream
    prompts = _prompts([8, 8], 40)[:1] + _prompts([8], 41)
    handles, _ = parity(sides, prompts, [12, 3], engine_kw=dict(eos_token=eos),
                         n_slots=1, segment_len=4)
    h, h2 = handles
    assert eos in h.tokens and h.tokens[-1] == eos and len(h.tokens) < 12
    assert h.finish_reason == "stop" and h2.done and len(h2.tokens) == 3


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_kv_matches_jax_scheduler(sides, layout):
    kw = dict(n_blocks=14) if layout == "paged" else {}
    handles, _ = parity(sides, _prompts(), NEWS, layout=layout, quant=True, n_slots=3,
                         segment_len=4, **kw)
    _, eng = sides(layout, True)
    oracle = sides("dense", True)[1]
    for p, n, h in zip(_prompts(), NEWS, handles):
        assert h.tokens == _generate(oracle, p, n)
    assert eng.cache_quant_int8


@pytest.mark.parametrize("mode", ["scan", "while"])
def test_uniform_workload_bit_identical_to_generate(sides, mode):
    """Six requests through three slots (two waves): each request's
    tokens are its row of one ``generate`` over the batch of six."""
    _, eng = sides()
    prompts = _prompts([8] * 6, 3)
    want = eng.generate(torch.from_numpy(np.stack(prompts)).long(), 10).tolist()
    sched = ContinuousScheduler(eng, n_slots=3, segment_len=4, segment_mode=mode)
    handles = [sched.submit(p, 10) for p in prompts]
    sched.run()
    assert [h.tokens for h in handles] == want
    assert all(h.done for h in handles)


def test_ragged_prompt_lengths_match_generate_per_request(sides):
    _, eng = sides()
    lens, news = [4, 7, 11, 5, 9], [6, 12, 3, 1, 9]
    prompts = _prompts(lens, 10)
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=5)
    handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
    sched.run()
    for p, n, h in zip(prompts, news, handles):
        assert h.tokens == _generate(eng, p, n), h.rid


def test_slot_reuse_after_retirement(sides):
    _, eng = sides()
    news = [3, 8, 2, 5, 1, 6, 4]
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=4)
    handles = [sched.submit(p, n) for p, n in zip(_prompts([6] * 7, 20), news)]
    sched.run()
    assert all(h.done for h in handles)
    assert [len(h.tokens) for h in handles] == news
    st = sched.stats
    assert st["admitted"] == st["retired"] == 7
    assert sum(st["admissions_per_slot"]) == 7 and max(st["admissions_per_slot"]) >= 2
    assert all(r is None for r in sched.slots)
    assert all(len(h.slot_history) == 1 for h in handles)


def test_max_new_one_finishes_at_admission(sides):
    _, eng = sides()
    p = _prompts([5], 30)[0]
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=4)
    h = sched.submit(p, 1)
    sched.run()
    assert h.done and h.tokens == _generate(eng, p, 1)
    assert sched.stats["segments"] == 0


def test_streaming_callback_order(sides):
    _, eng = sides()
    seen = []
    t = iter(range(1000))
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=3, clock=lambda: float(next(t)))
    h = sched.submit(SubmitRequest(_prompts([6], 50)[0], 7,
                                   on_token=lambda r, tok: seen.append(tok)))
    sched.run()
    assert seen == h.tokens and len(seen) == 7
    assert h.ttft is not None and h.latency is not None
    assert 0 < h.ttft <= h.latency


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_while_segment_equals_scan_up_to_its_stop(sides, layout):
    """Engine level: a while segment of 8 steps that stops early (a slot
    finishes at step 2 with ``stop_on_free``) gives the scan segment's
    token block and tok / pos / done up to its stop, −1 after it; its
    predicated steps' k/v rewrites equal what the next real step writes,
    so its cache is the scan segment's after one more real step."""
    kw = dict(n_blocks=16) if layout == "paged" else {}
    out = {}
    for mode in ("while", "scan"):
        # two engines (the same weights): each keeps its own slot state
        _, eng = sides(layout, debug_invariants=mode == "scan")
        sched = ContinuousScheduler(eng, n_slots=3, segment_len=8, **kw)
        for p, n in zip(_prompts([5, 9, 6], 60), [3, 20, 20]):
            sched.submit(p, n)
        sched._admit()
        sched._ensure_segment_capacity()
        bt = sched.block_table if layout == "paged" else None
        if mode == "while":
            toks = eng.slot_segment(sched.state, 8, "while", sched.active, sched.limit,
                                    True, bt)
            steps = int((toks >= 0).any(0).sum())
            assert steps == 2 and (toks[:, steps:] == -1).all()
            extra = None
        else:
            toks = eng.slot_segment(sched.state, steps, "scan", sched.active, sched.limit,
                                    False, bt)
            extra = {k: v.clone() for k, v in (("tok", sched.tok), ("pos", sched.pos),
                                               ("done", sched.done))}
            eng.slot_segment(sched.state, 1, "scan", sched.active, sched.limit, False, bt)
        out[mode] = (toks, extra, sched)
    (w_toks, _, w), (s_toks, s_state, s) = out["while"], out["scan"]
    assert torch.equal(w_toks[:, :steps], s_toks)
    for k in ("tok", "pos", "done"):
        assert torch.equal(getattr(w, k), s_state[k]), k
    for k in w.cache:
        assert torch.equal(w.cache[k], s.cache[k]), k
    assert bool(w.done[0]) and not bool(w.done[1:].any())


def test_counts_and_no_captures_on_cpu(sides):
    _, eng = sides()
    before = dict(eng.call_counts)
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=3)
    for p, n in zip(_prompts([4, 7, 4]), [5, 6, 7]):
        sched.submit(p, n)
    sched.run()
    runs = {k: eng.call_counts[k] - before[k] for k in SLOT_PROGRAMS}
    assert runs["prefill_slot"] == 3 and runs["slot_segment"] == sched.stats["segments"]
    assert sum(runs.values()) == 3 + sched.stats["segments"]
    assert not any(eng.trace_counts[k] for k in SLOT_PROGRAMS)  # eager on the CPU
    assert eng.slot_eager_runs == 0  # counts eager runs on the card only


def test_sampled_streams_repeat_from_the_seed(sides):
    """Temperature sampling draws from the scheduler's generator: the same
    seed repeats a run, another seed does not."""
    _, eng = sides(temperature=1.0, top_k=40)

    def run(seed):
        sched = ContinuousScheduler(eng, n_slots=2, segment_len=4, seed=seed)
        handles = [sched.submit(p, n) for p, n in zip(_prompts(), NEWS)]
        sched.run()
        return [h.tokens for h in handles]

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c


def test_slot_state_taken_over_by_a_later_scheduler(sides):
    _, eng = sides()
    first = ContinuousScheduler(eng, n_slots=2, segment_len=4)
    second = ContinuousScheduler(eng, n_slots=2, segment_len=4)
    assert first.state is second.state
    first.submit(_prompts([5])[0], 3)
    with pytest.raises(RuntimeError, match="taken over"):
        first.run_segment()


@pytest.mark.parametrize("bad", [
    dict(prompt_len=60, new=10), dict(prompt_len=4, new=0), dict(prompt_len=0, new=4),
    dict(prompt_len=64, new=1)])
def test_submit_validation_raises_as_jax(sides, bad):
    jeng, teng = sides()
    prompt = np.arange(bad["prompt_len"], dtype=np.int32) % 200
    msgs = []
    for sched in (JaxScheduler(jeng, n_slots=1), ContinuousScheduler(teng, n_slots=1)):
        with pytest.raises(ValueError) as err:
            sched.submit(prompt, bad["new"])
        assert not sched.queue
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_policy_is_not_ported_yet(sides):
    _, eng = sides()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousScheduler(eng, policy=object())

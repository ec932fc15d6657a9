"""Speculative decoding on the port held against the JAX package's
(``tests/test_serve_spec.py`` is the checklist, with its drafter and
refusal cases in ``tests/test_torch_spec_drafters.py``): greedy
draft-and-verify through the continuous scheduler, dense and paged, k ∈
{1, 2, 4}, scan and while, chunked admission, the int8 KV cache (an eos
inside the window is in ``tests/test_torch_spec_robust.py``).

Setup and parity as ``tests/torch_scheduler_pair.py`` says (reduced
tinyllama, fp32 compute, int8 weights at (16, 16), the port on its plain
versions): for the same workload both schedulers give equal per-request
tokens, states, finish reasons and host counters, and with ``truncate:N``
drafters equal ``spec_steps``, ``spec_emitted`` and ``accepted_hist`` (the
drafter is the verifier's own first layers, so its proposals are the
reference's).  Port against port, bit for bit: every speculative run
gives the tokens of ``generate`` at B = 1, rollback never reads the
cache past a cursor (positions there poisoned between segments), and a
while segment's rounds after its stop (predicated) hold the state and
write only what the next real round writes (held against the scan
segment).
"""
import numpy as np
import pytest
import torch

from repro_torch.serve.engine import SLOT_PROGRAMS, SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import (MAX_LEN, drain, generate, prompts_of, sides_fixture,
                                  spec_parity)

LENS = [3, 5, 8, 13, 5, 8]
NEWS = [9, 2, 5, 16, 1, 7]  # max_new 1 (admission only) and 2
POISON = 1.0e4  # large finite garbage: NaN would leak through the masked softmax
SCHED = dict(n_slots=3, segment_len=4)  # spec_parity's


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


@pytest.fixture(scope="module")
def baseline(sides):
    """The port's ``generate`` at B = 1 per request, which the plain
    scheduler equals (``tests/test_torch_scheduler.py``)."""
    eng = sides()[1]
    return [generate(eng, p, n) for p, n in zip(prompts_of(LENS), NEWS)]


def _spec_parity(sides, spec, layout="dense", prompts=None, news=NEWS, **kw):
    return spec_parity(sides, spec, prompts or prompts_of(LENS), news, layout, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_matches_jax_and_generate(sides, baseline, layout, k):
    """A deliberately weak 1-layer drafter, so rejection and rollback run
    constantly: JAX's tokens and counters, and ``generate``'s tokens."""
    got, sched = _spec_parity(sides, SpecConfig(k=k, draft="truncate:1"), layout)
    assert got == baseline, (layout, k)
    st = sched.stats
    assert st["spec_steps"] > 0
    assert st["spec_emitted"] == sum(c * n for n, c in st["accepted_hist"].items())
    assert all(1 <= n <= k + 1 for n in st["accepted_hist"])


def test_spec_scan_segments_match_jax(sides, baseline):
    got, sched = _spec_parity(sides, SpecConfig(k=2, draft="truncate:1"),
                              segment_mode="scan")
    assert got == baseline
    assert sched.stats["steps_predicated"] == 0  # counted for while segments only


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_with_chunked_prefill_admission(sides, baseline, layout):
    """Speculative segments × chunked admission: on the paged layout the
    verify windows of claimed, mid-prefill slots land at their frozen
    cursors in table rows still mostly scratch."""
    got, _ = _spec_parity(sides, SpecConfig(k=2, draft="truncate:1"), layout,
                          prefill_chunk=8, prefill_buckets=2)
    assert got == baseline


def test_spec_int8_kv_matches_jax_and_its_generate(sides):
    """Speculation is first class under the int8 KV cache: the verify rows
    attend the values sequential decode attends."""
    prompts, news = [np.arange(1, 9, dtype=np.int32), np.arange(3, 8, dtype=np.int32)], [10, 6]
    oracle = sides("dense", True)[1]
    want = [generate(oracle, p, n) for p, n in zip(prompts, news)]
    got, sched = _spec_parity(sides, SpecConfig(k=2, draft="truncate:1"), quant=True,
                              prompts=prompts, news=news, n_slots=2)
    assert got == want
    assert sched.stats["spec_steps"] > 0 and sched.stats["spec_skip_reason"] == ""


@pytest.mark.parametrize("first_news", [3, 11])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_while_spec_segment_equals_scan_up_to_its_stop(sides, layout, first_news):
    """Engine level: a while spec segment of 8 rounds that stops early (a
    slot finishes with ``stop_on_free``) gives the scan segment's emissions
    and tok / pos / done up to its stop, −1 after it.  The host first reads
    the stop flag at round ceil(8 / (k+1)) = 3 (no budget of 8 tokens ends
    sooner), then one round behind the card: so rounds run on past a stop
    before round 3 up to it, and one round past a later stop.  Those rounds
    are predicated and write only from the frozen cursors on, what the
    next real round writes there: the cache is the scan segment's after
    one more round."""
    kw = dict(n_blocks=16) if layout == "paged" else {}
    spec = SpecConfig(k=2, draft="truncate:1")
    out = {}
    for mode in ("while", "scan"):
        # two engines (the same weights): each keeps its own slot state
        eng = sides(layout, spec=spec, debug_invariants=mode == "scan")[1]
        sched = ContinuousScheduler(eng, n_slots=3, segment_len=8, **kw)
        for p, n in zip(prompts_of([5, 9, 6], 60), [first_news, 20, 20]):
            sched.submit(p, n)
        sched._admit()
        sched._ensure_segment_capacity()
        bt = sched.block_table if layout == "paged" else None
        if mode == "while":
            toks = eng.spec_segment(sched.state, 8, "while", sched.active, sched.limit,
                                    True, bt)
            steps = int((toks >= 0).any(2).any(0).sum())
            assert 1 <= steps < 8 and (toks[:, steps:] == -1).all()
            first = -(-8 // (spec.k + 1))
            assert (steps < first) == (first_news == 3)  # each way of finding the stop
            assert toks.shape[1] == (first if steps <= first else steps + 1)
            extra = None
        else:
            toks = eng.spec_segment(sched.state, steps, "scan", sched.active, sched.limit,
                                    False, bt)
            extra = {k: v.clone() for k, v in (("tok", sched.tok), ("pos", sched.pos),
                                               ("done", sched.done))}
            eng.spec_segment(sched.state, 1, "scan", sched.active, sched.limit, False, bt)
        out[mode] = (toks, extra, sched)
    (w_toks, _, w), (s_toks, s_state, s) = out["while"], out["scan"]
    assert torch.equal(w_toks[:, :steps], s_toks)
    for k in ("tok", "pos", "done"):
        assert torch.equal(getattr(w, k), s_state[k]), k
    for k in w.cache:
        assert torch.equal(w.cache[k], s.cache[k]), k
    assert bool(w.done[0]) and not bool(w.done[1:].any())


def _poison(sched, layout):
    """Every cache position at or past a slot's cursor (and, paged, every
    position no slot maps below its cursor) set to large garbage, in
    place: the int8 KV leaves to 127 and their scales to POISON."""
    pos = sched.pos.numpy()
    if layout == "paged":
        nb_total, bl = sched.n_slots + sched.n_blocks, sched.block_len
        stale = np.ones((nb_total, bl), bool)
        for slot in range(sched.n_slots):
            for j, phys in enumerate(sched.block_table[slot]):
                stale[phys] &= ~(j * bl + np.arange(bl) < pos[slot])
    else:
        stale = np.arange(MAX_LEN)[None, :] >= pos[:, None]  # (n_slots, S)
    stale = torch.from_numpy(stale)
    for leaf in sched.cache.values():
        value = 127 if leaf.dtype == torch.int8 else POISON
        mask = stale.reshape((1, *stale.shape) + (1,) * (leaf.dim() - 3))
        leaf.masked_fill_(mask.expand_as(leaf), value)


@pytest.mark.parametrize("layout,quant", [("dense", False), ("paged", False),
                                          ("dense", True)])
def test_rollback_cache_beyond_cursor_never_read(sides, baseline, layout, quant):
    """Rollback by cursor truncation is sound iff nothing reads the cache
    past a slot's accepted position: poisoning every such position between
    segments leaves the tokens those of ``generate``.  The truncated
    drafter's cache is a view of the verifier's first layer, so its k/v
    land there at pos … pos+k−1 (a copy in the reference); the window
    rewrites them before anything reads them, which this shows."""
    want = baseline
    if quant:
        oracle = sides("dense", True)[1]
        want = [generate(oracle, p, n) for p, n in zip(prompts_of(LENS), NEWS)]
    eng = sides(layout, quant, spec=SpecConfig(k=4, draft="truncate:1"))[1]
    sched = ContinuousScheduler(eng, segment_mode="while", **SCHED,
                                **({"n_blocks": 24} if layout == "paged" else {}))
    handles = [sched.submit(p, n) for p, n in zip(prompts_of(LENS), NEWS)]
    drain(sched, each=lambda s: _poison(s, layout))
    assert [h.tokens for h in handles] == want, (layout, quant)


@pytest.mark.parametrize("mode", ["scan", "while"])
def test_spec_segments_counted_and_eager_on_cpu(sides, mode):
    """One spec segment program per segment, the plain segments never run;
    on the CPU nothing is captured (the card test holds the captures)."""
    eng = sides(spec=SpecConfig(k=2, draft="truncate:1"))[1]
    before = dict(eng.call_counts)
    sched = ContinuousScheduler(eng, segment_mode=mode, **SCHED)
    for p, n in zip(prompts_of(LENS), NEWS):
        sched.submit(p, n)
    sched.run()
    runs = {k: eng.call_counts[k] - before[k] for k in SLOT_PROGRAMS}
    seg = "slot_spec_segment" + ("_while" if mode == "while" else "")
    assert runs[seg] == sched.stats["segments"] > 0
    assert runs["slot_segment"] == runs["slot_segment_while"] == 0
    assert sum(runs.values()) == runs[seg] + runs["prefill_slot"]
    assert not any(eng.trace_counts[k] for k in SLOT_PROGRAMS)

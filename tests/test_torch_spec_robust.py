"""Speculative decoding under preemption, an eos inside the window and
seeded random workloads, on the port (the speculative cases of
``tests/test_serve_robust.py`` and of ``tests/test_serve_stress.py``, and
``tests/test_serve_spec.py``'s eos case, are the checklist).

Overcommit with a k = 2 truncated drafter, preempting by recompute and by
swap: the JAX scheduler's tokens and counters (speculative ones included),
and the tokens of the uncontended run and of ``generate``.  The stress
matrix: seeded workloads, geometry and segment mode, requests submitted in
random bursts, dense and paged, chunked admission on a coin flip, a weak
drafter at k = 2 and an exact-conversion self-drafter at k = 4; every
request equals ``generate`` at B = 1, and after every segment the block
invariants hold and each live slot's cursor is prompt_len + emitted − 1
(rejected drafts never advance it).  The stress runs are the port's own
bitwise contract and run in the served bf16 compute
(``tests/torch_scheduler_pair.py`` says why chunked admission needs it);
parity with JAX in fp32.
"""
import numpy as np
import pytest

from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.serve.engine import SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import (BLOCK_LEN, MAX_LEN, drain, generate, parity, prompts_of,
                                  sides_fixture, spec_parity)

SPEC_CONFIGS = {
    "spec_k2": SpecConfig(k=2, draft="truncate:1"),
    "spec_k4": SpecConfig(k=4, draft="self", draft_sparsity=0.0),
}
DEBUG = dict(debug_invariants=True)
BF16 = dict(compute="bfloat16")


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


@pytest.mark.parametrize("preempt_mode", ["recompute", "swap"])
def test_overcommit_pool_preempts_and_stays_bit_identical(sides, preempt_mode):
    """Summed block demand (each request's k positions of headroom
    included) ≥ 1.5× the pool under overcommit 2: ≥ 1 preemption, every
    request completes, JAX's tokens and counters."""
    spec = SPEC_CONFIGS["spec_k2"]
    lens, news = [6, 8, 5, 8, 6, 7], [30, 24, 28, 22, 30, 26]
    prompts = prompts_of(lens, 300)
    demand = sum(-(-(len(p) + n + spec.k) // BLOCK_LEN) for p, n in zip(prompts, news))
    pool = 9  # the largest request needs 5 blocks
    assert demand >= 1.5 * pool
    eng = sides("paged", spec=spec, **DEBUG)[1]
    base = ContinuousScheduler(eng, n_slots=3, segment_len=4, n_blocks=demand)
    hb = [base.submit(p, n) for p, n in zip(prompts, news)]
    drain(base)
    assert base.stats["preemptions"] == 0
    handles, sched = parity(sides, prompts, news, layout="paged",
                            engine_kw={"spec": spec, **DEBUG}, spec_stats=True,
                            n_slots=3, segment_len=4, n_blocks=pool, overcommit=2.0,
                            preempt_mode=preempt_mode)
    st = sched.stats
    assert st["preemptions"] >= 1 and st["readmits"] >= 1 and st["blocks_grown"] > 0
    assert st["spec_steps"] > 0
    if preempt_mode == "swap":
        assert st["swap_outs"] >= 1 and st["swap_ins"] >= 1
    oracle = sides()[1]
    for h, b, (p, n) in zip(handles, hb, zip(prompts, news)):
        assert h.done and h.tokens == b.tokens == generate(oracle, p, n), h.rid
    assert sched.allocator.n_free == sched.allocator.capacity


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eos_within_draft_window(sides, layout):
    """An eos inside the window cuts acceptance where the plain scheduler
    stops: the eos is emitted, nothing after it."""
    prompt = prompts_of([6], 3)[0]
    eos = generate(sides()[1], prompt, 12)[5]
    prompts, news = [prompt, prompt[:4]], [12, 8]
    want, _ = parity(sides, prompts, news, layout, engine_kw=dict(eos_token=eos),
                     n_slots=2, segment_len=4, segment_mode="while",
                     **({"n_blocks": 24} if layout == "paged" else {}))
    got, _ = spec_parity(sides, SpecConfig(k=4, draft="truncate:1"), prompts, news, layout,
                         engine_kw=dict(eos_token=eos), n_slots=2)
    assert got == [h.tokens for h in want]
    assert got[0][-1] == eos and eos not in got[0][:-1] and len(got[0]) < 12


def test_submit_spec_headroom_value_error(sides):
    """A request must leave k positions for the rejected tail: the same
    ValueError, with the same message, as the JAX scheduler's."""
    jeng, teng = sides("paged", spec=SPEC_CONFIGS["spec_k2"], **DEBUG)
    prompt = prompts_of([30], 903)[0]
    msgs = []
    for sched in (JaxScheduler(jeng, n_slots=1, n_blocks=8),
                  ContinuousScheduler(teng, n_slots=1, n_blocks=8)):
        with pytest.raises(ValueError, match="draft window") as err:
            sched.submit(prompt, MAX_LEN - 31)
        assert not sched.queue
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _check_rollback_invariant(sched):
    pos = sched.pos.numpy()
    for slot, req in enumerate(sched.slots):
        if req is None or not sched.active[slot]:
            continue  # empty, or still mid-chunked-prefill
        want = req.prompt_len + len(req.tokens) - 1
        assert pos[slot] == want, (slot, int(pos[slot]), want)


def _random_run(eng, layout, prompts, news, rng, chunked, k):
    """The stress suite's run: random geometry and segment mode, the
    requests submitted in random bursts between segments."""
    n_slots = int(rng.randint(2, 4))
    kw = dict(n_slots=n_slots, segment_len=int(rng.randint(2, 8)),
              segment_mode=("scan", "while")[int(rng.randint(2))])
    if layout == "paged":
        need = max(-(-(len(p) + n + k) // BLOCK_LEN) for p, n in zip(prompts, news))
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
            _check_rollback_invariant(sched)
    return handles, sched


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec", ["spec_k2", "spec_k4"])
def test_random_workload_speculative_matches_oracle(sides, seed, spec):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(6, 12))
    lens = rng.choice((3, 5, 8, 13), n)
    news = [int(x) for x in rng.choice((1, 2, 5, 9, 16), n)]
    prompts = [rng.randint(0, 256, (m,)).astype(np.int32) for m in lens]
    oracle = sides("dense", **BF16)[1]
    want = [generate(oracle, p, m) for p, m in zip(prompts, news)]
    cfg = SPEC_CONFIGS[spec]
    for layout in ("dense", "paged"):
        srng = np.random.RandomState(seed + 100)
        handles, sched = _random_run(sides(layout, spec=cfg, **BF16)[1], layout, prompts,
                                     news, srng, bool(srng.randint(2)), cfg.k)
        for h, w, m in zip(handles, want, news):
            assert h.done and len(h.tokens) == m and h.tokens == w, (layout, spec, h.rid)
        st = sched.stats
        assert st["admitted"] == st["retired"] == len(prompts)
        assert st["spec_steps"] > 0
        assert all(1 <= c <= cfg.k + 1 for c in st["accepted_hist"])
        if layout == "paged":
            assert sched.allocator.n_free == sched.allocator.capacity

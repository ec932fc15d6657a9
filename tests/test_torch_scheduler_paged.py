"""The port's scheduler over the paged KV pool held against the JAX
package's (``tests/test_serve_paged.py`` is the checklist, with the
memory-ceiling case of ``tests/test_serve_stress.py``), and its own
contracts: paged ≡ dense and paged ≡ ``generate`` bit for bit, block-gated
admission without deadlock, the allocator invariants after every segment.
Setup and parity as ``tests/torch_scheduler_pair.py`` says."""
import numpy as np
import pytest
import torch

from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import MAX_LEN, drain, generate, sides_fixture, parity, prompts_of

LENS = [4, 7, 11, 5, 9, 3]
NEWS = [6, 12, 3, 1, 9, 14]


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


@pytest.mark.parametrize("mode", ["scan", "while"])
def test_ragged_workload_matches_jax_scheduler(sides, mode):
    """Ragged prompts and budgets (with a 1-token request) through a pool of
    10 blocks: the JAX scheduler's tokens and counters, the invariants
    checked after every segment, every block back at the end."""
    handles, sched = parity(sides, prompts_of(LENS), NEWS, layout="paged", check=True,
                            n_slots=2, segment_len=5, segment_mode=mode, n_blocks=10)
    assert all(h.done for h in handles)
    assert sched.allocator.n_free == sched.allocator.capacity
    assert sched.stats["blocks_grown"] > 0


def test_paged_equals_dense_and_generate(sides):
    scheds = {}
    for layout in ("dense", "paged"):
        _, eng = sides(layout)
        kw = dict(n_blocks=10) if layout == "paged" else {}
        sched = ContinuousScheduler(eng, n_slots=2, segment_len=5, **kw)
        handles = [sched.submit(p, n) for p, n in zip(prompts_of(LENS), NEWS)]
        drain(sched, check=True)
        scheds[layout] = handles
    oracle = sides()[1]
    for p, n, a, b in zip(prompts_of(LENS), NEWS, scheds["dense"], scheds["paged"]):
        assert a.tokens == b.tokens == generate(oracle, p, n), b.rid


@pytest.mark.parametrize("mode", ["scan", "while"])
def test_uniform_workload_bit_identical_to_generate(sides, mode):
    _, eng = sides("paged")
    prompts = prompts_of([8] * 6, 3)
    want = sides()[1].generate(torch.from_numpy(np.stack(prompts)).long(), 10).tolist()
    sched = ContinuousScheduler(eng, n_slots=3, segment_len=4, segment_mode=mode)
    handles = [sched.submit(p, 10) for p in prompts]
    drain(sched, check=True)
    assert [h.tokens for h in handles] == want


def test_eos_retirement_frees_blocks(sides):
    eos = generate(sides()[1], prompts_of([8], 40)[0], 12)[4]
    prompts = prompts_of([8], 40) + prompts_of([8], 41)
    handles, sched = parity(sides, prompts, [12, 3], layout="paged",
                            engine_kw=dict(eos_token=eos), check=True, n_slots=1,
                            segment_len=4, n_blocks=4)
    h, h2 = handles
    assert h.finish_reason == "stop" and h.tokens[-1] == eos and len(h.tokens) < 12
    assert len(h2.tokens) == 3
    assert sched.allocator.n_free == sched.allocator.capacity


def test_small_pool_defers_admission_without_deadlock(sides):
    """A pool that holds one request at a time serializes the workload by
    deferral; every request still gets the dense scheduler's tokens."""
    prompts, news = prompts_of([8, 8, 8], 50), [16, 16, 16]
    handles, sched = parity(sides, prompts, news, layout="paged", check=True, n_slots=2,
                            segment_len=4, n_blocks=3)
    assert sched.stats["admit_deferred"] > 0
    assert sched.stats["blocks_in_use_peak"] <= sched.n_blocks
    oracle = sides()[1]
    for p, n, h in zip(prompts, news, handles):
        assert h.tokens == generate(oracle, p, n)


def test_submit_rejects_request_that_can_never_fit(sides):
    jeng, teng = sides("paged")
    msgs = []
    for sched in (JaxScheduler(jeng, n_slots=1, n_blocks=2),
                  ContinuousScheduler(teng, n_slots=1, n_blocks=2)):
        with pytest.raises(ValueError, match="blocks") as err:
            sched.submit(prompts_of([20], 60)[0], 10)  # needs 4 blocks, pool has 2
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_n_blocks_only_for_paged_as_jax(sides):
    for eng in sides():
        with pytest.raises(AssertionError):
            (JaxScheduler if type(eng).__module__.startswith("repro.")
             else ContinuousScheduler)(eng, n_slots=2, n_blocks=4)


def test_paged_slot_programs_counted(sides):
    _, eng = sides("paged")
    before = dict(eng.call_counts)
    sched = ContinuousScheduler(eng, n_slots=2, segment_len=3, n_blocks=12)
    for p, n in zip(prompts_of([4, 7, 4, 7, 4], 60), [5, 6, 7, 8, 9]):
        sched.submit(p, n)
    drain(sched)
    runs = {k: v - before[k] for k, v in eng.call_counts.items()}
    assert runs["prefill_slot_paged"] == 5 and runs["prefill_slot"] == 0
    assert runs["slot_segment_paged"] == sched.stats["segments"] >= 2
    # one program per prompt length and one segment program (one step,
    # whatever the segment's length) in the state
    shapes = sorted(k for k in sched.state.programs)
    assert shapes == [("prefill_slot_paged", (4,)), ("prefill_slot_paged", (7,)),
                      ("slot_segment_paged", ())]


def test_paged_pool_serves_more_context_than_it_holds(sides):
    """A pool smaller than the dense slot cache serves a workload whose
    summed context exceeds the dense layout's capacity, with the
    ``generate`` tokens."""
    rng = np.random.RandomState(7)
    n_slots, n_blocks = 2, 8  # 8 blocks of 8 = 64 tokens < 2 × 64 dense
    prompts = [rng.randint(0, 256, (6,)).astype(np.int32) for _ in range(8)]
    news = [26] * 8
    assert sum(len(p) + n for p, n in zip(prompts, news)) > n_slots * MAX_LEN
    _, eng = sides("paged")
    sched = ContinuousScheduler(eng, n_slots=n_slots, segment_len=6, n_blocks=n_blocks)
    handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
    drain(sched, check=True)
    oracle = sides()[1]
    for p, n, h in zip(prompts, news, handles):
        assert h.done and h.tokens == generate(oracle, p, n)
    pool_bytes = sum(t.numel() * t.element_size() for t in sched.cache.values())
    dense = sides()[1].arch.init_cache(n_slots, MAX_LEN, "meta")
    dense_bytes = sum(t.numel() * t.element_size() for t in dense.values())
    assert pool_bytes + sched.block_table.nbytes < dense_bytes

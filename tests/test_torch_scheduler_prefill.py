"""The port's chunked, bucketed admission (``prefill_slots``) held against
the JAX package's (``tests/test_serve_prefill.py`` is the checklist), and
its own contracts: chunked ≡ per-request ≡ ``generate`` bit for bit under
both layouts (in bf16 compute), prefill shapes bounded by the bucket set, Sarathi-style token
budgets.  Setup and parity as ``tests/torch_scheduler_pair.py`` says."""
import pytest

from repro.serve import ContinuousScheduler as JaxScheduler
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import drain, generate, sides_fixture, parity, prompts_of

CHUNK, N_BUCKETS = 16, 3  # buckets (4, 8, 16)
BF16 = dict(compute="bfloat16")  # the port's own bitwise contracts (see make_sides)
LENS = [3, 7, 13, 16, 17, 37, 5, 2, 24]
NEWS = [6, 12, 3, 1, 9, 8, 5, 4, 7]


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture()


def _kw(layout, **kw):
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("prefill_buckets", N_BUCKETS)
    kw.setdefault("segment_len", 4)
    kw.setdefault("n_slots", 3)
    if layout == "paged":
        kw.setdefault("n_blocks", 20)
    return kw


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("budget", [0, 8])
def test_chunked_admission_matches_jax_scheduler(sides, layout, budget):
    handles, sched = parity(sides, prompts_of(LENS, 10), NEWS, layout=layout, check=True,
                            **_kw(layout, prefill_token_budget=budget))
    assert all(h.done for h in handles)
    assert sched.stats["chunks_prefilled"] >= len(LENS)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunked_equals_per_request_and_generate(sides, layout):
    """Prompts straddling chunk (16) and block (8) boundaries, with a
    1-token request: chunked admission, per-request admission and
    ``generate`` at B = 1 give the same tokens."""
    prompts = prompts_of(LENS, 10)
    _, eng = sides(layout, **BF16)
    oracle = sides(**BF16)[1]
    want = [generate(oracle, p, n) for p, n in zip(prompts, NEWS)]
    for chunked in (False, True):
        kw = _kw(layout) if chunked else _kw(layout, prefill_chunk=0)
        sched = ContinuousScheduler(eng, **kw)
        handles = [sched.submit(p, n) for p, n in zip(prompts, NEWS)]
        drain(sched, check=True)
        assert [h.tokens for h in handles] == want, (layout, chunked)


def test_long_prompt_chunks_interleave_with_decode(sides):
    """A prompt longer than the chunk spreads over several admit rounds
    while a batch of short requests keeps decoding and finishing; alone, a
    long prompt's chunks run back to back in one admit round."""
    _, eng = sides(**BF16)
    long_p, shorts = prompts_of([40], 50)[0], prompts_of([4, 6], 51)
    sched = ContinuousScheduler(eng, **_kw("dense", segment_len=2))
    h_shorts = [sched.submit(p, 4) for p in shorts]
    sched.run_segment()
    h_long = sched.submit(long_p, 6)
    t = [0.0]

    def tick(s):
        t[0] += 1.0

    sched.clock = lambda: t[0]
    drain(sched, each=tick)
    assert h_long.tokens == generate(eng, long_p, 6)
    assert [h.tokens for h in h_shorts] == [generate(eng, p, 4) for p in shorts]
    assert sched.stats["chunks_prefilled"] >= 3 + 2
    assert min(h.finish_t for h in h_shorts) < h_long.first_token_t

    alone = ContinuousScheduler(eng, **_kw("dense", segment_len=2))
    h2 = alone.submit(prompts_of([40], 53)[0], 4)
    alone.run_segment()
    assert h2.tokens
    assert alone.stats["admit_rounds"] == 1 and alone.stats["chunks_prefilled"] == 3


def test_paged_bucket_padding_spills_past_mapped_blocks(sides):
    """Prompt 33 + 2 new maps 5 blocks of 8 but its final chunk buckets to
    64 wide: the spilled padding drops through distinct out-of-range ids,
    and the tokens stay ``generate``'s."""
    _, eng = sides("paged", **BF16)
    p = prompts_of([33], 80)[0]
    sched = ContinuousScheduler(eng, **_kw("paged", prefill_chunk=64, prefill_buckets=4))
    other = sched.submit(prompts_of([5], 81)[0], 4)
    h = sched.submit(p, 2)
    drain(sched, check=True)
    assert h.tokens == generate(sides(**BF16)[1], p, 2)
    assert other.done and len(other.tokens) == 4


def test_max_new_one_finishes_at_admission(sides):
    _, eng = sides(**BF16)
    p = prompts_of([5], 30)[0]
    sched = ContinuousScheduler(eng, **_kw("dense"))
    h = sched.submit(p, 1)
    drain(sched)
    assert h.done and h.tokens == generate(eng, p, 1)
    assert sched.stats["segments"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_shapes_bounded_by_buckets(sides, layout):
    """Sixteen requests over twelve prompt lengths: per-request admission
    runs one prefill program per length, chunked admission at most
    n_buckets × n_widths, and never the per-request program."""
    rng_lens = [3, 4, 5, 6, 7, 9, 11, 13, 15, 16, 21, 37]
    lens = [rng_lens[i % len(rng_lens)] for i in range(16)]
    news = [2 + i % 4 for i in range(16)]
    prompts = prompts_of(lens, 3)
    sfx = "_paged" if layout == "paged" else ""
    _, eng = sides(layout, **BF16)
    progs = {}
    for chunked in (False, True):
        kw = _kw(layout, n_slots=4, **({} if chunked else {"prefill_chunk": 0}))
        kw["n_blocks"] = 24 if layout == "paged" else None
        kw = {k: v for k, v in kw.items() if v is not None}
        sched = ContinuousScheduler(eng, **kw)
        handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
        drain(sched)
        progs[chunked] = (sched, [h.tokens for h in handles],
                          {k for k in sched.state.programs})
    (per, per_toks, per_progs), (bat, bat_toks, bat_progs) = progs[False], progs[True]
    assert per_toks == bat_toks
    singles = {k for k in per_progs if k[0] == "prefill_slot" + sfx}
    assert len(singles) == len(set(lens))
    batched = {k for k in bat_progs if k[0] == "prefill_slots" + sfx}
    assert 0 < len(batched) <= bat.max_prefill_traces < len(set(lens))
    assert sum(bat.stats["prefill_batch_hist"].values()) == bat.stats["prefill_launches"]


def test_scheduler_validates_chunk_geometry_as_jax(sides):
    jeng, teng = sides()
    for cls, eng in ((JaxScheduler, jeng), (ContinuousScheduler, teng)):
        with pytest.raises(AssertionError):  # not a power of two
            cls(eng, prefill_chunk=12)
        with pytest.raises(AssertionError):  # more buckets than chunk halvings
            cls(eng, prefill_chunk=4, prefill_buckets=8)
    jeng, teng = sides(max_len=50)
    for cls, eng in ((JaxScheduler, jeng), (ContinuousScheduler, teng)):
        with pytest.raises(AssertionError):  # the chunk must divide max_len
            cls(eng, prefill_chunk=16)


def test_token_budget_bounds_prefill_per_round(sides):
    """``prefill_token_budget`` caps the real prefill tokens an admit round
    advances, with the JAX scheduler's rounds, and the tokens of the
    unbudgeted run."""
    prompts, news = prompts_of([40, 40, 40], 200), [6, 6, 6]
    runs = {}
    for budget in (0, CHUNK, CHUNK // 2):
        handles, sched = parity(sides, prompts, news,
                                **_kw("dense", segment_mode="scan",
                                      prefill_token_budget=budget))
        runs[budget] = ([h.tokens for h in handles], sched.stats["prefill_tokens_per_round"])
    assert runs[CHUNK][0] == runs[0][0] == runs[CHUNK // 2][0]
    assert max(runs[CHUNK][1]) <= CHUNK < max(runs[0][1])
    assert max(runs[CHUNK // 2][1]) <= CHUNK


def test_token_budget_ignored_without_chunked_admission(sides):
    _, eng = sides()
    sched = ContinuousScheduler(eng, n_slots=3, prefill_token_budget=64)
    assert sched.prefill_token_budget == 0
    h = sched.submit(prompts_of([5], 220)[0], 3)
    drain(sched)
    assert h.done and len(h.tokens) == 3

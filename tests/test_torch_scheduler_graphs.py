"""The continuous scheduler's slot programs as CUDA graphs.  No JAX: the
tests marked ``cuda`` run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_scheduler_graphs.py``
and skip without a card.

On the card, at the reduced tinyllama (2 layers, d_model 64) in the served
bf16 compute with int8 weights at the automatic blocks (the tensor-core
routes):

* each slot program is captured once per shape across segments (a
  segment program, one step, once whatever the segments' lengths), and a
  second scheduler of the same geometry captures nothing;
* graph ≡ eager (``loop="python"``) bit for bit for every program — the
  tokens, tok / pos / done and the cache — greedy and sampled from the
  scheduler's generator, dense and paged, scan and while, per-request and
  chunked admission;
* a second admission into another slot writes only that slot's row or
  blocks;
* paged ≡ dense ≡ chunked ≡ ``generate`` at B = 1, bit for bit;
* the kernels' launch and route counters after a graph run equal the eager
  run's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import counters
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler

MAX_LEN, BLOCK_LEN = 64, 8
INT8 = dict(weight_quant="int8", weight_quant_sparsity=0.5)
LENS = [4, 7, 11, 5, 9, 3, 16]
NEWS = [6, 12, 3, 1, 9, 14, 8]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda):
    arch = _arch()
    return arch.init_params(torch.Generator(device=cuda).manual_seed(0), cuda)


def _arch():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    return dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="bfloat16"))


def _engine(params, device, loop="scan", layout="dense", **kw):
    sc = ServeConfig(max_len=MAX_LEN, loop=loop, kv_layout=layout, block_len=BLOCK_LEN,
                     **INT8, **kw)
    return ServeEngine(_arch(), params, sc, device=device)


def _prompts(lens=LENS, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).astype(np.int32) for n in lens]


def _serve(eng, prompts, news, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("segment_len", 4)
    if eng.sc.kv_layout == "paged":
        kw.setdefault("n_blocks", 20)
    sched = ContinuousScheduler(eng, **kw)
    handles = [sched.submit(p, n) for p, n in zip(prompts, news)]
    sched.run()
    assert all(h.done for h in handles)
    return [h.tokens for h in handles], sched


def _state(sched):
    return {"tok": sched.tok.clone(), "pos": sched.pos.clone(), "done": sched.done.clone(),
            **{k: v.clone() for k, v in sched.cache.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["scan", "while"])
def test_cuda_slot_programs_captured_once_per_shape(cuda, params, layout, mode):
    eng = _engine(params, cuda, layout=layout)
    sfx = "_paged" if layout == "paged" else ""
    seg = "slot_segment" + ("_while" if mode == "while" else "") + sfx
    lens = [4, 7, 4, 7, 4]  # two prompt lengths
    news = [5 + i for i in range(len(lens))]
    _, sched = _serve(eng, _prompts(lens), news, n_slots=2, segment_len=3, segment_mode=mode)
    assert sched.stats["segments"] >= 2
    # one segment program: one step, whatever the segment's length
    shapes = {shape for name, shape in sched.state.programs if name == seg}
    assert eng.trace_counts[seg] == 1 and shapes == {()}
    assert eng.call_counts[seg] == sched.stats["segments"]
    assert eng.trace_counts["prefill_slot" + sfx] == 2  # one per prompt length
    assert eng.call_counts["prefill_slot" + sfx] == len(lens)
    assert eng.slot_eager_runs == 0
    before = dict(eng.trace_counts)
    _serve(eng, _prompts(lens), news, n_slots=2, segment_len=3, segment_mode=mode)
    assert eng.trace_counts == before  # the same geometry: no capture


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["scan", "while"])
@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("sampled", [False, True])
def test_cuda_graph_equals_eager(cuda, params, layout, mode, chunk, sampled):
    kw = dict(temperature=0.9, top_k=20) if sampled else {}
    engines = {loop: _engine(params, cuda, loop=loop, layout=layout, **kw)
               for loop in ("scan", "python")}
    out = {}
    for loop, eng in engines.items():
        toks, sched = _serve(eng, _prompts(), NEWS, segment_mode=mode, seed=7,
                             prefill_chunk=chunk, prefill_buckets=2)
        out[loop] = (toks, _state(sched))
    assert engines["scan"].slot_eager_runs == 0 and engines["python"].slot_eager_runs > 0
    assert out["scan"][0] == out["python"][0]
    for k, v in out["python"][1].items():
        assert torch.equal(out["scan"][1][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cuda_second_admission_writes_only_its_slot(cuda, params, layout):
    """Two admissions at one prompt length (the second a replay of the
    first's graph) into slots 0 and 1: the second changes only slot 1's
    row (dense) or the blocks it maps (paged)."""
    eng = _engine(params, cuda, layout=layout)
    sched = ContinuousScheduler(eng, n_slots=3, segment_len=4,
                                **({"n_blocks": 12} if layout == "paged" else {}))
    p0, p1 = _prompts([9, 9])
    sched.submit(p0, 8)
    sched._admit()
    before = _state(sched)
    assert eng.trace_counts["prefill_slot" + ("_paged" if layout == "paged" else "")] == 1
    sched.submit(p1, 8)
    sched._admit()
    after = _state(sched)
    assert sched.slots[1] is not None and sched.slots[1].slot_history == [1]
    for k in ("tok", "pos", "done"):
        changed = (before[k] != after[k]).nonzero().flatten().tolist()
        assert set(changed) <= {1}, (k, changed)
    for k in sched.cache:
        diff = (before[k] != after[k]).flatten(2).any(-1)  # (L, rows)
        rows = diff.any(0).nonzero().flatten().tolist()
        allowed = set(sched.allocator.mapped[1]) if layout == "paged" else {1}
        assert rows and set(rows) <= allowed, (k, rows, allowed)
    # and slot 1 holds what admitting p1 alone gives
    alone = ContinuousScheduler(_engine(params, cuda, layout=layout), n_slots=3,
                                **({"n_blocks": 12} if layout == "paged" else {}))
    alone.submit(p1, 8)
    alone._admit()
    assert alone.slots[0] is not None
    if layout == "dense":
        for k in sched.cache:
            assert torch.equal(sched.cache[k][:, 1], alone.cache[k][:, 0]), k
    else:
        for k in sched.cache:
            a = sched.cache[k][:, sched.allocator.mapped[1]]
            b = alone.cache[k][:, alone.allocator.mapped[0]]
            assert torch.equal(a, b), k


@pytest.mark.cuda
def test_cuda_paged_chunked_dense_equal_generate(cuda, params):
    prompts = _prompts()
    oracle = _engine(params, cuda)
    want = [oracle.generate(torch.from_numpy(p)[None].to(cuda), n)[0].tolist()
            for p, n in zip(prompts, NEWS)]
    for layout in ("dense", "paged"):
        for chunk in (0, 8):
            got, _ = _serve(_engine(params, cuda, layout=layout), prompts, NEWS,
                            prefill_chunk=chunk, prefill_buckets=2)
            assert got == want, (layout, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cuda_counters_true_per_replay(cuda, params, layout):
    counts = {}
    for loop in ("scan", "python"):
        eng = _engine(params, cuda, loop=loop, layout=layout)
        _serve(eng, _prompts(), NEWS)  # the scan engine captures here
        before = counters.snapshot()
        _serve(eng, _prompts(), NEWS)  # and replays only here
        counts[loop] = counters.diff(counters.snapshot(), before)
    assert counts["scan"] == counts["python"]
    assert counts["scan"]["block_sparse_matmul_int8"][0] > 0
    assert counts["scan"]["sonic_matvec_int8"][0] > 0

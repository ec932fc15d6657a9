"""Speculative decoding's slot programs as CUDA graphs.  No JAX: the tests
marked ``cuda`` run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_spec_graphs.py``
and skip without a card.

On the card, at the reduced tinyllama (2 layers, d_model 64) in the served
bf16 compute with int8 weights at the automatic blocks (the tensor-core
routes):

* each of the four spec programs is one graph of one round per geometry,
  whatever the segment lengths; a second scheduler of the same geometry
  captures nothing, and nothing runs eagerly;
* graph ≡ eager (``loop="python"``) bit for bit — the tokens, tok / pos /
  done and the cache — for both drafters, dense and paged, scan and while;
* every speculative run gives the tokens of ``generate`` at B = 1, and a
  drafter of full depth (``truncate:2``) has every draft accepted but at
  budget edges: its decode rows (the int8 matvec) and the window's rows
  (the int8 matmul) agree bit for bit;
* the kernels' launch and route counters after a graph run equal the eager
  run's, the self-drafter's on ``block_sparse_matmul`` (its tensor cores
  wherever the blocks fit).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, counters
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
from repro_torch.serve.scheduler import ContinuousScheduler

MAX_LEN, BLOCK_LEN = 64, 8
INT8 = dict(weight_quant="int8", weight_quant_sparsity=0.5)
LENS = [4, 7, 11, 5, 9, 3, 16]
NEWS = [6, 12, 3, 1, 9, 14, 8]
DRAFTS = {"truncate1": SpecConfig(k=2, draft="truncate:1"),
          "self": SpecConfig(k=4, draft="self", draft_sparsity=0.75),
          "full": SpecConfig(k=4, draft="truncate:2")}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda):
    return _arch().init_params(torch.Generator(device=cuda).manual_seed(0), cuda)


def _arch():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    return dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="bfloat16"))


def _engine(params, device, spec=None, loop="scan", layout="dense"):
    sc = ServeConfig(max_len=MAX_LEN, loop=loop, kv_layout=layout, block_len=BLOCK_LEN,
                     spec=spec, **INT8)
    return ServeEngine(_arch(), params, sc, device=device)


def _prompts(lens=LENS, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).astype(np.int32) for n in lens]


def _serve(eng, prompts=None, news=NEWS, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("segment_len", 4)
    if eng.sc.kv_layout == "paged":
        kw.setdefault("n_blocks", 24)
    sched = ContinuousScheduler(eng, **kw)
    handles = [sched.submit(p, n) for p, n in zip(prompts or _prompts(), news)]
    sched.run()
    assert all(h.done for h in handles)
    return [h.tokens for h in handles], sched


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["scan", "while"])
def test_cuda_spec_program_captured_once(cuda, params, layout, mode):
    eng = _engine(params, cuda, DRAFTS["truncate1"], layout=layout)
    seg = ("slot_spec_segment" + ("_while" if mode == "while" else "")
           + ("_paged" if layout == "paged" else ""))
    _, sched = _serve(eng, segment_mode=mode)
    assert sched.stats["segments"] >= 2
    assert eng.trace_counts[seg] == 1 and eng.call_counts[seg] == sched.stats["segments"]
    assert not eng.trace_counts["slot_segment"] and not eng.slot_eager_runs
    before = dict(eng.trace_counts)
    _serve(eng, segment_mode=mode, segment_len=7)  # another length: the same graph
    assert eng.trace_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["truncate1", "self"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["scan", "while"])
def test_cuda_spec_graph_equals_eager(cuda, params, draft, layout, mode):
    out = {}
    for loop in ("scan", "python"):
        eng = _engine(params, cuda, DRAFTS[draft], loop=loop, layout=layout)
        toks, sched = _serve(eng, segment_mode=mode)
        out[loop] = (toks, {"tok": sched.tok, "pos": sched.pos, "done": sched.done,
                            **sched.cache})
    assert out["scan"][0] == out["python"][0]
    for k, v in out["python"][1].items():
        assert torch.equal(out["scan"][1][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["truncate1", "self", "full"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cuda_spec_equals_generate(cuda, params, draft, layout):
    oracle = _engine(params, cuda)
    prompts = _prompts()
    want = [oracle.generate(torch.from_numpy(p)[None].to(cuda), n)[0].tolist()
            for p, n in zip(prompts, NEWS)]
    got, sched = _serve(_engine(params, cuda, DRAFTS[draft], layout=layout), prompts,
                        segment_mode="while")
    assert got == want, (draft, layout)
    hist, k = sched.stats["accepted_hist"], DRAFTS[draft].k
    if draft == "full":
        # every draft accepted: (n − 1) // (k + 1) rounds of k + 1 per
        # request and one of the remainder at its budget's edge
        want = {}
        for n in NEWS:
            for size, count in ((k + 1, (n - 1) // (k + 1)), ((n - 1) % (k + 1), 1)):
                if size and count:
                    want[size] = want.get(size, 0) + count
        assert hist == want


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["truncate1", "self"])
def test_cuda_spec_counters_true_per_replay(cuda, params, draft):
    counts = {}
    for loop in ("scan", "python"):
        eng = _engine(params, cuda, DRAFTS[draft], loop=loop)
        _serve(eng)  # the scan engine captures here
        before = counters.snapshot()
        _serve(eng)  # and replays only here
        counts[loop] = counters.diff(counters.snapshot(), before)
    assert counts["scan"] == counts["python"]
    assert counts["scan"]["block_sparse_matmul_int8"][0] > 0
    if draft == "self":
        launches, routes = counts["scan"]["block_sparse_matmul"]
        # (32-column projections take the CUDA cores at this width)
        assert launches > 0 and routes[build.TENSOR_CORES] > 0

"""The engine's decode loops as CUDA graphs, and the serving modes on the
card.  No JAX: the tests marked ``cuda`` run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_graphs.py``
and skip without a card; the others run on the CPU.

On the card, at the reduced tinyllama (2 layers, d_model 64) in the served
bf16 compute, with int8 weights at the automatic blocks (the tensor-core
routes) and with dense weights (cuBLAS), bf16 and int8 KV:

* the graph loops ("scan", "while") equal the eager loop ("python") bit for
  bit, tokens and last logits, greedy and sampled from one generator seed;
  one capture per shape, none on a second call;
* the kernels' launch and route counters after a graph loop equal the
  eager loop's (captured counts × replays);
* a verify window through the full model equals the sequential decode
  steps bit for bit.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import counters
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import SLOT_PROGRAMS, ServeConfig, ServeEngine

B, S, NEW, MAX_LEN = 3, 8, 12, 32
INT8 = dict(weight_quant="int8", weight_quant_sparsity=0.5)

NO_SLOT_RUNS = dict.fromkeys(SLOT_PROGRAMS, 0)  # generate runs no slot program


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _arch(compute="bfloat16"):
    arch = get_arch("tinyllama-1.1b", reduced=True)
    return dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype=compute))


def _params(arch, device):
    return arch.init_params(torch.Generator(device=device).manual_seed(0), device)


def _prompts(device, b=B, s=S):
    return torch.randint(0, 256, (b, s), generator=torch.Generator().manual_seed(1)).to(device)


def _engines(device, loops=("scan", "while", "python"), quant=False, **kw):
    arch = _arch()
    params = _params(arch, device)
    return {loop: ServeEngine(arch, params, ServeConfig(max_len=MAX_LEN, loop=loop, **kw),
                              device=device, cache_quant_int8=quant) for loop in loops}


# ------------------------------------------------------------------ CPU


def test_cpu_loops_run_eagerly_and_agree():
    """On the CPU no loop captures; the three give the same tokens, greedy
    and sampled (top-k) from one generator seed, and count every prefill and
    step."""
    for kw in ({}, dict(temperature=0.8, top_k=8), dict(temperature=1.0, top_p=0.9)):
        engines = _engines("cpu", **INT8, **kw)
        outs = {loop: eng.generate(_prompts("cpu"), NEW, torch.Generator().manual_seed(7))
                for loop, eng in engines.items()}
        assert torch.equal(outs["scan"], outs["python"]) and torch.equal(
            outs["while"], outs["python"]), kw
        for eng in engines.values():
            assert eng.trace_counts == {"prefill": 0, "decode": 0, **NO_SLOT_RUNS}
            assert eng.call_counts == {"prefill": 1, "decode": NEW - 1, **NO_SLOT_RUNS}
            assert not eng.graphs


def test_engine_surface_for_the_scheduler():
    for quant in (False, True):
        eng = _engines("cpu", loops=("scan",), quant=quant, kv_layout="paged",
                       block_len=8)["scan"]
        assert eng.max_blocks_per_slot == MAX_LEN // 8
        slot = eng.init_slot_cache(4)
        pool = eng.init_paged_cache(10, n_slots=3)
        assert slot["k"].shape[1] == 4 and slot["k"].shape[2] == MAX_LEN
        assert pool["k"].shape[1:3] == (13, 8)
        assert ("k_scale" in slot) == quant == ("k_scale" in pool)
        eng.check_chunked_prefill_contract()
        assert eng._checked_contracts == {"slot", "paged", "slots"}


def test_engine_rejects_bad_configs():
    arch = _arch()
    params = _params(arch, "cpu")
    for sc in (ServeConfig(loop="jit"), ServeConfig(kv_layout="ragged"),
               ServeConfig(max_len=30, kv_layout="paged", block_len=16)):
        with pytest.raises(ValueError):
            ServeEngine(arch, params, sc, device="cpu")
    eng = ServeEngine(arch, params, ServeConfig(max_len=16), device="cpu")
    with pytest.raises(ValueError):
        eng.generate(_prompts("cpu"), 9)  # 8 + 9 > 16


def test_counters_replay_bookkeeping():
    """``kernels.counters``: a snapshot, a restore and ``add`` of a
    difference times n, as the engine keeps counts true per replay."""
    w = counters.WRAPPERS["sonic_matvec_int8"]
    before = counters.snapshot()
    w.launches += 3
    w.routes["tensor_cores"] += 3
    delta = counters.diff(counters.snapshot(), before)
    counters.restore(before)
    assert counters.snapshot() == before
    counters.add(delta, 5)
    assert w.launches == before["sonic_matvec_int8"][0] + 15
    assert w.routes["tensor_cores"] == before["sonic_matvec_int8"][1]["tensor_cores"] + 15
    counters.restore(before)


# ------------------------------------------------------------------ card


WEIGHTS = pytest.mark.parametrize("weights", ["int8", "dense"])
KV = pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])


@pytest.mark.cuda
@WEIGHTS
@KV
def test_cuda_graph_loops_equal_eager_bitwise(cuda, weights, quant):
    kw = INT8 if weights == "int8" else {}
    engines = _engines(cuda, quant=quant, **kw)
    prompts = _prompts(cuda)
    want = engines["python"].generate(prompts, NEW)
    want_logits = engines["python"].last_logits[B].clone()
    for loop in ("scan", "while"):
        eng = engines[loop]
        for _ in range(2):  # captures, then replays only
            got = eng.generate(prompts, NEW)
            assert torch.equal(got, want), loop
            assert torch.equal(eng.last_logits[B], want_logits), loop
        assert eng.trace_counts == {"prefill": 1, "decode": 1, **NO_SLOT_RUNS}, loop
        assert eng.call_counts == {"prefill": 2, "decode": 2 * (NEW - 1), **NO_SLOT_RUNS}, loop
    assert engines["python"].trace_counts == {"prefill": 0, "decode": 0, **NO_SLOT_RUNS}


@pytest.mark.cuda
def test_cuda_graph_loops_sample_as_eager(cuda):
    """Temperature, top-k and top-p inside the graphs, the caller's
    generator registered with them: the draws of the eager loop."""
    engines = _engines(cuda, loops=("scan", "python"), temperature=0.9, top_k=20, top_p=0.95)
    prompts = _prompts(cuda)
    outs = {}
    for loop, eng in engines.items():
        gen = torch.Generator(device=cuda)
        outs[loop] = [eng.generate(prompts, NEW, gen.manual_seed(s)) for s in (3, 3, 4)]
    for a, b in zip(outs["scan"], outs["python"]):
        assert torch.equal(a, b)
    assert torch.equal(outs["scan"][0], outs["scan"][1])
    assert not torch.equal(outs["scan"][0], outs["scan"][2])
    # one generator object throughout: captured once
    assert engines["scan"].trace_counts == {"prefill": 1, "decode": 1, **NO_SLOT_RUNS}


@pytest.mark.cuda
def test_cuda_counters_true_per_replay(cuda):
    engines = _engines(cuda, loops=("scan", "python"), **INT8)
    prompts = _prompts(cuda)
    counts = {}
    for loop, eng in engines.items():
        eng.generate(prompts, NEW)  # the first call warms up and captures
        zero = {name: (0, dict.fromkeys(r, 0)) for name, (_, r) in counters.snapshot().items()}
        counters.restore(zero)
        eng.generate(prompts, NEW)
        counts[loop] = counters.snapshot()
    assert counts["scan"] == counts["python"]
    # the decode steps' projections on the tensor-core route take the matvec
    launches = counts["scan"]["sonic_matvec_int8"][0]
    assert launches > 0 and launches % (NEW - 1) == 0


@pytest.mark.cuda
@WEIGHTS
@KV
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_verify_window_equals_sequential_decode(cuda, weights, quant, b):
    """Through the full model on the card: a window of k + 1 = 5 rows at
    ``decode_chunk`` ≡ 5 sequential decode steps, logits and cache."""
    arch = _arch()
    params = _params(arch, cuda)
    if weights == "int8":
        from repro_torch.core.sonic_layers import quantize_serve_params

        params = quantize_serve_params(params, sparsity=0.5)
    toks = _prompts(cuda, b, S + 5)
    cache = tT.init_cache(arch.cfg, b, MAX_LEN, cuda, cache_quant_int8=quant)
    with torch.inference_mode():
        _, cache = arch.forward(params, tokens=toks[:, :S], cache=cache)
        seq = {k: v.clone() for k, v in cache.items()}
        window, cache = arch.forward(params, tokens=toks[:, S:], cache=cache,
                                     cache_pos=torch.full((b,), S, device=cuda),
                                     decode_chunk=True)
        for i in range(5):
            lg, seq = arch.forward(params, tokens=toks[:, S + i:S + i + 1], cache=seq,
                                   cache_pos=torch.full((b,), S + i, device=cuda))
            assert torch.equal(lg[:, 0], window[:, i]), f"row {i}"
    for name in cache:
        assert torch.equal(cache[name], seq[name]), name

"""The recurrent families' serving on the card: zamba2-7b's hybrid and
rwkv6-3b at their published width, cut to 2 layers (zamba2: one shared
attention invocation and two Mamba2 layers), bf16.  No JAX: the tests
marked ``cuda`` run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_recurrent_graphs.py``
and skip without a card.

* The graphed loops ("scan", "while": the prefill and one decode step as
  CUDA graphs, the state written in place into the cache's leaves) give
  the eager loop's tokens and last logits bit for bit.
* A slot row of the scheduler's decode step (n_slots 4) keeps the bits it
  has at B = 1: each request equals its own ``generate`` at B = 1, and a
  decode step of 4 rows gives each row the logits of the same row alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler

ARCHS = ("zamba2-7b", "rwkv6-3b")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_PARAMS: dict = {}


def _arch_params(arch_id: str, dev):
    if arch_id not in _PARAMS:
        arch = get_arch(arch_id)
        arch = dataclasses.replace(arch, cfg=arch.cfg.replace(n_layers=2,
                                                              param_dtype="bfloat16"))
        _PARAMS[arch_id] = arch, arch.init_params(torch.Generator(device=dev).manual_seed(0),
                                                  dev)
    return _PARAMS[arch_id]


def _prompts(dev, b: int, s: int, vocab: int) -> torch.Tensor:
    return torch.randint(0, vocab, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ARCHS)
def test_cuda_graph_loops_equal_the_eager_loop(cuda, arch_id):
    arch, params = _arch_params(arch_id, cuda)
    prompts = _prompts(cuda, 4, 16, arch.cfg.vocab_size)
    out = {}
    for loop in ("python", "scan", "while"):
        eng = ServeEngine(arch, params, ServeConfig(max_len=32, loop=loop), device=cuda)
        tokens = eng.generate(prompts, 8)
        out[loop] = tokens, eng.last_logits[4].clone(), dict(eng.trace_counts)
    for loop in ("scan", "while"):
        assert torch.equal(out[loop][0], out["python"][0]), loop
        assert torch.equal(out[loop][1], out["python"][1]), loop
        assert out[loop][2]["prefill"] == 1 and out[loop][2]["decode"] == 1
    assert out["python"][2]["prefill"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ARCHS)
def test_cuda_slot_row_equals_batch_one(cuda, arch_id):
    arch, params = _arch_params(arch_id, cuda)
    eng = ServeEngine(arch, params, ServeConfig(max_len=48), device=cuda)
    vocab = arch.cfg.vocab_size
    # one decode step of 4 rows against each row alone, same prompt length
    prompts = _prompts(cuda, 4, 12, vocab)
    eng.generate(prompts, 2)
    four = eng.last_logits[4].clone()
    for i in range(4):
        eng.generate(prompts[i:i + 1], 2)
        assert torch.equal(eng.last_logits[1][0], four[i]), i
    # the scheduler's slots (4, ragged requests) against generate at B = 1
    rng = np.random.default_rng(0)
    lens, news = [5, 17, 9, 12, 3, 20], [9, 4, 12, 7, 10, 6]
    reqs = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    want = [eng.generate(torch.from_numpy(p).to(cuda)[None].long(), n)[0].tolist()
            for p, n in zip(reqs, news)]
    for mode in ("scan", "while"):
        sched = ContinuousScheduler(eng, n_slots=4, segment_len=4, segment_mode=mode)
        handles = [sched.submit(p, n) for p, n in zip(reqs, news)]
        sched.run()
        assert [h.tokens for h in handles] == want, mode
    assert eng.slot_eager_runs == 0

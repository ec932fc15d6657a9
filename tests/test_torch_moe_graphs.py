"""The MoE block (``models/moe.py``) captured as a CUDA graph.  No JAX: the
tests marked ``cuda`` run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_moe_graphs.py``
and skip without a card.

On the card, one moonshot-v1-16b-a3b MoE layer at its published width (64
experts, top-6, d_model 2048, d_ff 1408, bf16 weights): a decode step's
block (4 tokens) and a prefill's (4 × 64 tokens, capacity factor 1.25, so
tokens drop) captured in a CUDA graph; a replay equals the eager call bit
for bit, and two replays equal each other (the dispatch has no
data-dependent shape and the combine no atomics).
"""
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import moe as tM


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def layer(cuda):
    cfg = get_config("moonshot-v1-16b-a3b").replace(param_dtype="bfloat16")
    return cfg, tM.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)


def _graphed(fn, x: torch.Tensor):
    """fn(x) captured once (after a warm-up on a side stream); returns the
    graph and its output buffer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x)
    return graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, 1), (4, 64)], ids=["decode", "prefill"])
def test_cuda_moe_graph_replay_equals_eager(cuda, layer, b, s):
    cfg, p = layer
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        want = tM.moe_apply(p, cfg, x)
        graph, out = _graphed(lambda xx: tM.moe_apply(p, cfg, xx), x)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)
    if s > 1:  # capacity ceil(64·6/64·1.25) = 8 a row: some tokens drop
        _, experts = tM._router(p, cfg, x)
        assert not tM._slots(experts, cfg.n_experts, tM.capacity(cfg, s))[1].all()


@pytest.mark.cuda
def test_cuda_moe_graph_replays_are_bitwise_equal(cuda, layer):
    cfg, p = layer
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        graph, out = _graphed(lambda xx: tM.moe_apply(p, cfg, xx), x)
        graph.replay()
        first = out.clone()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tM.moe_apply(p, cfg, x))

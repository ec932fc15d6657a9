"""Training on the card: the weight gradient of a dense product at the
training M against fp64, and two runs of the train step giving equal bits.
No JAX: run on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py``;
both tests skip without a card.
"""
import dataclasses

import pytest
import torch

from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models.registry import get_arch
from repro_torch.utils.rows import DENSE_CUDA_ROWS, in_row_chunks
from repro_torch.utils.tree import named_leaves

# dW = x^T @ dy over M = 4096 rows (one microbatch of S = 4096) at
# tinyllama-1.1b's wi (2048 × 5632), bf16 x and dy: one product accumulates
# in fp32 inside cuBLAS and rounds its bf16 output (one rounding is ≤ 2**-9
# of an entry; the bound allows two); the serving path's 64-row chunks add
# 64 bf16 partial gradients in bf16.
DW_BOUND = 2**-8  # of max |dW|, against the fp64 product


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dw_error(fn, x, dy, w0, want) -> float:
    w = w0.clone().requires_grad_()
    (fn(w, x).float() * dy.float()).sum().backward()
    return ((w.grad.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
def test_cuda_training_dw_holds_the_fp64_bound():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    m, k, n = 4096, 2048, 5632
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    w0 = torch.randn((k, n), generator=g, device=dev) * k**-0.5
    want = x.double().T @ dy.double()
    def chunked(w, xx):  # the serving path: one cast, then 64-row products
        wb = w.to(torch.bfloat16)
        return in_row_chunks(lambda c: c @ wb, xx, DENSE_CUDA_ROWS)

    one = _dw_error(lambda w, xx: layers.dense_apply({"kernel": w}, xx), x, dy, w0, want)
    many = _dw_error(chunked, x, dy, w0, want)
    assert one <= DW_BOUND, one
    assert many > DW_BOUND, many  # the bound tells the two paths apart


@pytest.mark.cuda
def test_cuda_two_runs_of_the_train_step_give_equal_bits():
    """tinyllama-1.1b at full width, 2 layers, S = 1024, two microbatches
    through the int8 accumulator, block sparsity refreshed every step: two
    steps, twice from the same state, every leaf bit for bit."""
    _card()
    arch = get_arch("tinyllama-1.1b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.replace(n_layers=2))
    args = train.parse_args(["--seq", "1024", "--batch", "2", "--grad-accum", "2",
                             "--compressed-accum", "--sparsity", "0.75", "--steps", "4",
                             "--mask-update-every", "1", "--no-resume"])
    ends = []
    for _ in range(2):
        run = train.build_trainer(args, arch)
        state = run.state
        for i in range(2):
            state, m = run.step(state, run.data(i))
        assert torch.isfinite(m["loss"])
        ends.append(state)
    for (name, a), (_, b) in zip(named_leaves(ends[0]), named_leaves(ends[1])):
        assert torch.equal(a, b), name

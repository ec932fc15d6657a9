"""Gradient compression: the int8 microbatch accumulator.

The port of ``repro.train.grad_compression``'s single-device half.
``add_compressed`` quantizes each microbatch's gradient to int8 (one absmax
scale per leaf) before it is added, in fp32, to the accumulator, so what
any one microbatch contributes carries at most one quantization step of
noise.  ``compressed_psum`` is the int8 all-reduce over a process group:
the reference's ``shard_map`` body, with ``torch.distributed`` collectives.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 values, fp32 0-dim scale max|x| / 127 + 1e-12); rounds
    half to even, as ``jnp.round``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def add_compressed(gacc: Any, g: Any, n_accum: int) -> Any:
    """gacc + dequant(quant(g)) / n_accum, leaf by leaf (new tensors)."""

    def one(a, gi):
        q, s = _quantize_int8(gi.float())
        return a + _dequantize(q, s) / n_accum

    return tree_map(one, gacc, g)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce: quantize, sum the ints, dequantize with the max scale.

    Every rank quantizes with its own scale, the scales are max-reduced so
    dequantization is conservative, every rank requantizes against the
    shared scale so the integer sum is coherent, the int32 values are
    summed (as int32, the reference's psum type) and rescaled.  Returns
    fp32, the same on every rank."""
    _, s = _quantize_int8(x.float())
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    q_shared = torch.clamp(torch.round(x.float() / s_max), -127, 127).to(torch.int32)
    dist.all_reduce(q_shared, op=dist.ReduceOp.SUM, group=group)
    return q_shared.float() * s_max


def compression_error(g: Any) -> Any:
    """Per-leaf relative int8 round-trip error (diagnostics, tests)."""

    def one(x):
        q, s = _quantize_int8(x.float())
        return torch.linalg.vector_norm(_dequantize(q, s) - x) / (
            torch.linalg.vector_norm(x) + 1e-12)

    return tree_map(one, g)

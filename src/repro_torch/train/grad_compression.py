"""Gradient compression: the int8 microbatch accumulator.

The port of ``repro.train.grad_compression``'s single-device half.
``add_compressed`` quantizes each microbatch's gradient to int8 (one absmax
scale per leaf) before it is added, in fp32, to the accumulator, so what
any one microbatch contributes carries at most one quantization step of
noise.  ``compressed_psum`` (the int8 all-reduce) waits for the mesh slice.
"""
from __future__ import annotations

from typing import Any

import torch

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


def compression_error(g: Any) -> Any:
    """Per-leaf relative int8 round-trip error (diagnostics, tests)."""

    def one(x):
        q, s = _quantize_int8(x.float())
        return torch.linalg.vector_norm(_dequantize(q, s) - x) / (
            torch.linalg.vector_norm(x) + 1e-12)

    return tree_map(one, g)

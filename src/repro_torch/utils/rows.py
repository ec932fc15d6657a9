"""Products whose rows do not depend on how many rows come with them.

A speculative-verify window (k + 1 rows per sequence) must give each row the
bits a one-row decode step gives it, and a decode step of B rows the bits
of the same rows in any other batch.  Two library products break that:

* PyTorch's CPU ``x @ W`` (and the ``einsum`` of the kernels' plain
  versions) takes another route at M = 1 than at M ≥ 2 (fp32: 51–207 of
  the entries of a row differ at tinyllama's reduced shapes); M = 2, 4, 7,
  8 and 12 agree with each other there.
* cuBLAS picks its kernel by M: at 5632×2048 in bf16 a row at M = 4 and
  the same row at M = 8 differ by one bf16 ulp.

``at_least_rows`` runs a product with x padded by zero rows up to a floor
and keeps the first M rows: ``CPU_ROWS`` = 2 for the plain versions,
``DENSE_CUDA_ROWS`` = 64 for the dense bf16 path on the card, so every
decode step (B rows) and verify window (B·(k + 1) rows) below 64 rows runs
one cuBLAS shape.  Past the floor cuBLAS picks its kernel by M again: at
5120×1024 and 14336×5120 (mistral-nemo-12b) rows of windows of 68, 80 and
192 differ from the same rows at M ≤ 64.  ``in_row_chunks`` therefore runs
a product of any M as products of exactly ``rows`` rows, the last chunk
padded with zero rows, so every row is computed in the decode step's shape.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

CPU_ROWS = 2
DENSE_CUDA_ROWS = 64


def at_least_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """fn(x) for x (M, …), computed on x padded with zero rows to ``rows``
    when M is below it; the padding's rows are dropped."""
    m = x.shape[0]
    if m >= rows:
        return fn(x)
    return fn(F.pad(x, (0, 0) * (x.dim() - 1) + (0, rows - m)))[:m]


def in_row_chunks(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """fn(x) for x (M, …), computed as fn over chunks of exactly ``rows``
    rows (the last padded with zero rows, whose outputs are dropped), so a
    row's bits do not depend on M at any M.  A plain loop of products: one
    batched call over (M / rows, rows, K) may let the library pick another
    kernel."""
    m = x.shape[0]
    if m <= rows:
        return at_least_rows(fn, x, rows)
    x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, -m % rows))
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])[:m]


def plain_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A kernel's plain version over x (M, K): at least ``CPU_ROWS`` rows."""
    return at_least_rows(fn, x, CPU_ROWS)

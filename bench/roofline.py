"""The yardstick's arithmetic that any family uses: the card's peaks, and
the operations, bytes and bound of one int8 block-sparse launch.  What a
model's served step solves is its family's (``bench/families/``).

Counts come from the configuration's shapes alone, never from the program's
tensors or kernels, so a later change that fuses, splits or renames kernels
leaves them as they are.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, no structured sparsity),
the same figures as ``src/repro_torch/roofline/hw.py`` (``H100``) and
``chip_smoke.py``.  They hold at the card's full power limit (700 W); every
result line records the limit the card was set to.
"""
from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_HBM_BYTES_S = 3.35e12  # HBM3
KV_BYTES = 2  # bf16 cache


@dataclasses.dataclass(frozen=True)
class Projection:
    """One int8 block-sparse projection x (M, k) @ W (k, n), ``kept`` of its
    (k / bk) K-blocks kept in each of its (n / bn) column blocks."""

    name: str
    k: int
    n: int
    bk: int
    bn: int
    kept: int

    @property
    def int8_bytes(self) -> int:
        return (self.n // self.bn) * self.kept * self.bk * self.bn

    @property
    def blocks(self) -> int:
        return (self.n // self.bn) * self.kept


def kept_blocks(k: int, bk: int, sparsity: float) -> int:
    """K-blocks kept per column block under balanced block pruning."""
    return max(int(round((k // bk) * (1.0 - sparsity))), 1)


def int8_launch(p: Projection, m: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 launch at M = m rows as launched:
    2·M·kept weights; kept int8 values, fp32 scales and int32 indices, x
    (bf16) read once and y (fp32) written once."""
    ops = 2.0 * m * p.int8_bytes
    nbytes = p.int8_bytes + 8 * p.blocks + 2 * m * p.k + 4 * m * p.n
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)

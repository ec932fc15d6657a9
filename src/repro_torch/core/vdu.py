"""C4: vector-dot-product-unit (VDU) decomposition and the photonic
fidelity model.

The port of ``repro.core.vdu``.  The SONIC optical core is an array of VDUs:
N conv-VDUs computing n-wide dot products and K FC-VDUs computing m-wide
ones (§IV.C, best configuration (n, m, N, K) = (5, 50, 50, 10)).  Long
vectors are cut into n- or m-element chunks, each one optical pass (VCSEL →
MR bank → broadband-BN-MR → photodetector), and partial sums are added
electronically.

* ``decompose_matvec``: how many VDU passes a compressed workload costs
  (the photonic model prices these).
* ``photonic_forward``: a fidelity model: activations quantized to the DAC
  resolution, weights to their cluster centroids, optional MR / PD noise,
  and the dot product as the optical pipeline computes it.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class VDUConfig:
    """(n, m, N, K) from §IV.C plus the DAC resolutions of §V.A."""

    n: int = 5  # conv-VDU dot-product width
    m: int = 50  # FC-VDU dot-product width
    N: int = 50  # number of conv VDUs
    K: int = 10  # number of FC VDUs
    weight_bits: int = 6  # 6-bit DAC (≤ 64 clusters)
    activation_bits: int = 16  # 16-bit DAC

    def conv_passes(self, vec_len: int, n_products: int) -> int:
        """Optical passes for ``n_products`` dot products of length vec_len."""
        chunks = math.ceil(max(vec_len, 1) / self.n)
        return math.ceil(n_products * chunks / self.N)

    def fc_passes(self, vec_len: int, n_products: int) -> int:
        chunks = math.ceil(max(vec_len, 1) / self.m)
        return math.ceil(n_products * chunks / self.K)


def decompose_matvec(d_out: int, d_in: int, width: int, units: int) -> tuple[int, int]:
    """(chunks_per_row, sequential_passes) for a d_out × d_in matvec on
    ``units`` VDUs of dot-width ``width``."""
    chunks = math.ceil(max(d_in, 1) / width)
    passes = math.ceil(d_out * chunks / max(units, 1))
    return chunks, passes


def quantize_uniform(x: torch.Tensor, bits: int,
                     x_max: torch.Tensor | float | None = None) -> torch.Tensor:
    """Symmetric uniform quantization to ``bits`` levels (the DAC model);
    rounds half to even, as the reference does."""
    if x_max is None:
        x_max = x.abs().max() + 1e-12
    levels = 2 ** (bits - 1) - 1
    scale = x_max / levels
    return torch.round(x / scale).clamp(-levels, levels) * scale


def photonic_forward(
    w: torch.Tensor,
    x: torch.Tensor,
    config: VDUConfig,
    codebook: torch.Tensor | None = None,
    noise_std: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Fidelity model of one VDU-array matvec: W @ x under photonic limits.

    * weights: snapped to the nearest centroid of ``codebook`` if given (an
      MR tunes to one of C levels, §III.B; the first of equally near
      centroids), else uniform-quantized to ``weight_bits``;
    * activations: uniform-quantized to ``activation_bits`` (VCSEL DAC);
    * ``noise_std`` > 0: multiplicative Gaussian noise on every product (MR
      tuning / PD shot noise), drawn from ``generator`` (which takes the
      place of the reference's PRNG key and gives other draws);
    * accumulation is exact (the photodetector integrates; partial sums are
      digital)."""
    if codebook is not None:
        flat = w.reshape(-1)
        idx = torch.argmin((flat[:, None] - codebook[None, :]).abs(), dim=1)
        wq = codebook[idx].reshape(w.shape)
    else:
        wq = quantize_uniform(w, config.weight_bits)
    xq = quantize_uniform(x, config.activation_bits)
    prod = wq * xq  # one wavelength per (row, chunk-lane) product
    if noise_std > 0.0:
        if generator is None:
            raise ValueError("noise_std > 0 requires a torch.Generator")
        noise = torch.randn(prod.shape, generator=generator, device=prod.device,
                            dtype=prod.dtype)
        prod = prod * (1.0 + noise_std * noise)
    return prod.sum(dim=-1)

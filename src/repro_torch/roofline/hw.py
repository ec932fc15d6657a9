"""Target hardware constants for the analytic serving models.

The port's copy of ``repro.roofline.hw`` (``HWTarget`` and ``TPU_V5E``, as
the reference has them), plus the card the port serves on: ``H100``, the
port's default target.  Its constants are NVIDIA's H100 SXM5 datasheet
figures: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB
of HBM, and NVLink 4 at 900 GB/s over 18 links (50 GB/s a link).  They are
the same peak rates ``chip_smoke.py`` computes its kernel bounds with.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWTarget:
    name: str
    peak_flops_bf16: float  # FLOP/s per chip
    hbm_bw: float  # B/s per chip
    ici_bw: float  # B/s per link
    hbm_bytes: float  # capacity per chip


TPU_V5E = HWTarget(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
)

# NVIDIA H100 SXM5 datasheet (dense bf16 tensor-core peak, HBM3 rate and
# capacity; NVLink 4: 900 GB/s over 18 links)
H100 = HWTarget(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=50e9,
    hbm_bytes=80e9,
)

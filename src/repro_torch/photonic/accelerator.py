"""SONIC accelerator analytical model (§IV architecture, §V methodology).

The port's copy of ``repro.photonic.accelerator`` (pure Python, unchanged).

The optical core is N conv-VDUs (n-wide) + K fc-VDUs (m-wide).  A workload
(list of LayerWork) is decomposed into VDU passes (§IV.C); each pass is one
optical traversal VCSEL→MUX→MR-bank→BN-MR→photodetector.

Timing model (explicit assumptions — the paper publishes only Table 2 and the
relative results, so every rate below is stated, not implied):

* streaming pass (weights resident): initiation interval
  t_stream = max(activation-DAC, VCSEL, PD, ADC/adc_interleave).
  VDUs carry small ADC arrays (``adc_interleave``-way) because a single
  Table-2 ADC (14 ns) would throttle the sub-ns optical datapath.
* weight reprogram: t_retune = max(EO tuning 20 ns, weight-DAC).
  CONV layers are weight-stationary — one retune per kernel-chunk assignment,
  amortized over ``reuse`` output pixels (this is *why* the paper separates
  conv- and fc-VDUs and why m ≫ n: FC passes pay the retune every time).
* TO tuning handles only rare large shifts; with hybrid EO/TO + TED (§IV.A)
  it is off the critical path and enters as a duty-cycled power term.

Power model: per active lane — weight DAC (6-bit post-clustering / 16-bit
unclustered), activation DAC (16-bit), VCSEL, MR tuning; per VDU — PD + ADC
array.  §IV.B power gating: a lane whose sparse-vector element is zero keeps
its VCSEL + activation DAC dark → lane activity factor (1 − residual
sparsity).  Utilization-weighted average over layer steps + fixed electronic
control overhead.

EPB: E_frame / Σ task_bits, task_bits = dense-equivalent MACs × 32 — one
platform-neutral denominator shared with every baseline model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.photonic.devices import (
    AVG_EO_SHIFT_NM,
    DEVICES,
    ELECTRONIC_CTRL_W,
    TED_TO_DUTY,
)
from repro_torch.photonic.mapper import LayerWork


@dataclasses.dataclass(frozen=True)
class SonicHWConfig:
    """(n, m, N, K) — paper's best config (5, 50, 50, 10) — plus switches that
    turn SONIC's optimizations off (used to model dense photonic baselines)."""

    n: int = 5
    m: int = 50
    N: int = 50
    K: int = 10
    weight_bits: int = 6  # 6 ⇒ clustered (C ≤ 64); 16 ⇒ unclustered
    adc_bits: int = 16
    adc_interleave: int = 6  # ADC array size per VDU
    sparsity_gating: bool = True  # VCSEL/DAC power gating (§IV.B)
    compression: bool = True  # dataflow compression (§III.C)
    op_expansion: float = 1.0  # datapath-induced extra ops (LightBulb binary)
    epb_bits_per_mac: int | None = None  # default: weight_bits + 16 (acts)
    name: str = "SONIC"


@dataclasses.dataclass(frozen=True)
class AcceleratorReport:
    name: str
    fps: float
    power_w: float
    epb: float  # J / task bit

    @property
    def fps_per_w(self) -> float:
        return self.fps / self.power_w


class SonicAccelerator:
    def __init__(self, hw: SonicHWConfig | None = None):
        self.hw = hw or SonicHWConfig()

    # -- timing ---------------------------------------------------------------
    @property
    def t_stream(self) -> float:
        d = DEVICES
        return max(
            d["dac16"].latency_s,
            d["vcsel"].latency_s,
            d["photodetector"].latency_s,
            d["adc16"].latency_s / self.hw.adc_interleave,
        )

    @property
    def t_retune(self) -> float:
        d = DEVICES
        wdac = "dac6" if self.hw.weight_bits <= 8 else "dac16"
        return max(d["eo_tuning"].latency_s, d[wdac].latency_s)

    def _geometry(self, w: LayerWork) -> tuple[int, int, int]:
        """(lanes, units, vec_len_effective) for this layer."""
        hw = self.hw
        if w.kind == "conv":
            lanes, units = hw.n, hw.N
        else:
            lanes, units = hw.m, hw.K
        if hw.compression:
            vlen = w.vec_len
        else:  # dense baseline processes the uncompressed vector
            vlen = max(w.dense_macs_equiv // max(w.n_products, 1), 1)
        vlen = int(math.ceil(vlen * hw.op_expansion))
        return lanes, units, vlen

    def layer_passes(self, w: LayerWork) -> tuple[int, int]:
        """(sequential streaming passes, sequential retunes) per unit."""
        lanes, units, vlen = self._geometry(w)
        chunks = math.ceil(vlen / lanes)
        passes = math.ceil(w.n_products * chunks / units)
        retunes = math.ceil(passes / max(w.reuse, 1))
        return passes, retunes

    def layer_time(self, w: LayerWork) -> float:
        passes, retunes = self.layer_passes(w)
        return passes * self.t_stream + retunes * self.t_retune

    def frame_latency(self, work: Sequence[LayerWork]) -> float:
        # layers run sequentially (data dependence); passes pipeline inside
        return sum(self.layer_time(w) for w in work)

    # -- power ------------------------------------------------------------------
    def _vdu_power(self, lanes: int, active_frac: float) -> float:
        d, hw = DEVICES, self.hw
        wdac = d["dac6"].power_w if hw.weight_bits <= 8 else d["dac16"].power_w
        adac = d["dac16"].power_w
        tune = d["eo_tuning"].power_w * AVG_EO_SHIFT_NM + (
            d["to_tuning"].power_w * TED_TO_DUTY
        )
        if not hw.sparsity_gating:
            active_frac = 1.0
        gated = d["vcsel"].power_w + adac  # dark lane ⇒ VCSEL + its DAC off
        lane = wdac + tune + gated * active_frac
        adc = d["adc16"].power_w * (hw.adc_bits / 16.0) * hw.adc_interleave
        return lanes * lane + d["photodetector"].power_w + adc

    def power(self, work: Sequence[LayerWork]) -> float:
        """Time-weighted average chip power over a frame."""
        total_t = self.frame_latency(work) or 1e-12
        acc = 0.0
        for w in work:
            lanes, units, _ = self._geometry(w)
            residual = w.weight_sparsity if w.kind == "fc" else w.act_sparsity
            acc += self.layer_time(w) * units * self._vdu_power(
                lanes, 1.0 - residual
            )
        return acc / total_t + ELECTRONIC_CTRL_W

    # -- headline metrics ----------------------------------------------------
    def evaluate(self, work: Sequence[LayerWork]) -> AcceleratorReport:
        t = self.frame_latency(work)
        p = self.power(work)
        # EPB denominator: dense-equivalent MACs × this platform's datapath
        # bits per MAC (SONIC's clustering ⇒ 6+16; unclustered photonic and
        # electronic datapaths ⇒ 16+16).  This is why the paper's EPB ratios
        # exceed its FPS/W ratios: fewer bits moved per delivered MAC.
        bpm = self.hw.epb_bits_per_mac or (self.hw.weight_bits + 16)
        bits = sum(w.dense_macs_equiv for w in work) * bpm or 1
        return AcceleratorReport(
            name=self.hw.name, fps=1.0 / t, power_w=p, epb=t * p / bits
        )

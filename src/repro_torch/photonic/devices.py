"""Device parameters — paper Table 2, verbatim (the port's copy of
``repro.photonic.devices``).

| Device             | Latency  | Power        |
| EO tuning   [13]   | 20 ns    | 4 µW/nm      |
| TO tuning   [14]   | 4 µs     | 27.5 mW/FSR  |
| VCSEL       [18]   | 0.07 ns  | 1.3 mW       |
| Photodetector [19] | 5.8 ps   | 2.8 mW       |
| DAC (16 bit) [20]  | 0.33 ns  | 40 mW        |
| DAC (6 bit)  [21]  | 0.25 ns  | 3 mW         |
| ADC (16 bit) [22]  | 14 ns    | 62 mW        |
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    latency_s: float
    power_w: float
    note: str = ""


DEVICES: dict[str, DeviceParams] = {
    "eo_tuning": DeviceParams(20e-9, 4e-6, "power is per nm of resonance shift"),
    "to_tuning": DeviceParams(4e-6, 27.5e-3, "power is per FSR; TED-reduced in SONIC"),
    "vcsel": DeviceParams(0.07e-9, 1.3e-3),
    "photodetector": DeviceParams(5.8e-12, 2.8e-3),
    "dac16": DeviceParams(0.33e-9, 40e-3),
    "dac6": DeviceParams(0.25e-9, 3e-3),
    "adc16": DeviceParams(14e-9, 62e-3),
}

# auxiliary modelling constants (explicit, not from Table 2)
AVG_EO_SHIFT_NM = 1.0  # mean |Δλ_MR| per weight reprogram
TED_TO_DUTY = 0.10  # fraction of TO power after thermal-eigenmode decomposition
ELECTRONIC_CTRL_W = 1.0  # buffers/control/post-processing overhead per chip

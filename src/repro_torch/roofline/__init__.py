"""Analytic serving cost models, the knob autotuner and the drain predictor
(the port of ``repro.roofline``'s serving half)."""
from repro_torch.roofline.analytic import (StepCost, decode_step_cost, prefill_chunk_cost,
                                           spec_verify_cost, step_time)
from repro_torch.roofline.autotune import (AutotuneResult, DrainPredictor, HostOverheads,
                                           KnobConfig, WorkloadSpec, autotune,
                                           default_candidates, predict)
from repro_torch.roofline.hw import H100, TPU_V5E, HWTarget

__all__ = [
    "AutotuneResult",
    "DrainPredictor",
    "H100",
    "HWTarget",
    "HostOverheads",
    "KnobConfig",
    "StepCost",
    "TPU_V5E",
    "WorkloadSpec",
    "autotune",
    "decode_step_cost",
    "default_candidates",
    "predict",
    "prefill_chunk_cost",
    "spec_verify_cost",
    "step_time",
]

"""Analytic cost models (whole cells and serving launches), the knob
autotuner, the drain predictor and the dry run's roofline analysis (the
port of ``repro.roofline``)."""
from repro_torch.roofline.analytic import (CellCost, StepCost, analytic_cost,
                                           decode_step_cost, prefill_chunk_cost,
                                           spec_verify_cost, step_time)
from repro_torch.roofline.autotune import (AutotuneResult, DrainPredictor, HostOverheads,
                                           KnobConfig, WorkloadSpec, autotune,
                                           default_candidates, predict)
from repro_torch.roofline.hw import H100, TPU_V5E, HWTarget

__all__ = [
    "AutotuneResult",
    "CellCost",
    "DrainPredictor",
    "H100",
    "HWTarget",
    "HostOverheads",
    "KnobConfig",
    "StepCost",
    "TPU_V5E",
    "WorkloadSpec",
    "analytic_cost",
    "autotune",
    "decode_step_cost",
    "default_candidates",
    "predict",
    "prefill_chunk_cost",
    "spec_verify_cost",
    "step_time",
]

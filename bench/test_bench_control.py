"""The control, the reference in float8 e4m3 put in the program's place,
comes out not correct through the harness's own ``correct``, while the
program's gap in the same run is under the limit: on the CPU at the tiny
cells' size (their limit set from CPU readings), and on the card at the same
size (``-m cuda``).  At each cell's own size on the card,
``bench/calibrate.py`` gives the same verdict for a dozen seeds (PERF.md)."""
import pytest
import torch

from bench.testing import SEED, run_tiny


def _readings(cell, device, seed):
    run = run_tiny(cell, seed=seed, control=True, device=device)
    assert run["result"]["correct"] is False
    gap = run["result"]["checks"]["logit_gap"]
    assert gap["value"] == run["info"]["control_gap"]
    return {"value": run["info"]["program_gap"], "limit": gap["limit"]}, gap["value"]


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_control_fails_where_the_program_passes(seed):
    # the open loop: every due request is served and drained, so what is
    # compared depends on the seed alone, not on how fast the CPU runs
    gap, control = _readings("tiny-open", "cpu", seed)
    assert gap["value"] <= gap["limit"] < control


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_on_the_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gap, control = _readings("tiny-open", "cuda", seed)
    assert gap["value"] <= gap["limit"] < control

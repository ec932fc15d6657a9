"""Shared set-up of the benchmark's own tests: the tiny cells under
``testdata/``, run through the harness on the CPU (the harness's look for a
card is the command line's, which these skip)."""
from __future__ import annotations

import time

import torch

from bench import cells, harness

TESTDATA = cells.HERE / "testdata"
SEED = 2**31 + 11  # past 32 signed bits, as the driver's seeds are


def tiny(name: str = "tiny-open") -> cells.Cell:
    return cells.load(name, root=TESTDATA)


def run_tiny(name: str = "tiny-open", seed: int = SEED, seconds: float = 1.0,
             trace: bool = False, hook=None, control: bool = False,
             device: str = "cpu") -> dict:
    """One run of a tiny cell, on one CPU thread: its ops are too small to
    gain from more, and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(tiny(name), seed, seconds, trace, torch.device(device),
                                time.perf_counter(), hook=hook, control=control)
    finally:
        torch.set_num_threads(threads)

"""The one traffic generator: every mix is a data file under ``traffic/``.

A mix gives its prompt and answer lengths as clipped lognormals (a median, a
sigma and a range, each tied to its source in the mix's file).  A run of n
requests takes the same n lengths of each whatever the seed: the
distribution's quantiles at (i + ½) / n.  The seed draws the order they come
in (prompts and answers independently) and the token ids.  So every seed
serves the same work, in another order, and a seed cannot change how much
work a window holds.

An open loop (independent users) sends requests on a schedule whatever the
system does: ``rate_rps`` × the window's seconds arrivals, Poisson in the
order of their gaps (the n + 1 quantiles of an exponential, drawn into a
random order by the seed, so runs of close arrivals come as often as in a
Poisson process) and scaled to span the window.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (P,) int32 token ids
    max_new: int
    arrival: float | None = None  # open loop: seconds after the window opens


def stratified(spec: dict, n: int) -> np.ndarray:
    """n lengths, ascending: the clipped lognormal's quantiles at (i + ½) / n."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(lengths, spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(n: int) -> np.ndarray:
    """n gaps, ascending: the exponential's quantiles at (i + ½) / n, mean 1."""
    return -np.log1p(-(np.arange(n) + 0.5) / n)


def open_loop(mix: dict, rate: float, seconds: float, seed: int, vocab: int) -> list[Request]:
    """The requests due in a window of ``seconds`` at ``rate`` per second."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(rate * seconds)))
    prompts = rng.permutation(stratified(mix["prompt"], n))
    outputs = rng.permutation(stratified(mix["output"], n))
    gaps = rng.permutation(exp_gaps(n + 1))
    arrivals = np.cumsum(gaps)[:n] * seconds / gaps.sum()
    return [Request(rng.integers(0, vocab, int(p), dtype=np.int32), int(o), float(a))
            for p, o, a in zip(prompts, outputs, arrivals)]


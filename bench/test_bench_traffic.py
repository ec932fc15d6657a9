"""The traffic generator: the same seed gives the same requests; every seed
the same multiset of lengths and gaps, in another order, with arrivals as
clustered as a Poisson process's."""
import numpy as np
import pytest

from bench import traffic
from bench.testing import SEED, tiny


def _key(reqs):
    return [(r.prompt.tolist(), r.max_new, r.arrival) for r in reqs]


@pytest.mark.parametrize("mix", ["tiny_open", "chat", "reasoning"])
def test_open_loop_repeats_by_seed(mix):
    from bench.cells import HERE, _read
    root = HERE / "testdata" if mix.startswith("tiny") else HERE
    m = _read("traffic", mix, root)
    a = traffic.open_loop(m, 3.0, 20.0, SEED, 1000)
    b = traffic.open_loop(m, 3.0, 20.0, SEED, 1000)
    c = traffic.open_loop(m, 3.0, 20.0, SEED + 1, 1000)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    assert len(a) == len(c) == 60
    # the seed changes the order, not the work
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in c)
    arrivals = [r.arrival for r in a]
    assert arrivals == sorted(arrivals) and 0 < arrivals[0] and arrivals[-1] < 20.0
    for r in a:
        assert m["prompt"]["min"] <= len(r.prompt) <= m["prompt"]["max"]
        assert m["output"]["min"] <= r.max_new <= m["output"]["max"]
        assert r.prompt.dtype == np.int32 and 0 <= r.prompt.min() and r.prompt.max() < 1000


def test_stratified_lengths_follow_the_median():
    spec = {"median": 128, "sigma": 1.0, "min": 32, "max": 1024}
    lengths = traffic.stratified(spec, 101)
    assert int(np.median(lengths)) == 128
    assert lengths.min() >= 32 and lengths.max() == 1024
    assert np.all(np.diff(lengths) >= 0)


def test_open_loop_is_one_trace_rotated_by_seed():
    # the gaps are one multiset scaled to the window, in a seeded order
    mix = tiny().mix
    a = traffic.open_loop(mix, 5.0, 20.0, SEED, 100)
    b = traffic.open_loop(mix, 5.0, 20.0, SEED + 3, 100)
    ga, gb = (np.diff([0.0] + [r.arrival for r in x] + [20.0]) for x in (a, b))
    assert not np.allclose(ga, gb)
    want = traffic.exp_gaps(101) * 20.0 / traffic.exp_gaps(101).sum()
    assert np.sort(ga) == pytest.approx(want) and np.sort(gb) == pytest.approx(want)


def test_arrivals_cluster_as_a_poisson_process_does():
    # over many seeds: gaps uncorrelated with the next, and counts in one-
    # second bins as dispersed as a Poisson count's (variance = mean)
    mix = tiny().mix
    lag1, dispersion = [], []
    for k in range(40):
        t = np.array([r.arrival for r in traffic.open_loop(mix, 4.0, 50.0, SEED + k, 100)])
        g = np.diff(t)
        lag1.append(np.corrcoef(g[:-1], g[1:])[0, 1])
        counts = np.bincount(t.astype(int), minlength=50)
        dispersion.append(counts.var() / counts.mean())
    assert abs(np.mean(lag1)) < 0.05
    assert 0.8 < np.mean(dispersion) < 1.1

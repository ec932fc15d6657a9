"""The port's ``serve/sampling.py`` held against the JAX package's.

The reference draws with ``jax.random.categorical`` from a JAX key, the port
with ``torch.multinomial`` from a ``torch.Generator``, so parity covers what
the draw is made from: the filtered logits (top-k, top-p, temperature),
caught here as the reference hands them to ``categorical``, and the greedy
path.  The logits are spaced 0.37 apart, so no nucleus mass lies near the
threshold and fp32 cumsums of either package keep the same prefix.
``spec_accept`` is integer arithmetic: held exactly, on the five cases of
``tests/test_serve_spec.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as jsampling
from repro_torch.serve import sampling

V = 64


def _logits(rows=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(V) * 0.37 - 9.0 for _ in range(rows)]).astype(np.float32)


def _reference_filtered(monkeypatch, logits, temperature, top_k, top_p):
    """The logits the reference's ``sample_token`` draws from."""
    seen = {}

    def categorical(key, lf):
        seen["lf"] = np.asarray(lf)
        return jnp.zeros(lf.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jsampling.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k,
                           top_p)
    return seen["lf"]


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5, 0.05])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_filtered_logits_equal_reference(monkeypatch, temperature, top_k, top_p):
    """Top-k's k-th value threshold and the nucleus threshold keep the same
    columns as the reference, with the same fp32 values."""
    x = _logits()
    want = _reference_filtered(monkeypatch, x, temperature, top_k, top_p)
    got = sampling.filter_logits(torch.from_numpy(x), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any(axis=-1).all()  # the first column is always kept


def test_greedy_equals_reference_with_ties():
    x = _logits(4, seed=1)
    x[1, 7] = x[1, 40] = x[1].max() + 1.0  # a tie: the first index wins
    want = np.asarray(jsampling.sample_token(jnp.asarray(x), jax.random.PRNGKey(0)))
    got = sampling.sample_token(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 7


def test_top_p_restricts_support():
    """One dominant token (p ≈ 0.94): nucleus 0.5 keeps only it; top_p = 1
    leaves the distribution whole (``tests/test_serve_engine.py``)."""
    logits = torch.tensor([[4.0, 1.0, 0.5, -1.0]])
    gen = torch.Generator().manual_seed(0)
    toks = sampling.sample_token(logits.repeat(64, 1), 1.0, gen, top_p=0.5)
    assert set(toks.tolist()) == {0}
    toks = sampling.sample_token(logits.repeat(256, 1), 1.0, gen)
    assert len(set(toks.tolist())) > 1


def test_top_k_restricts_support_and_draws_follow_the_generator():
    x = torch.from_numpy(_logits(256, seed=2))
    kth = torch.topk(x, 3, dim=-1).values[:, -1:]

    def draw(seed):
        return sampling.sample_token(x, 2.0, torch.Generator().manual_seed(seed), top_k=3)

    a = draw(5)
    assert (x.gather(1, a[:, None]) >= kth).all()
    assert torch.equal(a, draw(5)) and not torch.equal(a, draw(6))


SPEC_CASES = [  # window, verify, live, pos, limit, eos → emitted, n_emit, last
    ([[5, 7, 9]], [[7, 8, 3]], [True], [10], [100], -1, [[7, 8, -1]], 2, 8),
    ([[5, 7, 8]], [[7, 8, 3]], [True], [10], [100], -1, [[7, 8, 3]], 3, 3),
    ([[5, 2, 8]], [[2, 8, 3]], [True], [10], [100], 2, [[2, -1, -1]], 1, 2),
    ([[5, 7, 8]], [[7, 8, 3]], [True], [10], [11], -1, [[7, -1, -1]], 1, 7),
    ([[5, 7, 8]], [[7, 8, 3]], [False], [10], [100], -1, [[-1, -1, -1]], 0, None),
]


@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=["longest_prefix", "full_window_bonus", "eos_cuts",
                              "budget_cuts", "masked_slot"])
def test_spec_accept_equals_reference(case):
    window, verify, live, pos, limit, eos, want_emit, want_n, want_last = case
    got = sampling.spec_accept(torch.tensor(window), torch.tensor(verify), torch.tensor(live),
                               torch.tensor(pos), torch.tensor(limit), eos)
    ref = jsampling.spec_accept(jnp.asarray(window, jnp.int32), jnp.asarray(verify, jnp.int32),
                                jnp.asarray(live), jnp.asarray(pos, jnp.int32),
                                jnp.asarray(limit, jnp.int32), eos)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].tolist() == want_emit and int(got[1][0]) == want_n
    if want_last is not None:
        assert int(got[2][0]) == want_last


def test_spec_accept_batch_equals_reference():
    """Random windows over a batch of 16 with mixed liveness, budgets and
    eos: the same emissions, counts and last tokens."""
    rng = np.random.default_rng(3)
    b, kp1 = 16, 5
    verify = rng.integers(0, 4, (b, kp1))
    window = np.concatenate([rng.integers(0, 4, (b, 1)),
                             np.where(rng.random((b, kp1 - 1)) < 0.7, verify[:, :-1],
                                      rng.integers(0, 4, (b, kp1 - 1)))], axis=1)
    live, pos = rng.random(b) < 0.8, rng.integers(0, 20, b)
    limit = pos + rng.integers(1, 7, b)
    got = sampling.spec_accept(*map(torch.from_numpy, (window, verify, live, pos, limit)), 3)
    ref = jsampling.spec_accept(jnp.asarray(window, jnp.int32), jnp.asarray(verify, jnp.int32),
                                jnp.asarray(live), jnp.asarray(pos, jnp.int32),
                                jnp.asarray(limit, jnp.int32), 3)
    n = np.asarray(ref[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), n)
    np.testing.assert_array_equal(got[2].numpy()[n > 0], np.asarray(ref[2])[n > 0])

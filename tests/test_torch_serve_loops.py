"""The port's three decode loops held against the JAX engine: equal greedy
tokens, with and without eos (the checklist of ``tests/test_serve_engine.py``).

Reduced tinyllama under ``weight_quant="int8"`` (block (16, 16), sparsity
0.5), fp32 compute on both sides, as ``tests/test_torch_engine.py`` holds
the port's default loop.  On the CPU every loop runs eagerly; the CUDA
graphs are held to the eager loop on the card (``tests/test_torch_graphs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_arch as jax_get_arch
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import SLOT_PROGRAMS, ServeConfig, ServeEngine

QUANT = dict(weight_quant="int8", weight_quant_sparsity=0.5, weight_quant_block=(16, 16))
B, S, NEW, MAX_LEN = 3, 8, 12, 32

NO_SLOT_RUNS = dict.fromkeys(SLOT_PROGRAMS, 0)  # generate runs no slot program


@pytest.fixture(scope="module")
def jax_side():
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.replace(compute_dtype="float32"))
    raw = jarch.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    want = {}
    for quant in (False, True):
        eng = JaxServeEngine(jarch, raw, MeshPlan(cache_quant_int8=quant),
                             JaxServeConfig(max_len=MAX_LEN, **QUANT))
        want[quant] = np.asarray(eng.generate(jnp.asarray(prompts), NEW))
    eos = int(want[False][0, 4])  # a token greedy decoding emits
    eng = JaxServeEngine(jarch, raw, MeshPlan(),
                         JaxServeConfig(max_len=MAX_LEN, eos_token=eos, **QUANT))
    want["eos"] = np.asarray(eng.generate(jnp.asarray(prompts), NEW))
    raw_t = params_from_jax(jax.tree_util.tree_map(np.array, raw), "cpu")
    return raw_t, prompts, want, eos


def _engine(raw_t, **kw):
    arch = get_arch("tinyllama-1.1b", reduced=True)
    arch = dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="float32"))
    quant = kw.pop("cache_quant_int8", False)
    return ServeEngine(arch, raw_t, ServeConfig(max_len=MAX_LEN, **QUANT, **kw), device="cpu",
                       cache_quant_int8=quant)


@pytest.mark.parametrize("loop", ["scan", "while", "python"])
def test_loops_give_jax_greedy_tokens(jax_side, loop):
    raw_t, prompts, want, _ = jax_side
    eng = _engine(raw_t, loop=loop)
    got = eng.generate(torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want[False])
    assert eng.call_counts == {"prefill": 1, "decode": NEW - 1, **NO_SLOT_RUNS}
    # the CPU captures nothing
    assert eng.trace_counts == {"prefill": 0, "decode": 0, **NO_SLOT_RUNS}


@pytest.mark.parametrize("loop", ["scan", "while", "python"])
def test_loops_pin_eos_as_jax(jax_side, loop):
    """Once a row emits eos every later token is eos; the first token is
    never pinned.  The same tokens as the JAX engine's."""
    raw_t, prompts, want, eos = jax_side
    got = _engine(raw_t, loop=loop, eos_token=eos).generate(torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want["eos"])
    hit = False
    for row in got.numpy():
        idx = np.where(row[1:] == eos)[0]
        if idx.size:
            hit = True
            assert (row[1 + idx[0]:] == eos).all(), (loop, row)
    assert hit, f"{loop}: eos never emitted, the test would be vacuous"


@pytest.mark.parametrize("loop", ["scan", "python"])
def test_int8_kv_loops_give_jax_greedy_tokens(jax_side, loop):
    """``cache_quant_int8`` (the reference's ``MeshPlan.cache_quant_int8``)."""
    raw_t, prompts, want, _ = jax_side
    got = _engine(raw_t, loop=loop, cache_quant_int8=True).generate(
        torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want[True])


def test_while_stops_early_and_matches_scan(jax_side):
    """One row, eos its second decoded token: "while" reads ``done`` after
    its first group of steps, stops there, and returns the scan loop's
    tokens (pinned to eos)."""
    raw_t, prompts, want, _ = jax_side
    eos = int(want[False][0, 2])
    n_new = 20
    one = torch.from_numpy(prompts[:1])
    scan = _engine(raw_t, loop="scan", eos_token=eos)
    wh = _engine(raw_t, loop="while", eos_token=eos)
    a, b = scan.generate(one, n_new), wh.generate(one, n_new)
    assert torch.equal(a, b) and (b[0, 2:] == eos).all()
    from repro_torch.serve.engine import WHILE_CHECK_STEPS

    assert scan.call_counts["decode"] == n_new - 1
    assert wh.call_counts["decode"] == WHILE_CHECK_STEPS < n_new - 1


def test_second_generate_repeats_and_counts(jax_side):
    raw_t, prompts, want, _ = jax_side
    eng = _engine(raw_t)
    a = eng.generate(torch.from_numpy(prompts), NEW)
    b = eng.generate(torch.from_numpy(prompts), NEW)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), want[False])
    assert eng.call_counts == {"prefill": 2, "decode": 2 * (NEW - 1), **NO_SLOT_RUNS}
    # one state per batch size, reused
    assert list(eng.last_logits) == [B]

"""The port's serving slice held against the JAX engine: equal greedy tokens.

Reduced tinyllama under ``weight_quant="int8"`` (block (16, 16), sparsity
0.5), fp32 compute on both sides: the reference's jnp fallback multiplies
in x's type, while the port's kernels accumulate in fp32, so under bf16 the
two would round apart and near-tied logits could pick other tokens.  One
test runs the default bf16 compute and bounds that gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.models.registry import get_arch as jax_get_arch
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine

QUANT = dict(weight_quant="int8", weight_quant_sparsity=0.5, weight_quant_block=(16, 16))
B, S, NEW, MAX_LEN = 2, 8, 8, 32


@pytest.fixture(scope="module")
def jax_side():
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.replace(compute_dtype="float32"))
    raw = jarch.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    return jarch, raw, prompts


def _jax_generate(jax_side, **kw):
    jarch, raw, prompts = jax_side
    eng = JaxServeEngine(jarch, raw, MeshPlan(), JaxServeConfig(max_len=MAX_LEN, **QUANT, **kw))
    return eng, np.asarray(eng.generate(jnp.asarray(prompts), NEW))


def _torch_arch():
    arch = get_arch("tinyllama-1.1b", reduced=True)
    return dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="float32"))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("eos", [False, True])
def test_greedy_tokens_equal_jax_engine(jax_side, eos):
    """On the JAX engine's converted int8 params; with ``eos_token`` set to a
    token the run emits, later tokens are pinned to it on both sides."""
    jeng, want = _jax_generate(jax_side)
    kw = {}
    if eos:
        eos_token = int(want[0, 2])
        kw = dict(eos_token=eos_token)
        jeng, want = _jax_generate(jax_side, **kw)
        first = int(np.argmax(want[0, 1:] == eos_token)) + 1
        assert (want[0, first:] == eos_token).all()
    eng = ServeEngine(_torch_arch(), params_from_jax(_to_numpy(jeng.params), "cpu"),
                      ServeConfig(max_len=MAX_LEN, **kw), device="cpu")
    got = eng.generate(torch.from_numpy(jax_side[2]), NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.call_counts == {"prefill": 1, "decode": NEW - 1}


def test_port_quantization_gives_jax_tokens(jax_side):
    """The port quantizes the raw converted weights itself and still
    generates the JAX engine's tokens."""
    _, want = _jax_generate(jax_side)
    eng = ServeEngine(_torch_arch(), params_from_jax(_to_numpy(jax_side[1]), "cpu"),
                      ServeConfig(max_len=MAX_LEN, **QUANT), device="cpu")
    assert "qvalues" in eng.params["lm_head"]
    np.testing.assert_array_equal(eng.generate(torch.from_numpy(jax_side[2]), NEW).numpy(),
                                  want)


def test_engine_raises_without_card(monkeypatch, jax_side):
    """The default device is the card; without one the engine raises rather
    than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from_jax(_to_numpy(jax_side[1]), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(_torch_arch(), params, ServeConfig(max_len=MAX_LEN))
    with pytest.raises(SystemExit):
        launch_serve.main(["--reduced"])


def test_launch_serve_cpu(capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--weight-quant", "int8",
                       "--weight-quant-sparsity", "0.5", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "4"])
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 2 and all(len(r.strip("[] ").split()) == 4 for r in rows)


def test_bf16_served_int8_path_stays_near_jax_engine():
    """The default ``compute_dtype="bfloat16"``.  The JAX model reaches its
    int8 weights through the jnp fallback, which casts the dequantized
    weights to bf16 and multiplies in bf16; the port follows the Pallas
    kernels (fp32 accumulation, then a cast to bf16) on the card and, through
    their plain versions, on the CPU.  Measured on this reduced model: prefill
    logits (|logit| ≤ 2.8) differ by at most 0.015625, one bf16 ulp at that
    size, so they are held to two ulps (2**-5); all 2 × 16 greedy tokens
    agree.  The test asserts the first token of each row and at least 3/4 of
    all of them, since a near tie may go either way."""
    new = 16
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    assert jarch.cfg.compute_dtype == "bfloat16"
    raw = jarch.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    jeng = JaxServeEngine(jarch, raw, MeshPlan(), JaxServeConfig(max_len=MAX_LEN, **QUANT))
    want = np.asarray(jeng.generate(jnp.asarray(prompts), new))
    jlog, _ = jT.forward(jeng.params, jarch.cfg, MeshPlan(), tokens=jnp.asarray(prompts),
                         cache=jT.init_cache(jarch.cfg, B, MAX_LEN, MeshPlan()))
    arch = get_arch("tinyllama-1.1b", reduced=True)
    eng = ServeEngine(arch, params_from_jax(_to_numpy(jeng.params), "cpu"),
                      ServeConfig(max_len=MAX_LEN), device="cpu")
    tlog, _ = arch.forward(eng.params, tokens=torch.from_numpy(prompts).long(),
                           cache=arch.init_cache(B, MAX_LEN, "cpu"))
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog.astype(jnp.float32)),
                               rtol=0, atol=2**-5)
    got = eng.generate(torch.from_numpy(prompts), new).numpy()
    assert (got[:, 0] == want[:, 0]).all()
    assert (got == want).mean() >= 0.75

"""Every family of the transformer held against the JAX package: the config
system, the registry's rules, the layers the families add (layernorm,
tanh-gelu, biases, M-RoPE, the tied head), each arch's forward and its
greedy tokens through the engine, and the cost models.

Reduced configs (2 layers, d_model 64), params made by the reference and
carried across with ``params_from_jax``, inputs from numpy seeds,
``compute_dtype="float32"`` on both sides (bf16 rounds at other places in
the two frameworks).  Tolerances: the layers within 2e-5 absolute (the
M-RoPE angles, hundreds of radians, within 2e-5 relative), a forward's
logits within 1e-4 (``tests/test_torch_model.py``'s bound: only the order
of fp32 reductions differs), greedy tokens equal, costs equal floats.  The MoE block itself is held in ``tests/test_torch_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.registry import get_arch as jax_get_arch
from repro.photonic import mapper as jmap
from repro.roofline import analytic as jax_analytic
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding.mesh import MeshPlan
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tL
from repro_torch.models import registry as tR
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_arch
from repro_torch.photonic import mapper as tmap
from repro_torch.roofline import analytic
from repro_torch.serve.engine import ServeConfig, ServeEngine

LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4
TRANSFORMER_ARCHS = ("hubert-xlarge", "moonshot-v1-16b-a3b", "grok-1-314b", "command-r-35b",
                     "mistral-nemo-12b", "tinyllama-1.1b", "internlm2-1.8b", "qwen2-vl-2b")
RECURRENT = ("zamba2-7b", "rwkv6-3b")  # tests/test_torch_{mamba2,rwkv}.py
DECODERS = tuple(a for a in TRANSFORMER_ARCHS if a not in ("hubert-xlarge", "tinyllama-1.1b"))
MOE = ("moonshot-v1-16b-a3b", "grok-1-314b")
QUANT = dict(weight_quant="int8", weight_quant_sparsity=0.5, weight_quant_block=(16, 16))
B, S, NEW, MAX_LEN = 2, 8, 6, 32


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


# ----------------------------------------------------------------- configs


def test_all_arch_ids_equal_the_reference():
    assert tbase.ALL_ARCH_IDS == jbase.ALL_ARCH_IDS
    assert set(TRANSFORMER_ARCHS) | set(RECURRENT) == set(tbase.ALL_ARCH_IDS)
    assert {n: dataclasses.asdict(s) for n, s in tbase.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch_id", jbase.ALL_ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch_id):
    """The full config and ``reduced_config``, every field and property."""
    for get in ("get_config", "reduced_config"):
        got, want = getattr(tbase, get)(arch_id), getattr(jbase, get)(arch_id)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get
        for prop in ("d_inner", "ssm_heads", "rwkv_heads", "is_attention_free",
                     "is_subquadratic"):
            assert getattr(got, prop) == getattr(want, prop), (get, prop)


# ---------------------------------------------------------------- registry


@pytest.mark.parametrize("arch_id", TRANSFORMER_ARCHS)
def test_registry_rules_equal_the_reference(arch_id):
    """The skip reasons (the reference's strings), input kind and the
    shape-support matrix."""
    for reduced in (True, False):
        arch, jarch = get_arch(arch_id, reduced), jax_get_arch(arch_id, reduced)
        for rule in ("chunked_prefill_skip_reason", "spec_decode_skip_reason",
                     "paged_skip_reason"):
            assert getattr(arch, rule)() == getattr(jarch, rule)(), rule
        assert arch.input_kind == jarch.input_kind
        for name, shape in tbase.SHAPES.items():
            assert arch.supports(shape) == jarch.supports(jbase.SHAPES[name]), name


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch_id", DECODERS)
def test_cache_contracts_hold_for_every_decoder(arch_id, reduced):
    """The four cache contracts on the ``meta`` device (shapes only, so the
    full configs cost no memory), fed as ``input_kind`` says: bf16 and
    int8 KV at the reduced config, bf16 KV at the full one (the int8 leaves
    differ only in dtype and the dropped Dh of the scales)."""
    arch = get_arch(arch_id, reduced)
    assert arch.supports_chunked_prefill and arch.supports_paged_kv
    for quant in (False, True) if reduced else (False,):
        tR.check_decode_cache_carry(arch, cache_quant_int8=quant)
        tR.check_slot_cache_contract(arch, cache_quant_int8=quant)
        tR.check_slots_cache_contract(arch, cache_quant_int8=quant)
        tR.check_paged_cache_contract(arch, cache_quant_int8=quant)


@pytest.mark.parametrize("arch_id", RECURRENT)
def test_registry_refuses_the_families_not_ported(arch_id):
    """Once refused, now served: ``get_arch`` dispatches the recurrent
    families to their modules as the reference's ``_module_for`` does, with
    the reference's rules (its skip reasons: no chunk-resume, speculation or
    paged KV), at the reduced and the full config."""
    for reduced in (True, False):
        arch, jarch = get_arch(arch_id, reduced), jax_get_arch(arch_id, reduced)
        assert arch.module.__name__.rsplit(".", 1)[1] == jarch.module.__name__.rsplit(".", 1)[1]
        assert arch.recurrent and arch.input_kind == jarch.input_kind
        for rule in ("chunked_prefill_skip_reason", "spec_decode_skip_reason",
                     "paged_skip_reason"):
            assert getattr(arch, rule)() == getattr(jarch, rule)() != "", rule
        for name, shape in tbase.SHAPES.items():
            assert arch.supports(shape) == jarch.supports(jbase.SHAPES[name]), name


# ------------------------------------------------------------------ layers


def test_layernorm_matches_jax():
    x = _rng(0).standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": _rng(1).standard_normal(64).astype(np.float32),
         "norm_bias": _rng(2).standard_normal(64).astype(np.float32)}
    want = jL.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tL.norm_apply(params_from_jax(p, "cpu"), torch.from_numpy(x))
    _close(got, want, LAYER_TOL)
    cfg = tbase.reduced_config("command-r-35b")
    assert set(tL.norm_init(cfg, "cpu")) == set(jL.norm_init(jbase.reduced_config(
        "command-r-35b")))


def test_tanh_gelu_mlp_matches_jax():
    """hubert's FFN: biases and ``jax.nn.gelu``'s tanh approximation."""
    jcfg = jbase.reduced_config("hubert-xlarge")
    p = jL.ffn_init(jax.random.PRNGKey(0), jcfg)
    p = jax.tree_util.tree_map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), a.shape), p)  # nonzero biases
    assert set(p) == {"wi", "wo"} and "bias" in p["wi"]
    x = _rng(0).standard_normal((2, 7, 64)).astype(np.float32) * 2
    want = jL.ffn_apply(p, jcfg, jnp.asarray(x))
    got = tL.ffn_apply(params_from_jax(_np(p), "cpu"), torch.from_numpy(x))
    _close(got, want, LAYER_TOL)
    v = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tL.gelu(torch.from_numpy(v)), jax.nn.gelu(jnp.asarray(v)), LAYER_TOL)


def test_dense_bias_matches_jax():
    p = {"kernel": _rng(0).standard_normal((64, 48)).astype(np.float32) / 8,
         "bias": _rng(1).standard_normal(48).astype(np.float32)}
    x = _rng(2).standard_normal((3, 4, 64)).astype(np.float32)
    want = jL.dense_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(tL.dense_apply(params_from_jax(p, "cpu"), torch.from_numpy(x)), want, LAYER_TOL)
    t = tL.dense_init(torch.Generator().manual_seed(0), 64, 48, torch.float32, "cpu",
                      (2,), bias=True)
    assert t["bias"].shape == (2, 48) and not t["bias"].any()


def test_mrope_angles_match_jax():
    """qwen2-vl's (t, h, w) position rows drive their sections of the
    frequency slots, at the reduced and the full config."""
    for cfg, jcfg in ((tbase.reduced_config("qwen2-vl-2b"), jbase.reduced_config("qwen2-vl-2b")),
                      (tbase.get_config("qwen2-vl-2b"), jbase.get_config("qwen2-vl-2b"))):
        pos = _rng(0).integers(0, 500, (2, 3, 9)).astype(np.int32)
        want = jL.rope_angles(jcfg, jnp.asarray(pos))
        got = tL.rope_angles(cfg, torch.from_numpy(pos).long())
        assert got.shape == (2, 9, cfg.head_dim // 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_TOL, atol=0)


def test_tied_head_matches_jax():
    """``tie_embeddings``: no LM head leaf; the logits are x @ embedding.T."""
    jcfg = jbase.reduced_config("internlm2-1.8b").replace(tie_embeddings=True,
                                                          compute_dtype="float32")
    params = jT.init_params(jcfg, jax.random.PRNGKey(0))
    assert "lm_head" not in params
    tcfg = tbase.reduced_config("internlm2-1.8b").replace(tie_embeddings=True,
                                                          compute_dtype="float32")
    assert "lm_head" not in tT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _rng(0).integers(0, 256, (2, 8)).astype(np.int32)
    want, _ = jT.forward(params, jcfg, MeshPlan(), tokens=jnp.asarray(tokens))
    got, _ = tT.forward(params_from_jax(_np(params), "cpu"), tcfg,
                        tokens=torch.from_numpy(tokens).long())
    _close(got, want, LOGIT_TOL)


# ----------------------------------------------------------------- forward


def _pair(arch_id: str, **replace):
    jarch = jax_get_arch(arch_id, reduced=True)
    jcfg = jarch.cfg.replace(compute_dtype="float32", **replace)
    tcfg = get_arch(arch_id, reduced=True).cfg.replace(compute_dtype="float32", **replace)
    params = jT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, params_from_jax(_np(params), "cpu")


def _inputs(arch_id: str, cfg, b: int, s: int, seed: int = 0) -> dict:
    """numpy inputs as the arch's ``input_kind`` says (M-RoPE rows differ)."""
    kind = get_arch(arch_id, reduced=True).input_kind
    if kind == "tokens":
        return {"tokens": _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out = {"embeds": _rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    if kind == "embeds+mrope":
        base = np.arange(s, dtype=np.int32)
        out["positions"] = np.stack([base, base // 2, base % 3])[None].repeat(b, 0)
    return out


def _torch_in(kw: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in kw.items()}


@pytest.mark.parametrize("arch_id", TRANSFORMER_ARCHS)
def test_forward_matches_jax(arch_id):
    """The whole forward on the arch's own inputs: without a cache (hubert's
    encoder is bidirectional); and for a decoder a prefill into a cache and
    two decode steps."""
    jcfg, tcfg, jp, tp = _pair(arch_id)
    kw = _inputs(arch_id, tcfg, B, S)
    want, _ = jT.forward(jp, jcfg, MeshPlan(), **{k: jnp.asarray(v) for k, v in kw.items()})
    got, _ = tT.forward(tp, tcfg, **_torch_in(kw))
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, want, LOGIT_TOL)
    if tcfg.encoder_only:
        return
    jcache = jT.init_cache(jcfg, B, 16, MeshPlan(), dtype=jnp.float32)
    tcache = tT.init_cache(tcfg, B, 16, "cpu", dtype=torch.float32)
    want, jcache = jT.forward(jp, jcfg, MeshPlan(), cache=jcache,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got, tcache = tT.forward(tp, tcfg, cache=tcache, **_torch_in(kw))
    _close(got, want, LOGIT_TOL)
    for step in range(2):
        one = _inputs(arch_id, tcfg, B, 1, seed=10 + step)
        if "positions" in one:
            one["positions"] = one["positions"] + S + step
        pos = np.full((B,), S + step, np.int32)
        want, jcache = jT.forward(jp, jcfg, MeshPlan(), cache=jcache, cache_pos=jnp.asarray(pos),
                                  **{k: jnp.asarray(v) for k, v in one.items()})
        got, tcache = tT.forward(tp, tcfg, cache=tcache, cache_pos=torch.from_numpy(pos).long(),
                                 **_torch_in(one))
        _close(got, want, LOGIT_TOL)


def test_encoder_is_bidirectional():
    """hubert's logits at position 0 depend on later frames (no causal
    mask); a decoder's do not."""
    _, tcfg, _, tp = _pair("hubert-xlarge")
    x = torch.from_numpy(_inputs("hubert-xlarge", tcfg, 1, S)["embeds"])
    y = x.clone()
    y[:, -1] += 1.0
    a, _ = tT.forward(tp, tcfg, embeds=x)
    b, _ = tT.forward(tp, tcfg, embeds=y)
    assert not torch.equal(a[:, 0], b[:, 0])
    _, dcfg, _, dp = _pair("internlm2-1.8b")
    a, _ = tT.forward(dp, dcfg, embeds=x)
    b, _ = tT.forward(dp, dcfg, embeds=y)
    assert torch.equal(a[:, 0], b[:, 0])


# ------------------------------------------------------------------ engine


def _jax_generate(arch_id: str, params, prompts, quant: bool):
    jarch = jax_get_arch(arch_id, reduced=True)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.replace(compute_dtype="float32"))
    eng = JaxServeEngine(jarch, params, MeshPlan(),
                         JaxServeConfig(max_len=MAX_LEN, **(QUANT if quant else {})))
    return eng, np.asarray(eng.generate(jnp.asarray(prompts), NEW))


@pytest.mark.parametrize("arch_id,quant", [(a, q) for a in DECODERS for q in (False, True)
                                            if not (q and a in MOE)])
def test_generate_equals_jax_engine(arch_id, quant):
    """Greedy tokens of the port's engine equal the JAX engine's on the
    same weights: unquantized, and for the non-MoE configs the JAX
    engine's int8 tree (an MoE tree is refused under int8:
    ``tests/test_torch_moe.py``)."""
    jcfg, tcfg, jp, _ = _pair(arch_id)
    prompts = _rng(1).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jeng, want = _jax_generate(arch_id, jp, prompts, quant)
    arch = dataclasses.replace(get_arch(arch_id, reduced=True), cfg=tcfg)
    eng = ServeEngine(arch, params_from_jax(_np(jeng.params), "cpu"),
                      ServeConfig(max_len=MAX_LEN), device="cpu")
    got = eng.generate(torch.from_numpy(prompts).long(), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_refuses_the_encoder_with_the_reference_reason():
    _, tcfg, _, tp = _pair("hubert-xlarge")
    ok, reason = jax_get_arch("hubert-xlarge").supports(jbase.SHAPES["decode_32k"])
    assert not ok
    with pytest.raises(ValueError, match=reason):
        ServeEngine(get_arch("hubert-xlarge", reduced=True), tp, ServeConfig(), device="cpu")


# ------------------------------------------------------------------- costs


COST_ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b", "command-r-35b", "hubert-xlarge")


@pytest.mark.parametrize("arch_id", COST_ARCHS)
def test_costs_equal_the_reference(arch_id):
    """decode / prefill / spec-verify costs (MoE capacity padding, gelu,
    the encoder's unhalved attention), a tied variant, and ``lm_workload``,
    at the published widths: equal floats."""
    for tie in (False, True):
        cfg = tbase.get_config(arch_id).replace(tie_embeddings=tie)
        jcfg = jbase.get_config(arch_id).replace(tie_embeddings=tie)
        assert analytic._param_counts(cfg) == jax_analytic._param_counts(jcfg)
        for cb, wb in ((2.0, 2.0), (1.03, 1.01 * 0.5)):
            pairs = [(analytic.decode_step_cost(cfg, 4, 128, cb, wb),
                      jax_analytic.decode_step_cost(jcfg, 4, 128, cb, wb)),
                     (analytic.prefill_chunk_cost(cfg, 4, 16, start=32,
                                                  cache_bytes_per_elem=cb,
                                                  weight_bytes_per_elem=wb),
                      jax_analytic.prefill_chunk_cost(jcfg, 4, 16, start=32,
                                                      cache_bytes_per_elem=cb,
                                                      weight_bytes_per_elem=wb)),
                     (analytic.spec_verify_cost(cfg, 4, 4, 64, 2, cb, wb),
                      jax_analytic.spec_verify_cost(jcfg, 4, 4, 64, 2, cb, wb))]
            for got, want in pairs:
                assert (got.flops, got.hbm_bytes, got.breakdown) == (
                    want.flops, want.hbm_bytes, want.breakdown)
        got = tmap.lm_workload(cfg, 0.5, 0.25, seq_len=3)
        want = jmap.lm_workload(jcfg, 0.5, 0.25, seq_len=3)
        assert [dataclasses.asdict(w) for w in got] == [dataclasses.asdict(w) for w in want]


def test_costs_refuse_the_families_not_ported():
    """Once refused, now priced: the recurrent families' decode-step cost
    (the hybrid's shared-block KV per invocation and fp32 SSM state, rwkv's
    WKV state) equals the reference's at the published and the reduced
    config (``tests/test_torch_{mamba2,rwkv}.py`` hold the rest)."""
    for arch_id in RECURRENT:
        for get in ("get_config", "reduced_config"):
            cfg, jcfg = getattr(tbase, get)(arch_id), getattr(jbase, get)(arch_id)
            got = analytic.decode_step_cost(cfg, 1, 8)
            want = jax_analytic.decode_step_cost(jcfg, 1, 8)
            assert (got.flops, got.hbm_bytes, got.breakdown) == (
                want.flops, want.hbm_bytes, want.breakdown)

"""The port's MoE (``models/moe.py``) held against the reference's
(``tests/test_moe.py`` is the checklist), and the MoE family through the
engine, the scheduler and the drafters.

Reduced moonshot (4 experts, top-2, capacity factor 8) and grok-1 (8 → 4
experts, top-2), params made by the reference and carried across with
``params_from_jax``, inputs from numpy seeds, fp32.  Tolerances: the
router's gates and every block output within 2e-5 absolute; the chosen
experts and the dispatch buffers exact; greedy tokens and the schedulers'
host counters equal.  The port's dispatch has no data-dependent shape: a
forward runs on the ``meta`` device at decode and prefill shapes, at the
reduced and the full config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced_config as jax_reduced_config
from repro.core import sonic_layers as jsl
from repro.models import moe as jM
from repro.models.registry import get_arch as jax_get_arch
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding.mesh import MeshPlan
from repro_torch.configs.base import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sonic_layers import quantize_serve_params, sparse_draft_params
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.models.registry import META, get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine, SpecConfig
from torch_scheduler_pair import generate, parity, prompts_of, sides_fixture, spec_parity

TOL = 2e-5
ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b")
NONE = dict(weight_quant="none")
LENS = [3, 5, 8, 13, 5, 8]
NEWS = [9, 2, 5, 16, 1, 7]


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    """(JAX cfg, port cfg, JAX params, port params) of one reduced MoE block."""
    jcfg, tcfg = jax_reduced_config(request.param), reduced_config(request.param)
    p = jM.moe_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, p, params_from_jax(jax.tree_util.tree_map(np.array, p), "cpu")


def _x(b: int, s: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_router_matches_jax(block):
    jcfg, tcfg, p, tp = block
    x = _x(3, 10, tcfg.d_model)
    gates, experts = jM._router(p, jcfg, jnp.asarray(x))
    tg, te = tM._router(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(experts))
    _close(tg, gates)


def test_selection_logits_snap_and_break_ties():
    """Logits one sub-quantum apart select alike; exact ties go to the
    lower expert id, as the reference's."""
    logits = np.array([[0.5, 0.5, 0.2, 0.50004]], np.float32)
    want = jM._selection_logits(jnp.asarray(logits))
    got = tM._selection_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.topk(got, 2).indices.tolist() == [[0, 1]]


@pytest.mark.parametrize("capacity", [1, 3, 20])
def test_dispatch_indices_equal_jax_exactly(capacity):
    """Distinct experts per token (as top-k gives them), capacity from
    tight (drops) to ample: the same ints and gates in every slot."""
    rng = np.random.default_rng(capacity)
    b, t, e, k = 3, 10, 4, 2
    experts = np.argsort(rng.random((b, t, e)), -1)[..., :k].astype(np.int32)
    gates = rng.random((b, t, k)).astype(np.float32)
    ji, jg = jax.vmap(lambda ee, g: jM._dispatch_indices(ee, g, e, capacity))(
        jnp.asarray(experts), jnp.asarray(gates))
    ti, tg = tM._dispatch_indices(torch.from_numpy(experts).long(), torch.from_numpy(gates),
                                  e, capacity)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("cf", [None, 0.5], ids=["ample", "tight"])
def test_moe_apply_matches_jax(block, cf):
    """The sparse block at the config's capacity (8: nothing drops) and at
    0.5 (tokens dropped: their output rows lose those experts' terms)."""
    jcfg, tcfg, p, tp = block
    x = _x(2, 12, tcfg.d_model, seed=1)
    cap = tM.capacity(tcfg, 12, cf)
    assert cap == max(int(np.ceil(12 * tcfg.experts_per_token / tcfg.n_experts
                                  * (cf or tcfg.moe_capacity_factor))), 1)
    _, experts = tM._router(tp, tcfg, torch.from_numpy(x))
    kept = tM._slots(experts, tcfg.n_experts, cap)[1]
    assert kept.all() if cf is None else not kept.all()
    want = jM.moe_apply(p, jcfg, jnp.asarray(x), MeshPlan(), capacity_factor=cf)
    _close(tM.moe_apply(tp, tcfg, torch.from_numpy(x), capacity_factor=cf), want)


def test_moe_apply_dense_matches_jax_and_the_sparse_block(block):
    jcfg, tcfg, p, tp = block
    x = _x(2, 12, tcfg.d_model, seed=2)
    want = jM.moe_apply_dense(p, jcfg, jnp.asarray(x))
    got = tM.moe_apply_dense(tp, tcfg, torch.from_numpy(x))
    _close(got, want)
    # nothing drops at the reduced capacity: the sparse block is the oracle
    _close(tM.moe_apply(tp, tcfg, torch.from_numpy(x)), want)


def test_gelu_experts_match_jax():
    jcfg = jax_reduced_config("grok-1-314b").replace(ffn="gelu_mlp")
    tcfg = reduced_config("grok-1-314b").replace(ffn="gelu_mlp")
    p = jM.moe_init(jax.random.PRNGKey(3), jcfg)
    assert "wg" not in p
    tp = params_from_jax(jax.tree_util.tree_map(np.array, p), "cpu")
    x = _x(2, 6, tcfg.d_model, seed=3)
    _close(tM.moe_apply(tp, tcfg, torch.from_numpy(x)),
           jM.moe_apply(p, jcfg, jnp.asarray(x), MeshPlan()))


def test_init_has_the_reference_leaves():
    cfg = reduced_config("moonshot-v1-16b-a3b")
    got = tM.moe_init(torch.Generator().manual_seed(0), cfg, "cpu", (2,))
    want = jax.eval_shape(lambda: jM.moe_init(jax.random.PRNGKey(0),
                                              jax_reduced_config("moonshot-v1-16b-a3b")))
    assert set(got) == set(want)
    for name in ("wi", "wg", "wo"):
        assert got[name].shape == (2, *want[name].shape)
        assert got[name].dtype == getattr(torch, cfg.param_dtype)
    assert got["router"]["kernel"].shape == (2, *want["router"]["kernel"].shape)
    assert got["router"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("b,s", [(4, 1), (2, 64)], ids=["decode", "prefill"])
def test_moe_forward_runs_on_meta(reduced, b, s):
    """No op of the MoE forward has a data-dependent output size (it would
    raise on the meta device, and could not be captured on the card)."""
    arch = get_arch("moonshot-v1-16b-a3b", reduced=reduced)
    cfg = arch.cfg
    params = arch.init_params(None, META)
    cache = tT.init_cache(cfg, b, 128, META)
    tokens = torch.zeros((b, s), dtype=torch.long, device=META)
    pos = torch.zeros((b,), dtype=torch.long, device=META) if s == 1 else None
    logits, _ = tT.forward(params, cfg, tokens=tokens, cache=cache, cache_pos=pos)
    assert logits.shape == (b, s, cfg.vocab_size) and logits.device.type == "meta"


# ------------------------------------------------------------------ engine


def _raw(arch_id="moonshot-v1-16b-a3b"):
    jraw = jax_get_arch(arch_id, reduced=True).init_params(jax.random.PRNGKey(0))
    return jraw, params_from_jax(jax.tree_util.tree_map(np.array, jraw), "cpu")


def test_moe_int8_is_refused_in_both_packages():
    """The reference's int8 rewrite turns the router's kernel into int8
    leaves its router cannot read (``KeyError: 'kernel'``); the port
    refuses the tree up front, naming the leaf."""
    jraw, raw = _raw()
    jeng = JaxServeEngine(jax_get_arch("moonshot-v1-16b-a3b", reduced=True), jraw, MeshPlan(),
                          JaxServeConfig(max_len=32, weight_quant="int8"))
    with pytest.raises(KeyError, match="kernel"):
        jeng.generate(jnp.zeros((1, 4), jnp.int32), 2)
    with pytest.raises(ValueError, match="router"):
        ServeEngine(get_arch("moonshot-v1-16b-a3b", reduced=True), raw,
                    ServeConfig(max_len=32, weight_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="layers/moe/router/kernel"):
        quantize_serve_params(raw)


def test_self_drafter_prunes_the_router_as_jax():
    """``sparse_draft_params`` prunes every 3-D stacked leaf as the
    reference: the router (L, d, E) too, kept dense in fp32 (the router
    reads it so); the 4-D expert stacks stay as they are."""
    jraw, raw = _raw()
    want = jsl.sparse_draft_params(jraw, 0.5, block=(16, 2))  # the router is (64, 4)
    got = sparse_draft_params(raw, 0.5, block=(16, 2), dtype=torch.float32)
    router = got["layers"]["moe"]["router"]
    assert set(router) == {"kernel"} and router["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(router["kernel"].numpy(),
                                  np.asarray(want["layers"]["moe"]["router"]["kernel"]))
    assert (router["kernel"] == 0).any()
    for name in ("wi", "wg", "wo"):
        assert got["layers"]["moe"][name] is raw["layers"]["moe"][name]


@pytest.fixture(scope="module")
def sides():
    yield from sides_fixture("moonshot-v1-16b-a3b", NONE)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_scheduler_matches_jax(sides, layout):
    """Continuous serving of reduced moonshot: equal tokens and counters;
    at capacity factor 8 nothing drops, so every request also equals the
    port's own ``generate`` at B = 1."""
    kw = {"n_blocks": 24} if layout == "paged" else {}
    handles, _ = parity(sides, prompts_of(LENS), NEWS, layout, n_slots=3, segment_len=4, **kw)
    teng = sides(layout, False)[1]
    for h, p, n in zip(handles, prompts_of(LENS), NEWS):
        assert h.tokens == generate(teng, p, n)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_truncate_spec_matches_jax(sides, layout):
    """``truncate:1`` at k = 2: the JAX scheduler's tokens and its
    speculative counters."""
    spec_parity(sides, SpecConfig(k=2, draft="truncate:1"), prompts_of(LENS), NEWS, layout)


def test_self_spec_matches_jax(sides):
    """The self-drafter (its router pruned as the reference's) through the
    scheduler: JAX's tokens and host counters."""
    spec_parity(sides, SpecConfig(k=2, draft="self", draft_sparsity=0.5), prompts_of(LENS),
                NEWS)


def test_bf16_runs_repeat_and_paged_equals_dense():
    """Port against port in the served bf16 compute: two runs give the same
    bits, paged ≡ dense, and the three loops agree."""
    _, raw = _raw()
    arch = get_arch("moonshot-v1-16b-a3b", reduced=True)
    prompts = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 9))).long()
    outs = {loop: ServeEngine(arch, raw, ServeConfig(max_len=32, loop=loop),
                              device="cpu").generate(prompts, 6) for loop in ("scan", "python")}
    assert torch.equal(outs["scan"], outs["python"])
    engines = {layout: ServeEngine(arch, raw, ServeConfig(max_len=32, kv_layout=layout,
                                                          block_len=8), device="cpu")
               for layout in ("dense", "paged")}
    from repro_torch.serve.scheduler import ContinuousScheduler

    tokens = {}
    for layout, eng in engines.items():
        for run in range(2):
            sched = ContinuousScheduler(eng, n_slots=2, segment_len=4,
                                        **({"n_blocks": 12} if layout == "paged" else {}))
            hs = [sched.submit(p, n) for p, n in zip(prompts_of(LENS[:4]), NEWS[:4])]
            sched.run()
            tokens[layout, run] = [h.tokens for h in hs]
    assert tokens["dense", 0] == tokens["dense", 1] == tokens["paged", 0] == tokens["paged", 1]


def test_arch_replace_keeps_moe():
    """A config cut in depth keeps its experts (``chip_smoke.py`` cuts
    grok-1 to two layers)."""
    cfg = dataclasses.replace(reduced_config("grok-1-314b"), n_layers=1)
    params = tT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["moe"]["wi"].shape[:2] == (1, cfg.n_experts)
    assert "ffn" not in params["layers"]

"""zamba2-7b's hybrid family held against the JAX package: the Mamba2 / SSD
block (``models/mamba2.py``), the hybrid model (``models/hybrid.py``) and
its serving through the engine and the scheduler.

The blocks at the reduced config's widths within 2e-5 (fp32: only the
order of fp32 sums differs); the model as ``tests/torch_recurrent_pair.py``
says.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import hybrid as jH
from repro.models import mamba2 as jM
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import hybrid as tH
from repro_torch.models import mamba2 as tM
from torch_recurrent_pair import (
    LAYER_TOL,
    Pair,
    check_costs,
    check_decode_continuity,
    check_fallbacks,
    check_forward,
    check_generate,
    check_int8_kv_is_a_no_op,
    check_int8_refused,
    check_jax_scheduler,
    check_scheduler,
    check_while_holds_the_state,
    close,
    leaf_specs,
    np_tree,
    rng,
)

ARCH = "zamba2-7b"
JCFG = jax_reduced_config(ARCH).replace(compute_dtype="float32")
TCFG = reduced_config(ARCH).replace(compute_dtype="float32")
DM = tM.mamba2_dims(TCFG)


@pytest.fixture(scope="module")
def pair():
    return Pair(ARCH)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _block_params():
    """The reference's Mamba2 block init, perturbed so that every leaf
    (the zero conv bias and dt bias, the unit D and norm scale) matters."""
    p = jM.mamba2_init(jax.random.PRNGKey(0), JCFG)
    leaves, tree = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    leaves = [a + 0.1 * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tree, leaves)


def test_dims_and_init_match_jax():
    """The dims; every leaf of the block's init and the model's (names,
    shapes, dtypes); the deterministic leaves' values; the shared block's
    invocations at the reduced and the full config."""
    assert tM.mamba2_dims(TCFG) == jM.mamba2_dims(JCFG)
    want = jM.mamba2_init(jax.random.PRNGKey(0), JCFG)
    got = tM.mamba2_init(torch.Generator().manual_seed(0), TCFG, "cpu")
    assert leaf_specs(got) == leaf_specs(want)
    for name in ("A_log", "D", "dt_bias"):
        close(got[name], want[name], LAYER_TOL)
    assert leaf_specs(tH.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")) == \
        leaf_specs(jax.eval_shape(lambda: jH.init_params(JCFG, jax.random.PRNGKey(0))))
    for tcfg, jcfg in ((TCFG, JCFG), (get_config(ARCH), jax_get_config(ARCH))):
        assert tH.n_shared_invocations(tcfg) == jH.n_shared_invocations(jcfg)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x = rng(0).standard_normal((2, 9, DM["conv_dim"])).astype(np.float32)
    w = rng(1).standard_normal((TCFG.ssm_conv_width, DM["conv_dim"])).astype(np.float32)
    b = rng(2).standard_normal(DM["conv_dim"]).astype(np.float32)
    st = (rng(3).standard_normal((2, TCFG.ssm_conv_width - 1, DM["conv_dim"]))
          .astype(np.float32) if with_state else None)
    want, wstate = jM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   None if st is None else jnp.asarray(st))
    got, gstate = tM._causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
    close(got, want, LAYER_TOL)
    close(gstate, wstate, 0.0)


@pytest.mark.parametrize("s,chunk,with_h0", [(37, 16, False), (37, 16, True), (16, 16, True),
                                             (5, 16, False), (40, 8, True)])
def test_ssd_chunked_matches_jax(s, chunk, with_h0):
    """Several chunks, a padded last chunk (dt = 0 is state-neutral), a
    carried state or none."""
    h, p, g, n = DM["h"], DM["p"], DM["g"], DM["n"]
    x = rng(0).standard_normal((2, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng(1).standard_normal((2, s, h)))).astype(np.float32)
    A = -np.exp(rng(2).standard_normal(h)).astype(np.float32)
    Bm = rng(3).standard_normal((2, s, g, n)).astype(np.float32)
    Cm = rng(4).standard_normal((2, s, g, n)).astype(np.float32)
    h0 = rng(5).standard_normal((2, h, n, p)).astype(np.float32) if with_h0 else None
    want, wfin = jM._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                 None if h0 is None else jnp.asarray(h0), chunk)
    got, gfin = tM._ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)),
                                None if h0 is None else _t(h0), chunk)
    close(got, want, LAYER_TOL)
    close(gfin, wfin, LAYER_TOL)


@pytest.mark.parametrize("s,with_state", [(1, True), (1, False), (23, True), (23, False)])
def test_mamba2_block_matches_jax(s, with_state):
    """The whole block: the exact one-step decode (S = 1 with a state), the
    chunked scan otherwise; out and the new conv / ssm state."""
    jp = _block_params()
    tp = params_from_jax(np_tree(jp), "cpu")
    x = rng(6).standard_normal((2, s, TCFG.d_model)).astype(np.float32)
    st = None
    if with_state:
        st = {"conv": rng(7).standard_normal((2, TCFG.ssm_conv_width - 1, DM["conv_dim"])),
              "ssm": rng(8).standard_normal((2, DM["h"], DM["n"], DM["p"]))}
        st = {k: v.astype(np.float32) for k, v in st.items()}
    want, wst = jM.mamba2_apply(jp, JCFG, jnp.asarray(x),
                                None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = tM.mamba2_apply(tp, TCFG, _t(x),
                               None if st is None else {k: _t(v) for k, v in st.items()})
    close(got, want, LAYER_TOL)
    for k in ("conv", "ssm"):
        close(gst[k], wst[k], LAYER_TOL)


def test_one_step_decode_sums_over_a_fixed_axis():
    """The decode step's recurrence (``_ssd_step``: the contraction over N
    an fp32 multiply and a sum over a fixed axis) does not depend on the
    batch: a row of B = 4 equals the same row at B = 1 bit for bit."""
    h, p, g, n = DM["h"], DM["p"], DM["g"], DM["n"]
    x = _t(rng(9).standard_normal((4, h, p)).astype(np.float32))
    dt = _t(np.abs(rng(10).standard_normal((4, h))).astype(np.float32))
    A = _t(-np.exp(rng(11).standard_normal(h)).astype(np.float32))
    Bm, Cm = (_t(rng(12 + i).standard_normal((4, g, n)).astype(np.float32)) for i in range(2))
    h0 = _t(rng(14).standard_normal((4, h, n, p)).astype(np.float32))
    y, hnew = tM._ssd_step(x, dt, A, Bm, Cm, h0)
    for i in range(4):
        yi, hi = tM._ssd_step(x[i:i + 1], dt[i:i + 1], A, Bm[i:i + 1], Cm[i:i + 1], h0[i:i + 1])
        assert torch.equal(y[i:i + 1], yi) and torch.equal(hnew[i:i + 1], hi)


def test_forward_matches_jax():
    check_forward(ARCH)


def test_decode_continuity():
    check_decode_continuity(ARCH)


def test_cache_leaves():
    """(n_inv, B, S, KH, Dh) attention leaves on the slot axis 1, not
    (L, …); fp32 SSM state; the conv state in the compute type."""
    cfg = reduced_config(ARCH)
    c = tH.init_cache(cfg, 3, 10, "cpu")
    n_inv = tH.n_shared_invocations(cfg)
    assert c["attn_k"].shape == (n_inv, 3, 10, cfg.n_kv_heads, cfg.head_dim) != (
        cfg.n_layers, 3, 10, cfg.n_kv_heads, cfg.head_dim)
    assert c["ssm"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    assert c["attn_k"].dtype == torch.bfloat16


@pytest.mark.parametrize("loop", ["scan", "while", "python"])
def test_generate_equals_jax_engine(pair, loop):
    check_generate(pair, loop)


def test_jax_scheduler_serves_bf16_only(pair):
    check_jax_scheduler(pair)


@pytest.mark.parametrize("mode,compute", [("scan", "float32"), ("while", "float32"),
                                          ("scan", "bfloat16")])
def test_scheduler_equals_generate_per_request(pair, mode, compute):
    check_scheduler(pair, mode, compute)


def test_while_segment_past_its_stop_holds_the_state(pair):
    check_while_holds_the_state(pair)


def test_fallbacks_match_the_reference(pair):
    check_fallbacks(pair)


def test_int8_is_refused_where_the_reference_fails(pair):
    check_int8_refused(pair, "mamba_layers/block/in_proj/kernel")


def test_int8_kv_is_a_no_op(pair):
    check_int8_kv_is_a_no_op(pair)


def test_costs_equal_the_reference():
    check_costs(ARCH)


def test_params_from_jax_keeps_the_fp32_leaves():
    """A bf16 tree (the full config's ``param_dtype``) carries its fp32
    leaves across as fp32: ``A_log``, ``D``, ``dt_bias``, the norms."""
    jcfg = jax_reduced_config(ARCH).replace(param_dtype="bfloat16")
    tree = params_from_jax(np_tree(jH.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    block = tree["mamba_layers"]["block"]
    assert block["in_proj"]["kernel"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert block[name].dtype == torch.float32
    assert block["out_norm"]["scale"].dtype == torch.float32
    assert tree["shared"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16

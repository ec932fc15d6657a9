"""rwkv6-3b's family held against the JAX package: the RWKV6 time-mix and
channel-mix blocks (``models/rwkv6.py``), the model
(``models/rwkv_model.py``) and its serving through the engine and the
scheduler.

The blocks at the reduced config's widths within 2e-5 (fp32: only the
order of fp32 sums differs); the model as ``tests/torch_recurrent_pair.py``
says.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import rwkv6 as jR6
from repro.models import rwkv_model as jRM
from repro_torch.configs.base import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import rwkv6 as tR6
from repro_torch.models import rwkv_model as tRM
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

ARCH = "rwkv6-3b"
JCFG = jax_reduced_config(ARCH).replace(compute_dtype="float32")
TCFG = reduced_config(ARCH).replace(compute_dtype="float32")
H, N = TCFG.rwkv_heads, TCFG.rwkv_head_size


@pytest.fixture(scope="module")
def pair():
    return Pair(ARCH)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _perturbed(p):
    """The reference's init with every leaf moved (the constant w0, the
    unit norm scale and zero bias must matter too)."""
    leaves, tree = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    leaves = [a + 0.1 * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _state(b: int, seed: int) -> dict:
    return {"shift_t": rng(seed).standard_normal((b, TCFG.d_model)).astype(np.float32),
            "wkv": rng(seed + 1).standard_normal((b, H, N, N)).astype(np.float32) * 0.3,
            "shift_c": rng(seed + 2).standard_normal((b, TCFG.d_model)).astype(np.float32)}


def test_init_matches_jax_leaves():
    """Every leaf of the model's tree: the same names, shapes and dtypes
    (the fp32 μ, decay LoRA, u, w0 and norms beside the projections)."""
    want = jax.eval_shape(lambda: jRM.init_params(JCFG, jax.random.PRNGKey(0)))
    got = tRM.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert leaf_specs(got) == leaf_specs(want)
    assert (got["layers"]["time_mix"]["w0"] == -3.0).all()


def test_token_shift_matches_jax():
    x = rng(0).standard_normal((2, 5, TCFG.d_model)).astype(np.float32)
    prev = rng(1).standard_normal((2, TCFG.d_model)).astype(np.float32)
    for p in (None, prev):
        want = jR6._token_shift(jnp.asarray(x), None if p is None else jnp.asarray(p))
        close(tR6._token_shift(_t(x), None if p is None else _t(p)), want, 0.0)


@pytest.mark.parametrize("s", [1, 13])
def test_wkv_scan_matches_jax(s):
    r, k, v = (rng(i).standard_normal((2, s, H, N)).astype(np.float32) for i in range(3))
    w = (1 / (1 + np.exp(-rng(3).standard_normal((2, s, H, N))))).astype(np.float32)
    u = rng(4).standard_normal((H, N)).astype(np.float32)
    s0 = rng(5).standard_normal((2, H, N, N)).astype(np.float32)
    want, wfin = jR6._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    got, gfin = tR6._wkv_scan(*(_t(a) for a in (r, k, v, w, u, s0)))
    close(got, want, LAYER_TOL)
    close(gfin, wfin, LAYER_TOL)


@pytest.mark.parametrize("s,with_state", [(1, True), (1, False), (11, True), (11, False)])
def test_time_mix_matches_jax(s, with_state):
    jp = _perturbed(jR6.rwkv6_time_mix_init(jax.random.PRNGKey(0), JCFG))
    tp = params_from_jax(np_tree(jp), "cpu")
    x = rng(6).standard_normal((2, s, TCFG.d_model)).astype(np.float32)
    st = _state(2, 7) if with_state else None
    jst = None if st is None else {k: jnp.asarray(st[k]) for k in ("shift_t", "wkv")}
    tst = None if st is None else {k: _t(st[k]) for k in ("shift_t", "wkv")}
    want, wnew = jR6.rwkv6_time_mix_apply(jp, JCFG, jnp.asarray(x), jst)
    got, gnew = tR6.rwkv6_time_mix_apply(tp, TCFG, _t(x), tst)
    close(got, want, LAYER_TOL)
    for k in ("shift_t", "wkv"):
        close(gnew[k], wnew[k], LAYER_TOL)


@pytest.mark.parametrize("s,with_state", [(1, True), (11, False)])
def test_channel_mix_matches_jax(s, with_state):
    jp = _perturbed(jR6.rwkv6_channel_mix_init(jax.random.PRNGKey(0), JCFG))
    tp = params_from_jax(np_tree(jp), "cpu")
    x = rng(6).standard_normal((2, s, TCFG.d_model)).astype(np.float32)
    st = _state(2, 7) if with_state else None
    want, wnew = jR6.rwkv6_channel_mix_apply(
        jp, JCFG, jnp.asarray(x), None if st is None else {"shift_c": jnp.asarray(st["shift_c"])})
    got, gnew = tR6.rwkv6_channel_mix_apply(
        tp, TCFG, _t(x), None if st is None else {"shift_c": _t(st["shift_c"])})
    close(got, want, LAYER_TOL)
    close(gnew["shift_c"], wnew["shift_c"], 0.0)


def test_wkv_step_sums_over_a_fixed_axis():
    """One WKV step at B = 4 gives each row the bits it has at B = 1 (the
    contraction over i an fp32 multiply and a sum over a fixed axis)."""
    r, k, v = (_t(rng(i).standard_normal((4, 1, H, N)).astype(np.float32)) for i in range(3))
    w = _t((1 / (1 + np.exp(-rng(3).standard_normal((4, 1, H, N))))).astype(np.float32))
    u = _t(rng(4).standard_normal((H, N)).astype(np.float32))
    s0 = _t(rng(5).standard_normal((4, H, N, N)).astype(np.float32))
    y, fin = tR6._wkv_scan(r, k, v, w, u, s0)
    for i in range(4):
        yi, fi = tR6._wkv_scan(r[i:i + 1], k[i:i + 1], v[i:i + 1], w[i:i + 1], u, s0[i:i + 1])
        assert torch.equal(y[i:i + 1], yi) and torch.equal(fin[i:i + 1], fi)


def test_forward_matches_jax():
    check_forward(ARCH)


def test_decode_continuity():
    check_decode_continuity(ARCH)


def test_cache_is_o1_in_length():
    """``max_len`` is ignored: the state's leaves are (L, B, …) whatever it
    is; the shift leaves in the compute type, the WKV state fp32."""
    cfg = reduced_config(ARCH)
    a, b = tRM.init_cache(cfg, 3, 8, "cpu"), tRM.init_cache(cfg, 3, 4096, "cpu")
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert a["wkv"].shape == (cfg.n_layers, 3, cfg.rwkv_heads, cfg.rwkv_head_size,
                              cfg.rwkv_head_size)
    assert a["wkv"].dtype == torch.float32 and a["shift_t"].dtype == torch.bfloat16


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
    check_int8_refused(pair, "layers/time_mix/wr/kernel")


def test_int8_kv_is_a_no_op(pair):
    check_int8_kv_is_a_no_op(pair)


def test_costs_equal_the_reference():
    check_costs(ARCH)


def test_params_from_jax_keeps_the_fp32_leaves():
    """A bf16 tree carries its fp32 leaves across as fp32: μ, w0, u, the
    decay LoRA and the norms."""
    jcfg = jax_reduced_config(ARCH).replace(param_dtype="bfloat16")
    tree = params_from_jax(np_tree(jRM.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    tm = tree["layers"]["time_mix"]
    assert tm["wr"]["kernel"].dtype == torch.bfloat16
    for name in ("mu", "w0", "u", "decay_lora_a", "decay_lora_b"):
        assert tm[name].dtype == torch.float32, name
    assert tree["layers"]["channel_mix"]["mu"].dtype == torch.float32
    assert tree["embed_norm"]["scale"].dtype == torch.float32

"""The port's decoder held against the JAX package's, on converted params.

Reduced tinyllama (2 layers, d_model 64) with ``compute_dtype="float32"``
on both sides: bf16 rounds at other places in the two frameworks, which is
not the algorithm's doing.  The projections are int8 block-sparse at
(16, 16) blocks and sparsity 0.5 (at d_model 64 the automatic block would be
one 64×64 block, and the gather would never run).  Logits must agree within
1e-4 absolute: only the order of the fp32 reductions differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sonic_layers import quantize_serve_params as jax_quantize
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_arch

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    jcfg = jarch.cfg.replace(compute_dtype="float32")
    qparams = jax_quantize(jarch.init_params(jax.random.PRNGKey(0)), 0.5, (16, 16))
    tparams = params_from_jax(jax.tree_util.tree_map(np.array, qparams), "cpu")
    tcfg = get_arch("tinyllama-1.1b", reduced=True).cfg.replace(compute_dtype="float32")
    return jcfg, qparams, tcfg, tparams


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_reduced_config_matches_jax(setup):
    jcfg, _, tcfg, _ = setup
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_prefill_and_decode_logits_match_jax(setup):
    jcfg, qparams, tcfg, tparams = setup
    plan = MeshPlan()
    b, s, max_len = 2, 8, 16
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    jcache = jT.init_cache(jcfg, b, max_len, plan, dtype=jnp.float32)
    tcache = tT.init_cache(tcfg, b, max_len, "cpu", dtype=torch.float32)
    jlog, jcache = jT.forward(qparams, jcfg, plan, tokens=jnp.asarray(tokens), cache=jcache)
    tlog, tcache = tT.forward(tparams, tcfg, tokens=torch.from_numpy(tokens).long(),
                              cache=tcache)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    pos = np.full((b,), s, np.int32)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jlog, jcache = jT.forward(qparams, jcfg, plan, tokens=jnp.asarray(tok[:, None]),
                                  cache=jcache, cache_pos=jnp.asarray(pos))
        tlog, tcache = tT.forward(tparams, tcfg, tokens=torch.from_numpy(tok[:, None]).long(),
                                  cache=tcache, cache_pos=torch.from_numpy(pos).long())
        assert tlog.shape == (b, 1, tcfg.vocab_size)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog[:, 0], -1)).astype(np.int32)
        pos = pos + 1
    _close(tcache["v"], jcache["v"])


def test_forward_without_cache_matches_jax(setup):
    """The cache-less mode (whole sequence, causal flash attention)."""
    jcfg, qparams, tcfg, tparams = setup
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    jlog, jcache = jT.forward(qparams, jcfg, MeshPlan(), tokens=jnp.asarray(tokens))
    tlog, tcache = tT.forward(tparams, tcfg, tokens=torch.from_numpy(tokens).long())
    assert jcache is None and tcache is None
    _close(tlog, jlog)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_norm_apply_matches_jax():
    x, scale = _rand(2, 5, 64), _rand(64, seed=1)
    want = jL.norm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tL.norm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rope_matches_jax(setup):
    jcfg, _, tcfg, _ = setup
    pos = np.array([[0, 1, 2, 7], [3, 9, 40, 127]], np.int32)
    x = _rand(2, 4, 4, tcfg.head_dim)
    want = jL.apply_rope(jnp.asarray(x), jL.rope_angles(jcfg, jnp.asarray(pos)))
    got = tL.apply_rope(torch.from_numpy(x), tL.rope_angles(tcfg, torch.from_numpy(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_jax():
    """GQA (4 query heads over 2 KV heads), two query rows per slot, rows at
    different positions: everything past each row's position is masked."""
    q, k, v = _rand(2, 2, 4, 16), _rand(2, 12, 2, 16, seed=1), _rand(2, 12, 2, 16, seed=2)
    pos = np.array([3, 9], np.int32)
    want = jL.decode_attention(*map(jnp.asarray, (q, k, v, pos)))
    got = tL.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_attention_chunks_and_padding_match_jax():
    """Several Q and KV chunks (the online softmax carries across them) and
    padded positions (pos < 0 never attends)."""
    q, k, v = _rand(2, 8, 4, 16), _rand(2, 8, 2, 16, seed=1), _rand(2, 8, 2, 16, seed=2)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    kv_pos = pos.copy()
    kv_pos[1, :3] = -1
    want = jL.flash_attention(*map(jnp.asarray, (q, k, v, pos, kv_pos)), q_chunk=4, kv_chunk=2)
    got = tL.flash_attention(*map(torch.from_numpy, (q, k, v, pos, kv_pos)),
                             q_chunk=4, kv_chunk=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_modes_not_ported_raise(setup):
    """Chunk-resume, the verify window, paged and int8 KV are ported
    (``tests/test_torch_modes.py``), and M-RoPE (``tests/test_torch_families.py``);
    M-RoPE positions on a config whose sections do not cover head_dim / 2
    raise (the reference asserts), and a decode step or a paged forward
    without a position has none to write at."""
    _, _, tcfg, tparams = setup
    cache = tT.init_cache(tcfg, 1, 16, "cpu", dtype=torch.float32)
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="mrope_sections"):  # (16, 24, 24) at head_dim 16
        tT.forward(tparams, tcfg, tokens=tok, positions=torch.zeros((1, 3, 4), dtype=torch.long),
                   cache=cache)
    with pytest.raises(ValueError):  # a one-token step without a position
        tT.forward(tparams, tcfg, tokens=tok[:, :1], cache=cache)
    pool = tT.init_paged_cache(tcfg, 4, 4, "cpu", dtype=torch.float32)
    with pytest.raises(ValueError):  # a paged prefill without a position
        tT.forward(tparams, tcfg, tokens=tok, cache=pool,
                   block_table=torch.zeros((1, 4), dtype=torch.int32))

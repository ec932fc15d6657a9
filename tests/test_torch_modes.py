"""The transformer's serving modes: the port against the JAX package, and
the port against itself bit for bit.

Reduced tinyllama (2 layers, d_model 64).  The same weights go through both
packages: the JAX model's random init carried across by ``params_from_jax``,
dense or int8 block-sparse at (16, 16) blocks and sparsity 0.5
(``quantize_serve_params`` of the JAX package).

Against JAX, fp32 compute: chunk-resume prefill, the speculative-verify
window (``decode_chunk``), decode, over the dense and the paged (scrambled
block table) cache, with fp32 and int8 KV.  Logits within 2e-5 with dense
weights; within 1e-4 with int8 weights, the bound ``tests/test_torch_model.py``
holds the port's int8 logits to (the kernels' plain versions accumulate the
dequantized product in fp32 where the reference's jnp path multiplies
``w·s`` first).

Port against port, bit for bit, in bf16 and fp32 compute: chunk-resume ≡
whole-prompt prefill (with a garbage-padded last chunk) and a verify window
of k + 1 rows ≡ k + 1 decode steps (B = 1 and 2); paged ≡ dense in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sonic_layers import quantize_serve_params as jax_quantize
from repro.models import transformer as jT
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import MeshPlan
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_arch

TOL = {"dense": 2e-5, "int8": 1e-4}
MAX_LEN, BL = 24, 4  # 6 blocks of 4 per slot


@pytest.fixture(scope="module")
def weights():
    """{"dense" | "int8": (JAX params, the port's params)}."""
    raw = jax_get_arch("tinyllama-1.1b", reduced=True).init_params(jax.random.PRNGKey(0))
    out = {}
    for name, p in (("dense", raw), ("int8", jax_quantize(raw, 0.5, (16, 16)))):
        out[name] = (p, params_from_jax(jax.tree_util.tree_map(np.array, p), "cpu"))
    return out


def _cfgs(compute="float32"):
    jcfg = jax_get_arch("tinyllama-1.1b", reduced=True).cfg.replace(compute_dtype=compute)
    tcfg = get_arch("tinyllama-1.1b", reduced=True).cfg.replace(compute_dtype=compute)
    return jcfg, tcfg


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _table(b, seed=0):
    """A scrambled block table: slot s's blocks are distinct physical ids
    past the b scratch blocks, in a random order."""
    mb = MAX_LEN // BL
    ids = np.random.default_rng(seed).permutation(b * mb) + b
    return ids.reshape(b, mb).astype(np.int32), b + b * mb


def _caches(jcfg, tcfg, b, layout, quant):
    """fp32 KV (or int8 KV) in fp32 compute: a bf16 cache would round each
    package's k and v, whose fp32 sums differ in order, and one flipped
    bf16 rounding moves a logit by ~4e-3."""
    plan = MeshPlan(cache_quant_int8=quant)
    if layout == "dense":
        return (jT.init_cache(jcfg, b, MAX_LEN, plan, dtype=jnp.float32), tT.init_cache(
            tcfg, b, MAX_LEN, "cpu", dtype=torch.float32, cache_quant_int8=quant), None)
    table, n_blocks = _table(b)
    return (jT.init_paged_cache(jcfg, n_blocks, BL, plan, dtype=jnp.float32),
            tT.init_paged_cache(tcfg, n_blocks, BL, "cpu", dtype=torch.float32,
                                cache_quant_int8=quant), table)


# (tokens, cache_pos or None, decode_chunk) of each call, B = 2
CALLS = [((0, 8), 0, False),  # chunk-resume from 0
         ((8, 13), 8, False),  # chunk-resume mid-prompt
         ((13, 17), 13, True),  # a verify window of 4 rows
         ((17, 18), 17, False)]  # a decode step


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32_kv", "int8_kv"])
@pytest.mark.parametrize("wname", ["dense", "int8"])
def test_modes_match_jax(weights, wname, quant, layout):
    jp, tp = weights[wname]
    jcfg, tcfg = _cfgs()
    b = 2
    toks = _tokens(b, 18)
    jcache, tcache, table = _caches(jcfg, tcfg, b, layout, quant)
    plan = MeshPlan(cache_quant_int8=quant)
    for (lo, hi), pos, chunk in CALLS:
        jpos = jnp.full((b,), pos, jnp.int32)
        kw = {} if table is None else {"block_table": jnp.asarray(table)}
        jlog, jcache = jT.forward(jp, jcfg, plan, tokens=jnp.asarray(toks[:, lo:hi]),
                                  cache=jcache, cache_pos=jpos, decode_chunk=chunk, **kw)
        tkw = {} if table is None else {"block_table": torch.from_numpy(table)}
        tlog, tcache = tT.forward(tp, tcfg, tokens=torch.from_numpy(toks[:, lo:hi]).long(),
                                  cache=tcache, cache_pos=torch.full((b,), pos),
                                  decode_chunk=chunk, **tkw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL[wname],
                                   err_msg=f"tokens {lo}:{hi}")
    for name in jcache:  # the caches the calls wrote
        got, want = tcache[name].float().numpy(), np.asarray(jcache[name].astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[wname])


@pytest.mark.parametrize("wname", ["dense", "int8"])
def test_int8_kv_whole_prompt_prefill_matches_jax(weights, wname):
    """The int8-KV recipe: a whole-prompt prefill attends the dequantized
    cache it has just written."""
    jp, tp = weights[wname]
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, 9, seed=1)
    plan = MeshPlan(cache_quant_int8=True)
    jlog, _ = jT.forward(jp, jcfg, plan, tokens=jnp.asarray(toks),
                         cache=jT.init_cache(jcfg, 2, MAX_LEN, plan))
    tlog, _ = tT.forward(tp, tcfg, tokens=torch.from_numpy(toks).long(),
                         cache=tT.init_cache(tcfg, 2, MAX_LEN, "cpu", cache_quant_int8=True))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL[wname])


# ------------------------------------------------- port against port, bits


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _fwd(tp, tcfg, toks, cache, pos=None, **kw):
    cp = None if pos is None else torch.full((toks.shape[0],), pos)
    return tT.forward(tp, tcfg, tokens=torch.from_numpy(toks).long(), cache=cache,
                      cache_pos=cp, **kw)


def _cache(tcfg, b, quant, max_len=MAX_LEN):
    """The KV cache in the compute type (int8 with ``quant``)."""
    return tT.init_cache(tcfg, b, max_len, "cpu", dtype=getattr(torch, tcfg.compute_dtype),
                         cache_quant_int8=quant)


COMPUTE = pytest.mark.parametrize("compute", ["bfloat16", "float32"])


@COMPUTE
@pytest.mark.parametrize("quant", [False, True], ids=["fp_kv", "int8_kv"])
@pytest.mark.parametrize("wname", ["dense", "int8"])
def test_chunk_resume_equals_whole_prompt_bitwise(weights, wname, quant, compute):
    """The port's ``tests/test_serve_prefill.py`` contract: a prompt of 13
    prefilled in chunks of 8 (the last padded with 3 garbage tokens) gives
    the whole-prompt prefill's last logits and cache bit for bit."""
    _, tp = weights[wname]
    _, tcfg = _cfgs(compute)
    p_len, chunk = 13, 8
    prompt = _tokens(1, p_len, seed=2)
    want_lg, want_c = _fwd(tp, tcfg, prompt, _cache(tcfg, 1, quant, 32))
    cache = _cache(tcfg, 1, quant, 32)
    _, cache = _fwd(tp, tcfg, prompt[:, :chunk], cache, 0)
    tail = np.concatenate([prompt[:, chunk:], _tokens(1, 3, seed=99)], axis=1)
    lg, cache = _fwd(tp, tcfg, tail, cache, chunk)
    assert torch.equal(want_lg[0, -1], lg[0, p_len - chunk - 1])
    for name in want_c:
        assert torch.equal(want_c[name][:, :, :p_len], cache[name][:, :, :p_len]), name


@COMPUTE
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("quant", [False, True], ids=["fp_kv", "int8_kv"])
@pytest.mark.parametrize("wname", ["dense", "int8"])
def test_verify_window_equals_sequential_decode_bitwise(weights, wname, quant, b, compute):
    """A ``decode_chunk`` window of k + 1 = 5 rows gives each row the logits
    of the decode step it replaces, and the same cache, bit for bit.  In
    fp32 compute this needs the row floor of ``utils.rows`` at B = 1 (bf16
    outputs round most one-ulp fp32 differences away)."""
    _, tp = weights[wname]
    _, tcfg = _cfgs(compute)
    s, k1 = 8, 5
    toks = _tokens(b, s + k1, seed=3)
    _, cache = _fwd(tp, tcfg, toks[:, :s], _cache(tcfg, b, quant))
    seq_cache = _clone(cache)
    window, cache = _fwd(tp, tcfg, toks[:, s:], cache, s, decode_chunk=True)
    for i in range(k1):
        lg, seq_cache = _fwd(tp, tcfg, toks[:, s + i:s + i + 1], seq_cache, s + i)
        assert torch.equal(lg[:, 0], window[:, i]), f"row {i}"
    for name in cache:
        assert torch.equal(cache[name], seq_cache[name]), name


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
@pytest.mark.parametrize("wname", ["dense", "int8"])
def test_paged_equals_dense_bitwise(weights, wname, quant):
    """Over a scrambled block table, chunk-resume, decode steps and a verify
    window give the dense cache's logits bit for bit."""
    _, tp = weights[wname]
    _, tcfg = _cfgs("bfloat16")
    b = 2
    toks = _tokens(b, 20, seed=4)
    table, n_blocks = _table(b, seed=5)
    dense = tT.init_cache(tcfg, b, MAX_LEN, "cpu", cache_quant_int8=quant)
    pool = tT.init_paged_cache(tcfg, n_blocks, BL, "cpu", cache_quant_int8=quant)
    bt = torch.from_numpy(table)
    for (lo, hi), pos, chunk in CALLS + [((18, 19), 18, False), ((19, 20), 19, False)]:
        want, dense = _fwd(tp, tcfg, toks[:, lo:hi], dense, pos, decode_chunk=chunk)
        got, pool = _fwd(tp, tcfg, toks[:, lo:hi], pool, pos, decode_chunk=chunk,
                         block_table=bt)
        assert torch.equal(got, want), f"tokens {lo}:{hi}"
    for name in dense:  # the pool, read through the table, is the dense cache
        virt = pool[name][:, bt.long()].flatten(2, 3)
        assert torch.equal(virt[:, :, :20], dense[name][:, :, :20]), name


def test_dense_rows_do_not_depend_on_m():
    """``dense_apply`` and the kernels' plain versions give a row the same
    bits at M = 1 as inside M = 2 … 12 (PyTorch's CPU product alone takes
    another route at M = 1)."""
    from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
    from repro_torch.models import layers as tL
    from repro_torch.core.sonic_layers import make_block_sparse_int8

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 128), generator=gen)
    q = make_block_sparse_int8(w, 0.5, (16, 16))
    x = torch.randn((12, 64), generator=gen)
    for fn in (lambda xx: tL.dense_apply({"kernel": w}, xx),
               lambda xx: bs_kernel.block_sparse_matmul_int8_plain(xx, q.values, q.scales,
                                                                   q.indices)):
        rows = fn(x)
        for m in (1, 2, 5, 12):
            assert torch.equal(fn(x[:m]), rows[:m]), m


def test_reduced_configs_agree():
    jcfg, tcfg = _cfgs()
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name

"""The port's KV-cache helpers held against the JAX package's, bit for bit.

``quantize_kv`` / ``dequantize_kv`` (the ``+1e-8`` on the scale, half-to-
even rounding), the paged pool's gather and its two writes with the
reference's deliberate out-of-range behaviour (ids clamp in the gather,
drop in the writes), and the registry's slot and block helpers.  The port
writes in place where the reference returns new arrays, so each test hands
the port a copy and compares the copy afterwards.  Then the registry's
cache contracts, which the port checks with forwards on the meta device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import registry as jR
from repro_torch.models import layers as tL
from repro_torch.models import registry as tR


def _rand(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.float().numpy() if got.is_floating_point()
                                  else got.numpy(), np.asarray(want).astype(
                                      np.float32 if got.is_floating_point() else None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_kv_bits(dtype):
    x = _rand(3, 7, 2, 16, seed=1) * 3
    x[0, 0, 0] = 0.0  # an all-zero head: scale is 1e-8
    x[0, 1, 0, :4] = [127.0, 63.5, -63.5, 0.5]  # ties for the rounding
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jL.quantize_kv(jx)
    tq, ts = tL.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tq, jq)
    _eq(ts, js)
    _eq(tL.dequantize_kv(tq, ts), jL.dequantize_kv(jq, js).astype(jnp.float32))
    _eq(tL.dequantize_kv(tq, ts, torch.float32), jL.dequantize_kv(jq, js, jnp.float32))


N_BLOCKS, BL = 9, 4


def _pool(seed=0, scales=False):
    shape = (N_BLOCKS, BL, 2) if scales else (N_BLOCKS, BL, 2, 8)
    return _rand(*shape, seed=seed)


def test_paged_gather_clamps_out_of_range_ids():
    pool = _pool()
    table = np.array([[3, 0, 8], [11, -2, 5]], np.int32)  # 11 and -2 clip
    want = jL.paged_cache_gather(jnp.asarray(pool), jnp.asarray(table))
    got = tL.paged_cache_gather(_t(pool), _t(table))
    assert got.shape == (2, 3 * BL, 2, 8)
    _eq(got, want)


@pytest.mark.parametrize("scales", [False, True])
def test_paged_write_decode_equals_reference(scales):
    """One token per slot at its mapped (block, offset); row 2's table maps
    an out-of-range block (it drops), and row 3 writes past the table."""
    pool = _pool(scales=scales)
    table = np.array([[2, 5, 3], [1, 4, 6], [7, 12, 0], [0, 8, 3]], np.int32)
    pos = np.array([1, 9, 6, 12], np.int32)
    new = _rand(4, 1, *pool.shape[2:], seed=3)
    want = jL.paged_cache_write(*map(jnp.asarray, (pool, table, new, pos)))
    got = _t(pool)
    tL.paged_cache_write(got, _t(table), _t(new), _t(pos).long())
    _eq(got, want)


@pytest.mark.parametrize("scales", [False, True])
def test_paged_write_chunk_straddles_blocks_and_drops(scales):
    """A chunk of 6 per slot straddling blocks; row 1 is a masked dummy row
    whose table holds distinct out-of-range ids, so every write of it
    drops, as the serving layer uses them."""
    pool = _pool(scales=scales)
    table = np.array([[2, 5, 3, 7], [20, 21, 22, 23], [6, 1, 4, 8]], np.int32)
    pos0 = np.array([2, 0, 5], np.int32)
    new = _rand(3, 6, *pool.shape[2:], seed=4)
    want = jL.paged_cache_write_chunk(*map(jnp.asarray, (pool, table, new, pos0)))
    got = _t(pool)
    tL.paged_cache_write_chunk(got, _t(table), _t(new), _t(pos0).long())
    _eq(got, want)


def test_paged_write_chunk_all_rows_dropped_leaves_pool():
    pool = _pool()
    table = np.array([[30, 31], [32, 33]], np.int32)
    got = _t(pool)
    tL.paged_cache_write_chunk(got, _t(table), _t(_rand(2, 3, 2, 8, seed=5)),
                               torch.zeros(2, dtype=torch.long))
    _eq(got, pool)


def _cache(n_slots, seed=0, quant=False):
    shape = (2, n_slots, 8, 2, 4)
    c = {"k": _rand(*shape, seed=seed), "v": _rand(*shape, seed=seed + 1)}
    if quant:
        c["k_scale"], c["v_scale"] = _rand(*shape[:-1], seed=seed + 2), _rand(*shape[:-1])
    return c


def _jtree(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _ttree(c):
    return {k: _t(v) for k, v in c.items()}


def _eq_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])


@pytest.mark.parametrize("quant", [False, True])
def test_slot_helpers_equal_reference(quant):
    full, one = _cache(4, quant=quant), _cache(1, seed=10, quant=quant)
    _eq_tree(tR.write_cache_slot(_ttree(full), _ttree(one), 2),
             jR.write_cache_slot(_jtree(full), _jtree(one), 2))
    slots = np.array([3, 0, 9], np.int32)  # 9 clips in the gather
    _eq_tree(tR.gather_cache_slots(_ttree(full), _t(slots)),
             jR.gather_cache_slots(_jtree(full), jnp.asarray(slots)))
    rows = _cache(3, seed=20, quant=quant)
    for slots in (np.array([3, 0, 9], np.int32), np.array([7, 1, 2], np.int32),
                  np.array([5, 6, 7], np.int32)):  # out-of-range ids drop
        _eq_tree(tR.write_cache_slots(_ttree(full), _ttree(rows), _t(slots)),
                 jR.write_cache_slots(_jtree(full), _jtree(rows), jnp.asarray(slots)))


def test_write_cache_block_equals_reference():
    pool = {"k": _rand(2, 6, 4, 2, 3), "v": _rand(2, 6, 4, 2, 3, seed=1)}
    small = {"k": _rand(2, 1, 8, 2, 3, seed=2), "v": _rand(2, 1, 8, 2, 3, seed=3)}
    blocks = np.array([4, 1], np.int32)
    _eq_tree(tR.write_cache_block(_ttree(pool), _ttree(small), _t(blocks)),
             jR.write_cache_block(_jtree(pool), _jtree(small), jnp.asarray(blocks)))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("reduced", [True, False])
def test_cache_contracts_hold_for_the_transformer(reduced, quant):
    """The four contract checks, on the meta device, at the reduced and the
    full-width tinyllama config, bf16 and int8 KV."""
    arch = tR.get_arch("tinyllama-1.1b", reduced=reduced)
    assert arch.supports_chunked_prefill and arch.supports_spec_decode
    assert arch.supports_paged_kv
    tR.check_decode_cache_carry(arch, cache_quant_int8=quant)
    tR.check_slot_cache_contract(arch, cache_quant_int8=quant)
    tR.check_slots_cache_contract(arch, cache_quant_int8=quant)
    tR.check_paged_cache_contract(arch, cache_quant_int8=quant)


@pytest.mark.parametrize("arch_id", ["zamba2-7b", "rwkv6-3b"])
def test_cache_contracts_name_what_is_not_ported(arch_id):
    """The recurrent families (the real reduced archs): the decode-carry and
    slot contracts hold; chunk-resume and paged KV raise with the
    family's reason, as the reference's contracts do."""
    other = tR.get_arch(arch_id, reduced=True)
    assert other.chunked_prefill_skip_reason() and other.paged_skip_reason()
    assert not other.supports_spec_decode and not other.supports_paged_kv
    tR.check_decode_cache_carry(other)
    tR.check_slot_cache_contract(other)
    with pytest.raises(NotImplementedError, match=arch_id.split("-")[0][:4]):
        tR.check_slots_cache_contract(other)
    with pytest.raises(NotImplementedError):
        tR.check_paged_cache_contract(other)
    with pytest.raises(NotImplementedError):
        other.init_paged_cache(4, 4, "cpu")


def test_int8_caches_have_the_reference_leaves():
    arch = tR.get_arch("tinyllama-1.1b", reduced=True)
    from repro.models import transformer as jT
    from repro.sharding.mesh import MeshPlan

    plan = MeshPlan(cache_quant_int8=True)
    for got, want in (
            (arch.init_cache(2, 8, "cpu", cache_quant_int8=True),
             jT.init_cache(jR.get_arch("tinyllama-1.1b", reduced=True).cfg, 2, 8, plan)),
            (arch.init_paged_cache(5, 4, "cpu", cache_quant_int8=True),
             jT.init_paged_cache(jR.get_arch("tinyllama-1.1b", reduced=True).cfg, 5, 4,
                                 plan))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)

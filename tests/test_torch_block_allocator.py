"""The port's ``BlockAllocator`` (the paged-KV host free list): the nine
cases of ``tests/test_block_allocator.py`` on the port, and seeded random
sequences of alloc / grow / release on the port's allocator and JAX's
side by side, which must give the same free lists, mappings and errors."""
import numpy as np
import pytest

from repro.serve import BlockAllocator as JaxBlockAllocator
from repro_torch.serve.scheduler import BlockAllocator


def test_alloc_release_roundtrip():
    alc = BlockAllocator(6, first_block=2)
    a = alc.alloc(0, 3)
    b = alc.alloc(1, 2)
    assert len(set(a) | set(b)) == 5  # all distinct
    assert all(blk >= 2 for blk in a + b)  # scratch range untouched
    assert alc.n_free == 1 and alc.n_mapped == 5
    freed = alc.release(0)
    assert sorted(freed) == sorted(a)
    assert alc.n_free == 4 and alc.n_mapped == 2
    alc.release(1)
    assert alc.n_free == alc.capacity == 6
    assert not alc.mapped


def test_exhaustion_gates_can_alloc():
    alc = BlockAllocator(4)
    assert alc.can_alloc(4) and not alc.can_alloc(5)
    alc.alloc(0, 3)
    assert alc.can_alloc(1) and not alc.can_alloc(2)
    with pytest.raises(ValueError, match="only 1 of 4 blocks free"):
        alc.alloc(1, 2)
    assert alc.n_free == 1 and alc.n_mapped == 3  # the failed alloc mutated nothing
    alc.release(0)
    assert alc.can_alloc(4)


def test_double_map_rejected():
    alc = BlockAllocator(4)
    alc.alloc(0, 1)
    with pytest.raises(ValueError, match="already holds"):
        alc.alloc(0, 1)


def test_release_unmapped_slot_raises():
    alc = BlockAllocator(4)
    with pytest.raises(KeyError):
        alc.release(3)


def test_double_release_raises():
    alc = BlockAllocator(4)
    alc.alloc(0, 2)
    alc.release(0)
    with pytest.raises(KeyError):
        alc.release(0)
    assert alc.n_free == alc.capacity


def test_grow_extends_existing_mapping():
    alc = BlockAllocator(6, first_block=2)
    a = alc.alloc(0, 2)
    b = alc.grow(0, 3)
    assert alc.mapped[0] == a + b  # growth appends, order preserved
    assert len(set(a + b)) == 5 and alc.n_free == 1
    freed = alc.release(0)
    assert sorted(freed) == sorted(a + b)
    assert alc.n_free == alc.capacity


def test_grow_unmapped_slot_raises():
    alc = BlockAllocator(4)
    with pytest.raises(KeyError):
        alc.grow(0, 1)


def test_grow_beyond_free_raises_without_mutating():
    alc = BlockAllocator(4)
    alc.alloc(0, 3)
    with pytest.raises(ValueError, match="only 1 of 4 blocks free"):
        alc.grow(0, 2)
    assert len(alc.mapped[0]) == 3 and alc.n_free == 1


def test_blocks_recycle_in_fifo_order():
    alc = BlockAllocator(3, first_block=1)
    first = alc.alloc(0, 1)
    alc.release(0)
    others = alc.alloc(1, 2)
    assert first[0] not in others


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(6))
def test_random_sequence_matches_jax_allocator(seed):
    """200 random alloc / grow / release calls (valid and not) on both
    allocators: the same results, the same exceptions with the same
    messages, and the same free list and mapping after every call."""
    rng = np.random.RandomState(seed)
    n_blocks, first = int(rng.randint(4, 24)), int(rng.randint(1, 5))
    ours, theirs = BlockAllocator(n_blocks, first), JaxBlockAllocator(n_blocks, first)
    errors = 0
    for _ in range(200):
        op = ("alloc", "grow", "release")[int(rng.randint(3))]
        slot, n = int(rng.randint(0, 5)), int(rng.randint(0, 6))
        args = (slot,) if op == "release" else (slot, n)
        a = _outcome(lambda: getattr(ours, op)(*args))
        b = _outcome(lambda: getattr(theirs, op)(*args))
        assert a == b, (op, args)
        errors += a[0] != "ok"
        assert list(ours.free) == list(theirs.free)
        assert ours.mapped == theirs.mapped
        assert (ours.n_free, ours.n_mapped) == (theirs.n_free, theirs.n_mapped)
        assert ours.can_alloc(n) == theirs.can_alloc(n)
    assert errors  # the sequence reached the error paths

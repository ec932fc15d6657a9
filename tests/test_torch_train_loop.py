"""The train step at bf16 compute against the JAX package's for every arch
at its reduced config; the reference's ``tests/test_train_checkpoint.py``
behaviours on the port (learning with masks enforced, restart determinism,
keep-k, async and atomic saves, a missing leaf); checkpoints across the
two packages, both directions, with bf16 leaves; the launcher.

The pair and every tolerance are in ``tests/torch_train_pair.py``; the
restart checks are bitwise.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.base import ALL_ARCH_IDS
from repro.utils.tree import named_leaves as jax_named_leaves
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_arch
from repro_torch.train.grad_compression import compression_error
from repro_torch.train.loop import TrainConfig, build_train_step, train_loop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state
from repro_torch.utils.tree import named_leaves
from torch_train_pair import (
    BF16_LOSS_RTOL,
    check_states,
    configs,
    make_pair,
    one_thread,
    np_tree,
    to_jax,
    to_torch,
)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_train_step_matches_jax_bf16(arch_id):
    p = make_pair(arch_id, "bfloat16")
    jtc, tc = configs()
    jnew, jm = p.jax_step(jtc)(p.jstate, to_jax(p.batch))
    tnew, tm = p.port_step(tc)(p.tstate(), to_torch(p.batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_LOSS_RTOL)
    check_states(tnew, jnew, "bfloat16")


# --------------------------------------------- the reference's checkpoint tests


def _setup(grad_accum=1, compressed=False, seed=0):
    arch = get_arch("internlm2-1.8b", reduced=True)
    tc = TrainConfig(
        opt=AdamWConfig(lr=5e-3, warmup_steps=2),
        sparsity=SparsityConfig(target_sparsity=0.5, block=(8, 8), ramp_start_step=0,
                                ramp_end_step=10),
        mask_update_every=5,
        grad_accum=grad_accum,
        compressed_accum=compressed,
        remat=True,
    )
    params = arch.init_params(torch.Generator().manual_seed(seed), "cpu")
    state = init_train_state(params, tc.opt, tc.sparsity)
    return arch, tc, state, build_train_step(arch, tc), make_batch_fn(
        arch.cfg.vocab_size, 32, 4, seed=3)


def _same_bits(a, b) -> None:
    for (name, x), (other, y) in zip(named_leaves(a), named_leaves(b), strict=True):
        assert name == other and torch.equal(x, y), name


def test_loss_decreases_and_masks_enforced():
    arch, tc, state, step, data = _setup()
    losses = []
    for i in range(25):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "no learning signal"
    w = state.params["layers"]["ffn"]["wi"]["kernel"]
    mask = state.masks["layers"]["ffn"]["wi"]["kernel"]
    assert (w[mask == 0] == 0).all(), "pruned weights drifted from zero"
    assert 0.3 <= float((mask == 0).float().mean()) <= 0.7


@pytest.mark.parametrize("compressed", [False, True], ids=["fp32_accum", "int8_accum"])
def test_restart_determinism_bitwise(tmp_path, compressed):
    """train 12 == train 6 + save + restore into a fresh state + train 6,
    every leaf bit for bit (masks refreshed at steps 0, 5 and 10: in both
    halves)."""
    _, _, s_a, step, data = _setup(grad_accum=2, compressed=compressed)
    for i in range(12):
        s_a, _ = step(s_a, data(i))
    _, _, s_b, step_b, data_b = _setup(grad_accum=2, compressed=compressed)
    ck = Checkpointer(str(tmp_path), keep=2)
    for i in range(6):
        s_b, _ = step_b(s_b, data_b(i))
    ck.save(s_b, step=6)
    s_c = ck.restore(_setup(seed=1)[2])
    _same_bits(s_c, s_b)
    for i in range(int(s_c.step), 12):
        s_c, _ = step_b(s_c, data_b(i))
    _same_bits(s_a, s_c)


def test_train_loop_resumes_and_checkpoints(tmp_path):
    _, _, s0, step, data = _setup()
    ck = Checkpointer(str(tmp_path), keep=5)
    seen = []
    s1 = train_loop(step, s0, data, 6, ck, checkpoint_every=4,
                    on_metrics=lambda i, m: seen.append((i, m["loss"])))
    assert ck.all_steps() == [4, 6] and int(s1.step) == 6
    assert [i for i, _ in seen] == list(range(6)) and all(isinstance(x, float) for _, x in seen)
    s2 = train_loop(step, ck.restore(s0), data, 8, ck, checkpoint_every=100)
    assert int(s2.step) == 8 and ck.latest_step() == 8


def test_compression_error_is_small():
    g = {"g": torch.randn((64, 64), generator=torch.Generator().manual_seed(0))}
    assert float(compression_error(g)["g"]) < 0.02


def test_checkpoint_keep_k_and_latest(tmp_path):
    state = _setup()[2]
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(state, step=s)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async_and_atomic(tmp_path):
    state = _setup()[2]
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(state, step=7, async_=True)
    ck.wait()
    assert ck.latest_step() == 7
    _same_bits(ck.restore(state), state)
    os.makedirs(tmp_path / "step_9.tmp", exist_ok=True)
    assert 9 not in ck.all_steps()


def test_restore_detects_missing_leaves(tmp_path):
    state = _setup()[2]
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(state, step=1)
    bigger = {"extra": torch.zeros((3,)), "state": state}
    with pytest.raises(IOError):
        ck.restore(bigger, step=1)


# ------------------------------------------------- across the two packages


def test_jax_checkpoint_restores_in_the_port_and_continues(tmp_path):
    """The reference trains a step and saves (bf16 moments); the port
    restores the same bits (leaf names and dtypes as the reference's) and
    its next step matches the reference's next step."""
    p = make_pair("internlm2-1.8b", "float32", moment_dtype="bfloat16")
    jtc, tc = configs()
    jstep, tstep = p.jax_step(jtc), p.port_step(tc)
    js1, _ = jstep(p.jstate, to_jax(p.batch))
    JaxCheckpointer(str(tmp_path)).save(js1, step=2)
    ts1 = Checkpointer(str(tmp_path)).restore(p.tstate())
    assert ts1.opt_state["m"]["embed"]["embedding"].dtype == torch.bfloat16
    for name, leaf in jax_named_leaves(np_tree(js1)):
        got = dict(named_leaves(ts1))[name]
        want = leaf.view(np.uint16) if leaf.dtype.name == "bfloat16" else leaf
        mine = got.view(torch.int16).numpy().view(np.uint16) if got.dtype == torch.bfloat16 \
            else got.numpy()
        np.testing.assert_array_equal(mine, want, err_msg=name)
    js2, jm = jstep(js1, to_jax(p.batch))
    ts2, tm = tstep(ts1, to_torch(p.batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    check_states(ts2, js2, "float32")


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port trains a step and saves (bf16 moments); the reference's
    ``Checkpointer`` restores every leaf with the port's bits."""
    p = make_pair("internlm2-1.8b", "float32", moment_dtype="bfloat16")
    _, tc = configs()
    ts1, _ = p.port_step(tc)(p.tstate(), to_torch(p.batch))
    Checkpointer(str(tmp_path)).save(ts1, step=2)
    restored = JaxCheckpointer(str(tmp_path)).restore(p.jstate)
    got = dict(jax_named_leaves(restored))
    bf16 = 0
    for name, leaf in named_leaves(ts1):
        if leaf.dtype == torch.bfloat16:
            bf16 += 1
            np.testing.assert_array_equal(np.asarray(got[name]).view(np.uint16),
                                          leaf.view(torch.int16).numpy().view(np.uint16),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(got[name]), leaf.numpy(), err_msg=name)
    assert bf16 == 2 * len(list(named_leaves(ts1.params)))
    assert set(got) == {n for n, _ in named_leaves(ts1)}
    assert int(got["3"]) == 2


# ------------------------------------------------------------- the launcher


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    """6 steps with a checkpoint every 2; a second job handed the step-4
    checkpoint alone resumes there and ends with the first job's bits."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "6",
            "--grad-accum", "2", "--compressed-accum", "--mask-update-every", "2",
            "--ckpt-every", "2"]
    straight = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert Checkpointer(str(tmp_path / "a")).all_steps() == [2, 4, 6]
    shutil.copytree(tmp_path / "a" / "step_4", tmp_path / "b" / "step_4")
    (tmp_path / "b" / "LATEST").write_text("4")
    resumed = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert int(resumed.step) == 6
    assert Checkpointer(str(tmp_path / "b")).all_steps() == [4, 6]
    _same_bits(resumed, straight)


def test_launcher_refuses_the_mesh_and_a_missing_card():
    with pytest.raises(SystemExit, match="sharding"):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh", "debug"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        launch_train.main(["--reduced", "--steps", "1"])

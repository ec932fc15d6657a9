"""One train step of the port against the JAX package's, fp32 compute, for
every arch at its reduced config; the pieces of the step (the loss, the
MoE load-balance loss, the int8 accumulator, the optimizer's schedule and
norm); remat on against off; gradient accumulation.

The pair and every tolerance are in ``tests/torch_train_pair.py``.  The
bf16 step, the checkpoints and the loop are in
``tests/test_torch_train_loop.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ALL_ARCH_IDS
from repro.models import moe as jax_moe
from repro.models import transformer as jT
from repro.train.grad_compression import add_compressed as jax_add_compressed
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import global_norm as jax_global_norm
from repro.train.optimizer import lr_at as jax_lr_at
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models import transformer as tT
from repro_torch.train.grad_compression import add_compressed
from repro_torch.train.loop import make_forward_loss, value_and_grad
from repro_torch.train.optimizer import AdamWConfig, global_norm, lr_at
from repro_torch.utils.tree import named_leaves
from torch_train_pair import (
    LOSS_RTOL,
    batch_np,
    check_grads,
    check_states,
    configs,
    leaves_np,
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
def test_train_step_matches_jax(arch_id):
    """The loss, every gradient leaf (of the masked params), the updated
    params, moments' finiteness, the refreshed masks and the step."""
    p = make_pair(arch_id, "float32")
    jtc, tc = configs()
    jnew, jm = p.jax_step(jtc)(p.jstate, to_jax(p.batch))
    tnew, tm = p.port_step(tc)(p.tstate(), to_torch(p.batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    check_states(tnew, jnew, "float32")

    masked = jax.tree_util.tree_map(lambda w, m: w * m.astype(w.dtype), p.jstate.params,
                                    p.jstate.masks)
    jloss, jgrads = jax.jit(jax.value_and_grad(p.jax_loss(jtc)))(masked, to_jax(p.batch))
    tmasked = params_from_jax(np_tree(masked), "cpu")
    for _, leaf in named_leaves(tmasked):
        leaf.requires_grad_()
    tloss, tgrads = value_and_grad(make_forward_loss(p.tarch, tc, p.tcfg), tmasked,
                                   to_torch(p.batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    check_grads(tgrads, leaves_np(jax_tree=jgrads))


@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_remat_on_and_off_are_bitwise_equal(arch_id):
    """The port against itself: recomputing every layer in the backward
    pass changes no bit of the step."""
    p = make_pair(arch_id, "float32")
    _, tc = configs()
    outs = [p.port_step(dataclasses.replace(tc, remat=r))(p.tstate(), to_torch(p.batch))
            for r in (True, False)]
    (a, ma), (b, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"])
    for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("compressed", [False, True], ids=["exact", "int8"])
def test_grad_accum_matches_jax(compressed):
    """Two microbatches of 2, accumulated in fp32 or through the int8
    accumulator: the loss and the updated state as one step."""
    p = make_pair("internlm2-1.8b", "float32")
    p.batch = batch_np(p.arch_id, p.jcfg.d_model, p.jcfg.vocab_size, b=4)
    jtc, tc = configs(grad_accum=2, compressed_accum=compressed)
    jnew, jm = p.jax_step(jtc)(p.jstate, to_jax(p.batch))
    tnew, tm = p.port_step(tc)(p.tstate(), to_torch(p.batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    check_states(tnew, jnew, "float32")


def test_add_compressed_matches_jax():
    """The int8 accumulator on the same gradients: equal to the fp32
    rounding of one division (the scales and codes are the reference's)."""
    rng = np.random.default_rng(3)
    acc = {"a": rng.standard_normal((33, 17)).astype(np.float32),
           "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    g = {"a": (rng.standard_normal((33, 17)) * 1e-3).astype(np.float32),
         "b": {"c": np.array([0.5, -0.25, 1.0, 0.0, 2.0 / 127], np.float32)}}
    want = jax_add_compressed(jax.tree_util.tree_map(jnp.asarray, acc),
                              jax.tree_util.tree_map(jnp.asarray, g), 2)
    got = add_compressed(params_from_jax(acc, "cpu"), params_from_jax(g, "cpu"), 2)
    for name, w in leaves_np(jax_tree=want).items():
        np.testing.assert_allclose(leaves_np(torch_tree=got)[name], w, rtol=0, atol=1e-7,
                                   err_msg=name)


def test_loss_fn_matches_jax_and_ignores_minus_one():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, 2:] = -1
    labels[2, :] = -1
    got = tT.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels).long())
    want = jT.loss_fn(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    keep = labels >= 0
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    nll = lse - np.take_along_axis(logits, np.maximum(labels, 0)[..., None], -1)[..., 0]
    np.testing.assert_allclose(float(got), nll[keep].mean(), rtol=1e-6)
    none = tT.loss_fn(torch.from_numpy(logits), torch.full((3, 7), -1))
    assert float(none) == 0.0  # divided by max(valid, 1)


@pytest.mark.parametrize("arch_id", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_moe_load_balance_loss_matches_jax(arch_id):
    p = make_pair(arch_id, "float32")
    layer0 = jax.tree_util.tree_map(lambda a: a[0], p.jstate.params["layers"]["moe"])
    x = np.random.default_rng(2).standard_normal((2, 16, p.jcfg.d_model)).astype(np.float32)
    want = jax_moe.moe_load_balance_loss(layer0, p.jcfg, jnp.asarray(x))
    got = moe.moe_load_balance_loss(params_from_jax(np_tree(layer0), "cpu"), p.tcfg,
                                    torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lr_schedule_and_global_norm_match_jax():
    jcfg, tcfg = JaxAdamWConfig(lr=2e-3, warmup_steps=7), AdamWConfig(lr=2e-3, warmup_steps=7)
    for step in (0, 1, 3, 7, 12):
        np.testing.assert_allclose(float(lr_at(tcfg, torch.tensor(step, dtype=torch.int32))),
                                   float(jax_lr_at(jcfg, jnp.asarray(step, jnp.int32))),
                                   rtol=1e-7)
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((8, 9)).astype(np.float32),
            "s": rng.standard_normal((3,)).astype(np.float32)}
    np.testing.assert_allclose(
        float(global_norm(params_from_jax(tree, "cpu"))),
        float(jax_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))), rtol=1e-6)


@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_remat_dots_policy_is_bitwise_equal(arch_id):
    """The "dots" policy (the 2-D products saved, the rest recomputed)
    gives the step of no remat, bit for bit."""
    p = make_pair(arch_id, "float32")
    _, tc = configs()
    outs = []
    for policy, remat in (("dots", True), ("nothing", False)):
        p.tcfg = p.tcfg.replace(remat_policy=policy)
        outs.append(p.port_step(dataclasses.replace(tc, remat=remat))(p.tstate(),
                                                                      to_torch(p.batch)))
    (a, ma), (b, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"])
    for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        assert torch.equal(x, y), name


def test_training_products_are_never_row_chunked(monkeypatch):
    """While autograd records, in the forward and in remat's recompute,
    ``layers.dense_apply`` runs one product: ``fixed_rows`` (the serving
    path's row floors and chunks) is never called."""
    from repro_torch.models import layers

    calls = []
    orig = layers.fixed_rows
    monkeypatch.setattr(layers, "fixed_rows", lambda fn, x: calls.append(x.shape) or orig(fn, x))
    p = make_pair("tinyllama-1.1b", "float32")
    _, tc = configs()
    p.port_step(tc)(p.tstate(), to_torch(p.batch))
    assert calls == []
    with torch.inference_mode():  # serving keeps them
        layers.dense_apply({"kernel": torch.ones((4, 3))}, torch.ones((1, 5, 4)))
    assert calls == [(5, 4)]

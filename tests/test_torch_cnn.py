"""The port's paper CNNs (Table 1) held against the JAX package's.

The JAX package initialises each network; its params are carried across
with ``convert.params_from_jax`` (lists included) and both forward passes
see the same numpy batch.  fp32 on both sides; the convolutions sum 9·C_in
terms in another order (XLA's conv against PyTorch's), so logits are held
to 1e-5 and each post-ReLU activation's zero fraction to 1e-4 (an input
that lies within rounding of zero may fall to the other side of the ReLU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.convert import params_from_jax
from repro_torch.models import cnn as tcnn


@pytest.mark.parametrize("name", ["mnist", "cifar10", "svhn", "stl10"])
def test_forward_matches_jax_on_carried_weights(name):
    jcfg, cfg = jcnn.PAPER_CNNS[name], tcnn.PAPER_CNNS[name]
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.array, jp), "cpu")
    assert isinstance(params["conv"], list) and params["conv"][0]["kernel"].shape == (
        3, 3, jcfg.input_hw[2], jcfg.conv_channels[0])
    assert tcnn.param_count(params) == jcnn.param_count(jp)
    x = np.random.default_rng(1).random((2, *jcfg.input_hw)).astype(np.float32)
    want, want_acts = jcnn.forward(jp, jcfg, jnp.asarray(x), return_activations=True)
    got, acts = tcnn.forward(params, cfg, torch.from_numpy(x), return_activations=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert len(acts) == len(want_acts)
    for a, b in zip(acts, want_acts):
        assert a.shape == b.shape
        assert abs((a == 0).sum().item() / a.numel() - float(np.mean(np.asarray(b) == 0))) <= 1e-4
    np.testing.assert_array_equal(tcnn.forward(params, cfg, torch.from_numpy(x)).numpy(),
                                  got.numpy())


def test_init_params_shapes_match_jax_and_follow_the_generator():
    for name, jcfg in jcnn.PAPER_CNNS.items():
        if name == "stl10":
            continue  # 77.8 M weights; its shapes are checked through the forward test
        jp = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tcnn.init_params(tcnn.PAPER_CNNS[name], torch.Generator().manual_seed(0))
        for kind in ("conv", "fc"):
            assert [{k: tuple(v.shape) for k, v in lp.items()} for lp in tp[kind]] == \
                [{k: tuple(v.shape) for k, v in lp.items()} for lp in jp[kind]]
        again = tcnn.init_params(tcnn.PAPER_CNNS[name], torch.Generator().manual_seed(0))
        assert torch.equal(tp["fc"][-1]["kernel"], again["fc"][-1]["kernel"])
        fan_in = tp["fc"][0]["kernel"].shape[0]
        assert abs(tp["fc"][0]["kernel"].std().item() * fan_in**0.5 - 1.0) < 0.1



def test_params_from_jax_walks_lists_and_tuples():
    tree = {"conv": [{"kernel": np.ones((3, 3, 1, 2), np.float32)}],
            "pair": (np.zeros(2, np.int32), np.arange(3, dtype=np.float32))}
    got = params_from_jax(tree, "cpu")
    assert isinstance(got["conv"], list) and isinstance(got["pair"], tuple)
    assert got["pair"][0].dtype == torch.int32 and got["pair"][1].tolist() == [0.0, 1.0, 2.0]
    got["conv"][0]["kernel"].add_(1)  # writable: numpy copies, as the parity harness makes
    assert float(got["conv"][0]["kernel"].sum()) == 36.0

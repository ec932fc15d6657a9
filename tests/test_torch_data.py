"""The port's synthetic data against the JAX package's contract: the
permutation bit for bit, batches a pure function of (seed, step), labels
the tokens shifted left with a final −1, the follow rate, the first
token's Zipf-like law; and ``TeacherTask``'s labels with the reference's
teacher carried across.  The two packages draw their random bits with
different generators (ROADMAP Queue 3), so the streams are compared by
their laws, not token for token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.teacher import TeacherTask as JaxTeacherTask
from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.data.teacher import TeacherTask
from repro_torch.models import cnn


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_permutation_is_the_references(seed):
    for v in (256, 4096, 32000):
        np.testing.assert_array_equal(SyntheticLM(v, 8, 2, seed)._perm(),
                                      JaxSyntheticLM(v, 8, 2, seed)._perm())


def test_batch_is_a_function_of_seed_and_step():
    ds = SyntheticLM(512, 64, 4, seed=5)
    a, b = ds.batch(3), SyntheticLM(512, 64, 4, seed=5).batch(3)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(ds.batch(4)["tokens"], a["tokens"])
    assert not torch.equal(SyntheticLM(512, 64, 4, seed=6).batch(3)["tokens"], a["tokens"])
    fn = make_batch_fn(512, 64, 4, seed=5)
    assert torch.equal(fn(3)["tokens"], a["tokens"])


def test_shapes_types_and_labels_shift():
    ds = SyntheticLM(300, 33, 3, seed=1)
    b = ds.batch(0)
    want = JaxSyntheticLM(300, 33, 3, seed=1).batch(0)
    assert b["tokens"].shape == tuple(want["tokens"].shape) == (3, 33)
    assert b["labels"].shape == tuple(want["labels"].shape)
    assert b["tokens"].dtype == torch.long
    assert ((b["tokens"] >= 0) & (b["tokens"] < 300)).all()
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


def test_follow_rate_and_first_token_law():
    """The share of tokens that follow the permutation from the previous
    token sits within 4 binomial sigmas of 0.7 (plus the chance 0.3 / V
    that noise lands on it), in both packages; the first token follows
    −log1p(arange V)."""
    v, s, b = 64, 128, 64

    def rate(tokens, perm):
        t = np.asarray(tokens)
        return float((perm[t[:, :-1]] == t[:, 1:]).mean())

    ds, jds = SyntheticLM(v, s, b, seed=2), JaxSyntheticLM(v, s, b, seed=2)
    n = b * (s - 1) * 4
    sigma = np.sqrt(0.7 * 0.3 / n)
    want = 0.7 + 0.3 / v
    for got in ([rate(ds.batch(i)["tokens"].numpy(), ds._perm()) for i in range(4)],
                [rate(jds.batch(i)["tokens"], jds._perm()) for i in range(4)]):
        assert abs(np.mean(got) - want) < 4 * sigma, got
    # the first token is perm[first] (follow) or noise; where it follows, its
    # preimage is Zipf-distributed: P(0) = 1 / H_V, far above uniform 1 / V
    inv = np.argsort(ds._perm())
    firsts = np.concatenate([inv[ds.batch(i)["tokens"][:, 0].numpy()] for i in range(40)])
    p0 = 1.0 / np.sum(1.0 / np.arange(1, v + 1))
    share = float((firsts == 0).mean())
    expect = 0.7 * p0 + 0.3 / v
    assert abs(share - expect) < 4 * np.sqrt(expect * (1 - expect) / firsts.size), share


def test_teacher_labels_are_the_references():
    """The reference's teacher carried across labels the reference's inputs
    as the reference does; the port's own task is a function of its seed."""
    cfg = jax_cnn.MNIST_CNN
    jt = JaxTeacherTask(cfg, seed=42)
    tt = TeacherTask(cnn.MNIST_CNN, seed=42,
                     teacher_params=params_from_jax(
                         jax.tree_util.tree_map(np.array, jt.teacher_params), "cpu"))
    assert tt.teacher_cfg == cnn.CNNConfig(**{**vars(jt.teacher_cfg)})
    for step in (0, 7):
        x, y = jt.batch(step, batch_size=16)
        got = tt.labels(torch.from_numpy(np.array(x)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(y))
    own = TeacherTask(cnn.MNIST_CNN, seed=42)
    xa, ya = own.batch(3, batch_size=8)
    xb, yb = TeacherTask(cnn.MNIST_CNN, seed=42).batch(3, batch_size=8)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert xa.shape == (8, *cfg.input_hw) and 0.0 <= own.accuracy(
        own.teacher_params, n_batches=1, batch_size=8) <= 1.0

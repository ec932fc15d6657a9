"""The JAX package's train step and the port's side by side, for the
``tests/test_torch_train_*.py`` files (not collected: no ``test_`` prefix).

A pair is one reduced arch with the reference's params carried across with
``convert.train_state_from_numpy``: masks the reference built at step 2 of
a (8, 8)-block ramp to 0.5 over 2 steps, zero moments, step 1 (so the lr
has warmed up, the update's bias corrections are those of a second step,
and the step's refresh builds masks at sparsity 0.4375 from the updated
params).  Inputs come from numpy seeds as the arch's ``input_kind`` says,
with labels of −1 at the end of the first row.

Tolerances, stated here for both files:
  * fp32 compute: the loss within rtol 1e-5; a gradient leaf within rtol
    1e-4 (2**-6, two bf16 ulps, for the bf16 params of grok-1 and
    command-r, whose gradients both packages round to bf16) plus ``GRAD_ATOL`` of the largest gradient entry of the leaf (or a
    thousandth of the largest entry of the whole tree, whichever is
    larger: a leaf whose true gradient is 0, as the keys' bias of a softmax,
    holds rounding noise only);
  * bf16 compute: the loss within rtol ``BF16_LOSS_RTOL`` (bf16 rounds at
    other places in the two frameworks);
  * updated params: AdamW's second step moves an entry by ≈ 0.74·lr·sign(g)
    (+ decay), so an entry whose gradient is rounding noise may move the
    other way in the other package: every entry within 1e-6 + 1e-5·|p|
    (bf16 params: + one bf16 ulp of |p|) of the reference's, except at most
    ``FLIP_FRACTION`` of all entries, which stay within 2·lr of it;
  * masks equal, the step equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.sparsity import SparsityConfig as JaxSparsityConfig
from repro.core.sparsity import build_masks as jax_build_masks
from repro.core.sparsity import l2_regularization as jax_l2
from repro.models import transformer as jT
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import MeshPlan
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import build_train_step as jax_build_train_step
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.train_state import TrainState as JaxTrainState
from repro.train.train_state import init_train_state as jax_init_train_state
from repro.utils.tree import named_leaves as jax_named_leaves
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models.registry import get_arch
from repro_torch.train.loop import TrainConfig, build_train_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.utils.tree import named_leaves

LR = 1e-3
SPARSITY = dict(target_sparsity=0.5, block=(8, 8), ramp_start_step=0, ramp_end_step=2)
B, S = 2, 16
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 5e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FLIP_FRACTION = {"float32": 0.002, "bfloat16": 0.03}


def one_thread():
    """The body of each file's autouse module fixture: torch on one CPU
    thread meanwhile (at these sizes one thread is as fast, and the test
    run's workers do not oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def configs(**kw) -> tuple[JaxTrainConfig, TrainConfig]:
    """The (reference, port) train configs: lr 1e-3 warmed up after a step,
    the ramp of ``SPARSITY``, masks refreshed every step, L2 1e-4, remat,
    and ``kw``'s fields."""
    common = dict(mask_update_every=1, l2_coeff=1e-4, remat=True, **kw)
    return (JaxTrainConfig(opt=JaxAdamWConfig(lr=LR, warmup_steps=1),
                           sparsity=JaxSparsityConfig(**SPARSITY), **common),
            TrainConfig(opt=AdamWConfig(lr=LR, warmup_steps=1),
                        sparsity=SparsityConfig(**SPARSITY), **common))


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def batch_np(arch_id: str, d_model: int, vocab: int, b: int = B, s: int = S,
             seed: int = 0) -> dict:
    kind = get_arch(arch_id, reduced=True).input_kind
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    out["labels"][0, -3:] = -1
    if kind == "tokens":
        out["tokens"] = rng.integers(0, vocab, (b, s)).astype(np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, d_model)).astype(np.float32)
    if kind == "embeds+mrope":
        base = np.arange(s, dtype=np.int32)
        out["positions"] = np.stack([base, base // 2, base % 3])[None].repeat(b, 0)
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@dataclasses.dataclass
class Pair:
    arch_id: str
    jarch: object
    tarch: object
    jcfg: object
    tcfg: object
    jstate: JaxTrainState
    batch: dict  # numpy

    def tstate(self):
        """A fresh port state equal to the reference's."""
        return train_state_from_numpy(np_tree(self.jstate), "cpu")

    def jax_step(self, jtc):
        return jax.jit(jax_build_train_step(self.jarch, MeshPlan(), jtc, cfg=self.jcfg))

    def port_step(self, tc):
        return build_train_step(self.tarch, tc, cfg=self.tcfg)

    def jax_loss(self, jtc):
        """The reference step's loss as a function of the masked params."""
        plan = MeshPlan()

        def loss(params, batch):
            kw = {k: batch[k] for k in ("tokens", "embeds", "positions") if k in batch}
            logits, _ = self.jarch.forward(params, plan, cfg=self.jcfg, remat=jtc.remat, **kw)
            out = jT.loss_fn(logits, batch["labels"])
            return out + jtc.l2_coeff * jax_l2(params) if jtc.l2_coeff else out

        return loss


def make_pair(arch_id: str, compute_dtype: str, moment_dtype: str = "float32") -> Pair:
    jarch = jax_get_arch(arch_id, reduced=True)
    jcfg = jarch.cfg.replace(compute_dtype=compute_dtype)
    tarch = get_arch(arch_id, reduced=True)
    tcfg = tarch.cfg.replace(compute_dtype=compute_dtype)
    params = jarch.init_params(jax.random.PRNGKey(0))
    opt = JaxAdamWConfig(lr=LR, warmup_steps=1, moment_dtype=moment_dtype)
    state = jax_init_train_state(params, opt, None)
    masks = jax_build_masks(params, JaxSparsityConfig(**SPARSITY), step=2)
    jstate = JaxTrainState(params, state.opt_state, masks, jnp.ones((), jnp.int32))
    return Pair(arch_id, jarch, tarch, jcfg, tcfg, jstate,
                batch_np(arch_id, jcfg.d_model, jcfg.vocab_size))


def leaves_np(jax_tree=None, torch_tree=None) -> dict:
    """{name: fp32 numpy} of a reference tree or a port tree."""
    if jax_tree is not None:
        return {n: np.asarray(leaf, np.float32) for n, leaf in jax_named_leaves(jax_tree)}
    return {n: leaf.detach().float().numpy() for n, leaf in named_leaves(torch_tree)}


def check_grads(grads, want: dict) -> None:
    """The port's gradient tree against the reference's leaves (a bf16
    param's gradient is bf16 in both packages: rtol two bf16 ulps, 2**-6)."""
    got = leaves_np(torch_tree=grads)
    bf16 = {n for n, g in named_leaves(grads) if g.dtype == torch.bfloat16}
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        atol = GRAD_ATOL * max(float(np.abs(w).max()), 1e-3 * top)
        rtol = 2.0**-6 if name in bf16 else GRAD_RTOL
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol, err_msg=name)


def check_states(tnew, jnew, compute_dtype: str) -> None:
    """The updated states: params by the flip bound, masks and step equal,
    moments finite."""
    got, want = leaves_np(torch_tree=tnew), leaves_np(jax_tree=jnew)
    assert set(got) == set(want), set(got) ^ set(want)
    params = {n for n in want if n.startswith("0/")}
    masks = {n for n in want if n.startswith("2/")}
    for n in masks | {"3"}:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    bf16 = {n for n, leaf in named_leaves(tnew) if n in params and leaf.dtype == torch.bfloat16}
    flipped = total = 0
    for n in params:
        ulp = np.abs(want[n]) * 2.0**-7 * (n in bf16)
        d = np.abs(got[n] - want[n])
        off = d > 1e-6 + 1e-5 * np.abs(want[n]) + ulp
        assert (d[off] <= 2 * LR + 1e-6 + ulp[off]).all(), n
        flipped += int(off.sum())
        total += d.size
    assert flipped <= FLIP_FRACTION[compute_dtype] * total, (flipped, total)
    for n in want:
        assert np.isfinite(got[n]).all(), n

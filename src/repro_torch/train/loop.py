"""Train-step builder + fault-tolerant training loop.

The port of ``repro.train.loop``.  ``build_train_step`` closes over (arch,
configs) and returns ``step(state, batch) → (state, metrics)``:

  * sparsity-aware training (§III.A): masks applied to the params in the
    forward, gradients masked, masks refreshed on the Zhu & Gupta cubic
    schedule every ``mask_update_every`` steps (from the updated params at
    the step before the increment, as the reference's ``lax.cond``; here a
    host ``if`` on the caller's step counter, ``step_index``, so a step
    reads nothing back from the device);
  * L2 regularization (§III.A) on the unexcluded leaves;
  * gradient accumulation over ``grad_accum`` microbatches into an fp32
    accumulator, or through the int8 accumulator (``compressed_accum``,
    ``train.grad_compression``);
  * remat of every layer (``TrainConfig.remat``, the config's
    ``remat_policy``).

``plan`` (a ``sharding.mesh.MeshPlan``) shards the step: the state's
leaves are DTensors in ``sharding.partition``'s layouts (the batch sharded
over dp), the forward runs under the plan, each microbatch is every
device's own share of its rows, and the optimizer's global norm sums the
leaves' partial squares in one reduction.  ``TrainConfig.moe_aux_coeff`` is declared and never read, as in the
reference (whose step adds no auxiliary loss).

``train_loop`` is the host-side driver: it resumes from ``state.step``,
checkpoints periodically and on SIGTERM (preemption), and feeds
step-indexed data.  The step's sections are marked for the profiler
(``train.forward_backward``, ``train.loss``, ``train.optimizer``,
``train.mask_refresh``).
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.core.sparsity import SparsityConfig, build_masks, l2_regularization
from repro_torch.models.transformer import loss_fn as ce_loss
from repro_torch.train.grad_compression import add_compressed
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.train_state import TrainState
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import named_leaves, tree_map, tree_map_with_path_names

log = get_logger("train")

INPUT_KEYS = ("tokens", "embeds", "positions")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    sparsity: SparsityConfig | None = None
    mask_update_every: int = 50
    l2_coeff: float = 0.0  # §III.A L2 term (e.g. 1e-5)
    grad_accum: int = 1
    remat: bool = True
    compressed_accum: bool = False  # int8 microbatch gradients
    moe_aux_coeff: float = 0.0  # declared, never read (as in the reference)


def make_forward_loss(arch, tc: TrainConfig, cfg=None,
                      plan=None) -> Callable[[Any, dict], torch.Tensor]:
    """(params, batch) → the scalar training loss: cross-entropy of the
    arch's forward on the batch's inputs, plus ``l2_coeff`` · L2."""
    cfg = cfg or arch.cfg

    def forward_loss(params, batch) -> torch.Tensor:
        kwargs = {k: batch[k] for k in INPUT_KEYS if k in batch}
        logits, _ = arch.forward(params, cfg, plan=plan, remat=tc.remat, **kwargs)
        with record_function("train.loss"):
            loss = ce_loss(logits, batch["labels"])
            if tc.l2_coeff:
                loss = loss + tc.l2_coeff * l2_regularization(params)
        return loss

    return forward_loss


def value_and_grad(forward_loss, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """(loss, gradients) of ``forward_loss`` at ``params`` (leaves that
    require grad); a leaf the loss does not reach gets zeros, as in JAX."""
    names, leaves = zip(*named_leaves(params))
    with torch.enable_grad(), record_function("train.forward_backward"):
        loss = forward_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    by_name = dict(zip(names, grads))
    return loss.detach(), tree_map_with_path_names(lambda name, _: by_name[name], params)


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows i·B/n … (i+1)·B/n of v; of a DTensor, of each device's own rows."""
    if isinstance(v, DTensor):
        return DTensor.from_local(_rows(v.to_local(), i, n), v.device_mesh, v.placements,
                                  run_check=False)
    m = v.shape[0] // n
    return v[i * m:(i + 1) * m]


def _microbatch(batch: dict, i: int, n: int) -> dict:
    """Microbatch i of n: rows i·B/n … (i+1)·B/n of every array (the
    reference's reshape to (n, B/n, …) and its scan over the first axis);
    under a mesh, of each device's own rows, so no row moves between
    devices (the accumulated gradient is the same sum)."""
    return {k: _rows(v, i, n) for k, v in batch.items()}


def build_train_step(arch, tc: TrainConfig, cfg=None,
                     plan=None) -> Callable[..., tuple]:
    """``step(state, batch, step_index=None) → (state, metrics)``.
    ``step_index`` is the caller's count of the state's step (the host's
    copy of ``state.step``), which decides the mask refresh; None reads
    ``state.step`` (one read back from the device)."""
    forward_loss = make_forward_loss(arch, tc, cfg, plan)

    def step(state: TrainState, batch: dict,
             step_index: int | None = None) -> tuple[TrainState, dict]:
        if plan is None or plan.mesh is None:
            return _step(state, batch, step_index)
        with plan.replicating():
            return _step(state, batch, step_index)

    def _step(state: TrainState, batch: dict, step_index: int | None) -> tuple:
        params = state.params
        if state.masks is not None:  # §III.A forward-graph masking
            masked = tree_map(lambda p, m: (p.detach() * m.to(p.dtype)).requires_grad_(),
                              params, state.masks)
        else:
            masked = tree_map(lambda p: p.detach().requires_grad_(), params)

        if tc.grad_accum > 1:
            n = tc.grad_accum
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), masked)
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(n):
                loss_i, g = value_and_grad(forward_loss, masked, _microbatch(batch, i, n))
                if tc.compressed_accum:
                    grads = add_compressed(grads, g, n)
                else:
                    grads = tree_map(lambda a, b: a + b.to(a.dtype) / n, grads, g)
                loss = loss + loss_i / n
                del g
        else:
            loss, grads = value_and_grad(forward_loss, masked, batch)
        del masked
        # each gradient in its leaf's layout (a reduction may leave it partial
        # or in another one), as the reference's step gives them
        grads = tree_map(_laid_out_as, grads, params)

        with record_function("train.optimizer"):
            new_params, new_opt, om = adamw_update(params, grads, state.opt_state, state.step,
                                                   tc.opt, state.masks)
        del grads

        new_masks = state.masks
        if step_index is None and state.masks is not None:
            step_index = int(state.step)
        if state.masks is not None and tc.sparsity is not None and (
                step_index % tc.mask_update_every == 0):
            with record_function("train.mask_refresh"):
                new_masks = build_masks(new_params, tc.sparsity, step=state.step)

        new_state = TrainState(params=new_params, opt_state=new_opt, masks=new_masks,
                               step=state.step + 1)
        # metrics as plain tensors, the same on every rank (a sharded loss is
        # a partial sum until reduced)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in {"loss": loss, **om}.items()}
        return new_state, metrics

    return step


def train_loop(
    step_fn,
    state: TrainState,
    data_iter,
    n_steps: int,
    checkpointer=None,
    checkpoint_every: int = 100,
    on_metrics: Callable[[int, dict], None] | None = None,
) -> TrainState:
    """Fault-tolerant host loop: resumes from ``state.step``, checkpoints
    periodically and on SIGTERM (preemption), reports each step's metrics
    as floats."""
    stop = {"flag": False}

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        log.warning("SIGTERM received — checkpointing and stopping")
        stop["flag"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)
    try:
        start = int(state.step)
        for i in range(start, n_steps):
            batch = data_iter(i)
            state, metrics = step_fn(state, batch, i)
            if on_metrics is not None:
                on_metrics(i, {k: float(v) for k, v in metrics.items()})
            if checkpointer is not None and (
                (i + 1) % checkpoint_every == 0 or stop["flag"] or i + 1 == n_steps
            ):
                checkpointer.save(state, step=i + 1)
            if stop["flag"]:
                break
    finally:
        signal.signal(signal.SIGTERM, old)
    return state

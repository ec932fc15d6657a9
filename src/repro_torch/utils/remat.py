"""Rematerialisation: a layer's activations recomputed in the backward pass.

The port of the reference's ``jax.checkpoint`` around its layer scans.
``remat(fn, policy)`` runs fn under ``torch.utils.checkpoint`` (non-reentrant)
while autograd records, and plainly otherwise:

  * ``"nothing"`` (``jax.checkpoint_policies.nothing_saveable``): nothing
    inside fn is saved; the backward pass runs fn again from its inputs.
  * ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
    2-D products (``aten.mm``, the dense projections) are saved and the rest
    is recomputed; the attention's batched products (``aten.bmm``) are not
    saved, as the reference keeps no dot with batch dims.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("nothing", "dots")


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable[..., Any], policy: str = "nothing") -> Callable[..., Any]:
    """fn, its activations recomputed in the backward pass by ``policy``."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of {POLICIES}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_products))
        return checkpoint(fn, *args, use_reentrant=False)

    return run

"""TrainState: params + optimizer moments + sparsity masks + step.

The port of ``repro.train.train_state``.  A named tuple, so it flattens as
the reference's pytree node does, to (params, opt_state, masks, step): the
checkpointer names its leaves ``0/<params path>``, ``1/m/…``, ``1/v/…``,
``2/<masks path>`` and ``3``, the reference's names.  ``abstract_train_state``
is the dry run's mirror of a state: its leaves carry shapes and dtypes on
the ``meta`` device (``launch.steps`` lays them out on a mesh).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.sparsity import build_masks
from repro_torch.train.optimizer import adamw_init
from repro_torch.utils.tree import named_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: dict[str, Any]  # {"m": tree, "v": tree}
    masks: Any | None  # sparsity masks (the params' nesting) or None
    step: torch.Tensor  # () int32, on the params' device


def init_train_state(params: Any, opt_cfg, sparsity_cfg=None) -> TrainState:
    device = next(leaf for _, leaf in named_leaves(params)).device
    masks = None if sparsity_cfg is None else build_masks(params, sparsity_cfg, step=0)
    return TrainState(params=params, opt_state=adamw_init(params, opt_cfg), masks=masks,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def abstract_train_state(abstract_params: Any, opt_cfg, with_masks: bool = False) -> TrainState:
    """A ``TrainState`` of ``meta`` tensors (the dry run's, no allocation):
    moments in ``opt_cfg.moment_dtype``, masks in the params' dtypes."""
    mdt = getattr(torch, opt_cfg.moment_dtype)

    def like(dtype=None):
        return lambda p: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")

    return TrainState(
        params=abstract_params,
        opt_state={"m": tree_map(like(mdt), abstract_params),
                   "v": tree_map(like(mdt), abstract_params)},
        masks=tree_map(like(), abstract_params) if with_masks else None,
        step=torch.empty((), dtype=torch.int32, device="meta"),
    )

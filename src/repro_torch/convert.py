"""Carry JAX parameters across to the port.

``params_from_jax`` takes the reference's param tree with every leaf already
a numpy array (``np.array(leaf)`` of each JAX array: a writable copy, since
``np.asarray`` of a JAX array is read-only) and returns the same nesting of
torch tensors on ``device``, dtypes kept (bf16 too, for the configs whose
``param_dtype`` is bfloat16): the stacked (L, …) layer leaves, the MoE
block's router and (L, E, …) expert stacks, the hybrid's ``mamba_layers``
/ ``shared`` and rwkv's ``layers`` trees (their fp32 leaves, ``A_log``,
``D``, ``dt_bias``, ``mu``, ``w0``, ``u``, ``decay_lora_*``, stay fp32), the ``qvalues`` / ``qscales``
/ ``qindices`` leaves of a quantized tree (int8, fp32, int32), the
embedding, norm scales and biases (``norm_bias``, ``bias``) and fp kernels.  Lists and
tuples are walked as dicts are (the CNNs' ``{"conv": [...], "fc": [...]}``).

``linear_params_from_jax`` does the same for one converted linear layer:
the reference's ``SonicLinearParams`` with numpy fields (what
``jax.tree_util.tree_map(np.array, params)`` gives, ``k_blocks`` kept),
whichever of its formats is populated: the dense ``w``, ``ClusteredWeight``,
``BlockSparseWeight``, ``SonicWeight`` or ``BlockSparseWeightInt8``.

``train_state_from_numpy`` takes the reference's ``TrainState`` with every
leaf a numpy array (``jax.tree_util.tree_map(np.array, state)``) and
returns the port's ``train.TrainState``: params, moments and masks as
``params_from_jax`` carries them (bf16 moments too), the step a 0-dim int32
tensor.

All three read numpy arrays and attributes only, so they need no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import ClusteredWeight
from repro_torch.core.sonic_layers import (
    BlockSparseWeight,
    BlockSparseWeightInt8,
    SonicLinearParams,
)
from repro_torch.kernels.sonic_matmul.ops import SonicWeight
from repro_torch.train.train_state import TrainState


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(a).__name__}")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read:
        # its 16 bits as uint16, viewed back as torch's bf16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def train_state_from_numpy(state, device) -> TrainState:
    masks = None if state.masks is None else params_from_jax(state.masks, device)
    return TrainState(params=params_from_jax(state.params, device),
                      opt_state=params_from_jax(dict(state.opt_state), device), masks=masks,
                      step=_tensor(state.step, device).to(torch.int32))


def linear_params_from_jax(p, device) -> SonicLinearParams:
    def t(a):
        return _tensor(a, device)

    out = SonicLinearParams()
    if p.w is not None:
        out.w = t(p.w)
    if p.clustered is not None:
        out.clustered = ClusteredWeight(t(p.clustered.indices), t(p.clustered.codebook))
    if p.block_sparse is not None:
        bs = p.block_sparse
        out.block_sparse = BlockSparseWeight(t(bs.values), t(bs.indices), int(bs.k_blocks))
    if p.sonic is not None:
        sw = p.sonic
        out.sonic = SonicWeight(t(sw.idx_values), t(sw.codebook), t(sw.indices),
                                int(sw.k_blocks))
    if p.block_sparse_int8 is not None:
        q = p.block_sparse_int8
        out.block_sparse_int8 = BlockSparseWeightInt8(t(q.values), t(q.scales), t(q.indices),
                                                      int(q.k_blocks))
    return out

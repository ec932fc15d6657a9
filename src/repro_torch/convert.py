"""Carry JAX parameters across to the port.

``params_from_jax`` takes the reference's param tree with every leaf already
a numpy array (``np.array(leaf)`` of each JAX array: a writable copy, since
``np.asarray`` of a JAX array is read-only) and returns the same nesting of
torch tensors on ``device``, dtypes kept: the stacked (L, …) layer leaves,
the ``qvalues`` / ``qscales`` / ``qindices`` leaves of a quantized tree
(int8, fp32, int32), the embedding, norm scales and fp kernels.

``linear_params_from_jax`` does the same for one converted linear layer:
the reference's ``SonicLinearParams`` with numpy fields (what
``jax.tree_util.tree_map(np.array, params)`` gives, ``k_blocks`` kept),
whichever of its formats is populated: the dense ``w``, ``ClusteredWeight``,
``BlockSparseWeight``, ``SonicWeight`` or ``BlockSparseWeightInt8``.

Both read numpy arrays and attributes only, so they need no JAX.
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


def _tensor(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(a).__name__}")
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: dict, device) -> dict:
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


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

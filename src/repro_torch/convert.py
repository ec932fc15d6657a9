"""Carry a JAX parameter tree across to the port.

``params_from_jax`` takes the reference's param tree with every leaf already
a numpy array (``np.array(leaf)`` of each JAX array: a writable copy, since
``np.asarray`` of a JAX array is read-only) and returns the same nesting of
torch tensors on ``device``, dtypes kept: the stacked (L, …) layer leaves,
the ``qvalues`` / ``qscales`` / ``qindices`` leaves of a quantized tree
(int8, fp32, int32), the embedding, norm scales and fp kernels.  It reads
numpy only, so it needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device) -> dict:
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(tree).__name__}")
    return torch.from_numpy(tree).to(device)

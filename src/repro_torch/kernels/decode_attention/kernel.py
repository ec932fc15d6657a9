"""Decode-style attention over a dense KV cache: the Hopper kernel's wrapper.

Replaces no TPU kernel: the JAX package computes decode attention in plain
jnp (``src/repro/models/layers.py`` ``decode_attention``), and the port's
plain version is ``models.layers.decode_attention_plain``, which
``layers.decode_attention`` runs on CPU tensors.  On the card that plain
version laid the whole S_max cache of every slot out anew in every layer
and step; the kernel (``csrc/decode_attention.cu``; its note gives the
bound and the design) reads each live K/V row once, in place, through the
cache's strides, in splits of ``build.DA_SPLIT`` positions whose partial
softmaxes a second launch combines in one order, so a row's bits follow
its own query, its slot's cache and its position alone: not C, B or S_max.
The launch counts in ``decode_attention_kernel.launches`` and, all on the
CUDA cores, ``.routes``.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
    """out (B, C, H, Dh) in the cache's type: query row c of slot b (q (B,
    C, H, Dh)) over the cache's positions 0 … min(pos[b] + c, S_max − 1) (k,
    v (B, S_max, KH, Dh)), scores and softmax in fp32.

    A CUDA tensor launches the kernel (and counts the launch) or raises;
    operands without data (meta or fake tensors, as in the dry run) are
    checked and get an empty output of the right shape."""
    if q.device.type == "meta" or is_fake(q):
        build.check_decode_attention(q, k_cache, v_cache, pos)
        return torch.empty(q.shape, dtype=v_cache.dtype, device=q.device)
    out = build.launch_decode_attention(q, k_cache, v_cache, pos)
    decode_attention_kernel.launches += 1
    decode_attention_kernel.routes[build.CUDA_CORES] += 1
    return out


decode_attention_kernel.launches = 0
decode_attention_kernel.routes = {build.CUDA_CORES: 0}

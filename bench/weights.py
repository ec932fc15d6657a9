"""Random bf16 weights made from ``--seed`` on the device, one leaf of one
layer at a time from its own generator, so that the program's set-up (a
family's ``param_tree``) and the plain reference (which makes each layer
again after the window) draw the same values.  Any family draws its leaves
with these; which leaves a model has, and their shapes, is the family's.

A projection W (K, N) is drawn N(0, 1) and scaled per (bk, bn) block: in
each column block, a seed-chosen ``kept`` of the K-blocks at
(K · kept / Kb)^-1/2 and the rest at a quarter of that.  That is the shape
SONIC's C1 step meets after sparsity-aware training, where the blocks it
prunes have been driven small; it also leaves no two block norms close
enough for rounding in a sum to reorder which blocks the top-|L1| pruning
keeps, so the program and the reference prune the same blocks.  The
embedding is N(0, 1) as ``models.layers.embed_init`` draws it.
"""
from __future__ import annotations

import hashlib

import torch

MINOR = 0.25  # the pruned blocks' scale, against the kept blocks'
DTYPE = torch.bfloat16


def generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    """The generator of leaf ``name`` of ``layer`` (−1: outside the layers)."""
    digest = hashlib.sha256(f"{seed}:{name}:{layer}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & (2**63 - 1))


def block_scaled(model: dict, seed: int, name: str, layer: int, shape: tuple[int, int], device,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 projection ``name`` of ``layer``, of ``shape`` (K, N), block
    scaled by the configuration's ``compression`` (block, sparsity);
    written into ``out`` when given."""
    k, n = shape
    bk, bn = model["compression"]["block"]
    kb, nb = k // bk, n // bn
    kept = max(int(round(kb * (1.0 - model["compression"]["sparsity"]))), 1)
    g = generator(seed, name, layer, device)
    w = torch.randn((k, n), generator=g, dtype=DTYPE, device=device, out=out)
    order = torch.rand((nb, kb), generator=g, device=device).argsort(dim=1)
    major = torch.zeros((nb, kb), dtype=torch.bool, device=device)
    major.scatter_(1, order[:, :kept], True)
    hi = (k * kept / kb) ** -0.5
    scale = torch.where(major, hi, hi * MINOR).to(DTYPE).T  # (kb, nb)
    w.view(kb, bk, nb, bn).mul_(scale[:, None, :, None])
    return w


def embedding(model: dict, seed: int, device) -> torch.Tensor:
    g = generator(seed, "embed", -1, device)
    return torch.randn((model["vocab_size"], model["hidden_size"]), generator=g, dtype=DTYPE,
                       device=device)

"""Random bf16 weights made from ``--seed`` on the device, one leaf of one
layer at a time from its own generator, so that the program's set-up and the
plain reference (which makes each layer again after the window) draw the
same values.

Every projection W (K, N) is drawn N(0, 1) and scaled per (bk, bn) block:
in each column block, a seed-chosen ``kept`` of the K-blocks at
(K · kept / Kb)^-1/2 and the rest at a quarter of that.  That is the shape
SONIC's C1 step meets after sparsity-aware training, where the blocks it
prunes have been driven small; it also leaves no two block norms close
enough for rounding in a sum to reorder which blocks the top-|L1| pruning
keeps, so the program and the reference prune the same blocks.  The
embedding is N(0, 1) as ``models.layers.embed_init`` draws it; the norm
scales are ones, as ``models.layers.norm_init`` makes them.
"""
from __future__ import annotations

import hashlib

import torch

MINOR = 0.25  # the pruned blocks' scale, against the kept blocks'
DTYPE = torch.bfloat16


def _generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}:{name}:{layer}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & (2**63 - 1))


def shapes(model: dict) -> dict[str, tuple[int, int]]:
    """(K, N) of each projection of a layer, by its name in the param tree."""
    d, h, kh = model["hidden_size"], model["num_attention_heads"], model["num_key_value_heads"]
    hd, f = model["head_dim"], model["intermediate_size"]
    return {"attn/wq": (d, h * hd), "attn/wk": (d, kh * hd), "attn/wv": (d, kh * hd),
            "attn/wo": (h * hd, d), "ffn/wi": (d, f), "ffn/wg": (d, f), "ffn/wo": (f, d)}


def projection(model: dict, seed: int, name: str, layer: int, device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 (K, N) projection ``name`` of ``layer`` (−1: the LM head),
    written into ``out`` when given."""
    k, n = (model["hidden_size"], model["vocab_size"]) if layer < 0 else shapes(model)[name]
    bk, bn = model["compression"]["block"]
    kb, nb = k // bk, n // bn
    kept = max(int(round(kb * (1.0 - model["compression"]["sparsity"]))), 1)
    g = _generator(seed, name, layer, device)
    w = torch.randn((k, n), generator=g, dtype=DTYPE, device=device, out=out)
    order = torch.rand((nb, kb), generator=g, device=device).argsort(dim=1)
    major = torch.zeros((nb, kb), dtype=torch.bool, device=device)
    major.scatter_(1, order[:, :kept], True)
    hi = (k * kept / kb) ** -0.5
    scale = torch.where(major, hi, hi * MINOR).to(DTYPE).T  # (kb, nb)
    w.view(kb, bk, nb, bn).mul_(scale[:, None, :, None])
    return w


def embedding(model: dict, seed: int, device) -> torch.Tensor:
    g = _generator(seed, "embed", -1, device)
    return torch.randn((model["vocab_size"], model["hidden_size"]), generator=g, dtype=DTYPE,
                       device=device)


def param_tree(model: dict, seed: int, device) -> dict:
    """The port's param tree (``models.transformer.init_params``' leaf names,
    stacked (L, …) layer leaves), every weight bf16."""
    n_layers, d = model["num_hidden_layers"], model["hidden_size"]
    layers: dict = {"attn": {}, "ffn": {}}
    for name, (k, n) in shapes(model).items():
        block, proj = name.split("/")
        stack = torch.empty((n_layers, k, n), dtype=DTYPE, device=device)
        for i in range(n_layers):
            projection(model, seed, name, i, device, out=stack[i])
        layers[block][proj] = {"kernel": stack}
    for norm in ("ln1", "ln2"):
        layers[norm] = {"scale": torch.ones((n_layers, d), dtype=torch.float32, device=device)}
    return {"embed": {"embedding": embedding(model, seed, device)}, "layers": layers,
            "final_norm": {"scale": torch.ones((d,), dtype=torch.float32, device=device)},
            "lm_head": {"kernel": projection(model, seed, "lm_head", -1, device)}}

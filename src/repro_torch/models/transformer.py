"""Decoder-only transformer LM: embed → L × layer → final norm → LM head.

The port of ``repro.models.transformer`` for the dense decoder path.  Layer
params are stacked on a leading (n_layers,) axis as in the reference (so
converted JAX trees load as they are); ``trunk_apply`` walks them with a
Python loop where the reference ran ``lax.scan``.  One code path serves
prefill and decode; the mode is picked by (cache, cache_pos) exactly as in
``layers.attention_apply``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict[str, Any]


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen`` (which must live on ``device``)."""
    lead = (cfg.n_layers,)
    return {
        "embed": L.embed_init(gen, cfg, device),
        "layers": {
            "ln1": L.norm_init(cfg, device, lead),
            "attn": L.attention_init(gen, cfg, device, lead),
            "ln2": L.norm_init(cfg, device, lead),
            "ffn": L.ffn_init(gen, cfg, device, lead),
        },
        "final_norm": L.norm_init(cfg, device),
        "lm_head": L.lm_head_init(gen, cfg, device),
    }


def layer_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    h, _ = L.attention_apply(p["attn"], cfg, L.norm_apply(p["ln1"], x), positions,
                             cache=cache, cache_pos=cache_pos)
    x = x + h
    return x + L.ffn_apply(p["ffn"], L.norm_apply(p["ln2"], x))


def _layer(tree: Params, i: int) -> Params:
    """Layer i's params: a view of every stacked (L, …) leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def trunk_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D) — post-embedding
    positions: torch.Tensor,
    cache: dict | None = None,  # {"k": (L,B,S_max,KH,Dh), "v": ...}
    cache_pos: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Apply the stacked layers in order.  The cache is updated in place
    (each layer writes its (B, S_max, KH, Dh) view) and returned."""
    for i in range(cfg.n_layers):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        x = layer_apply(_layer(params["layers"], i), cfg, x, positions, kv, cache_pos)
    return x, cache


def forward(
    params: Params,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor | None = None,  # (B, S); default arange
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,  # (B,) decode step
) -> tuple[torch.Tensor, dict | None]:
    """→ (logits (B, S, V), cache)."""
    x = L.embed_apply(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        if cache_pos is not None:
            # decode: absolute positions continue from each row's cache offset
            positions = cache_pos[:, None] + positions
    x, cache = trunk_apply(params, cfg, x, positions, cache, cache_pos)
    x = L.norm_apply(params["final_norm"], x)
    return L.lm_head_apply(params["lm_head"], x), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    """Dense KV cache: {"k", "v"} each (L, B, max_len, KH, Dh), zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

"""Decoder-only transformer LM: embed → L × layer → final norm → LM head.

The port of ``repro.models.transformer`` for the dense decoder path.  Layer
params are stacked on a leading (n_layers,) axis as in the reference (so
converted JAX trees load as they are); ``trunk_apply`` walks them with a
Python loop where the reference ran ``lax.scan``.  One code path serves
prefill, chunk-resume, decode and the verify window over dense, paged and
int8 KV caches; the mode is picked by (cache, cache_pos, block_table,
decode_chunk) exactly as in ``layers.attention_apply``.
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
    cache: tuple | None = None,  # (k, v) or, int8 KV, (k, v, k_scale, v_scale)
    cache_pos: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,
    decode_chunk: bool = False,
    query_rows: int = 0,
) -> torch.Tensor:
    h, _ = L.attention_apply(
        p["attn"], cfg, L.norm_apply(p["ln1"], x), positions,
        cache=None if cache is None else cache[:2],
        cache_scales=cache[2:] if cache is not None and len(cache) == 4 else None,
        cache_pos=cache_pos, block_table=block_table, decode_chunk=decode_chunk,
        query_rows=query_rows)
    x = x + h
    return x + L.ffn_apply(p["ffn"], L.norm_apply(p["ln2"], x))


def _layer(tree: Params, i: int) -> Params:
    """Layer i's params: a view of every stacked (L, …) leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


CACHE_LEAVES = ("k", "v", "k_scale", "v_scale")  # the int8-KV cache's order


def trunk_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D) — post-embedding
    positions: torch.Tensor,
    cache: dict | None = None,  # {"k", "v"[, "k_scale", "v_scale"]}: (L, …)
    cache_pos: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,  # paged: the leaves are pools
    decode_chunk: bool = False,  # speculative-verify window
    query_rows: int = 0,  # decode-style attention's padded query rows
) -> tuple[torch.Tensor, dict | None]:
    """Apply the stacked layers in order.  The cache is updated in place
    (each layer writes its view of every leaf) and returned.  With
    ``block_table`` the leaves are block pools (L, n_blocks, block_len, …),
    the table shared by every layer; with ``k_scale`` / ``v_scale`` leaves
    the cache is int8 KV."""
    leaves = [] if cache is None else [n for n in CACHE_LEAVES if n in cache]
    for i in range(cfg.n_layers):
        kv = tuple(cache[n][i] for n in leaves) or None
        x = layer_apply(_layer(params["layers"], i), cfg, x, positions, kv, cache_pos,
                        block_table, decode_chunk, query_rows)
    return x, cache


def forward(
    params: Params,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor | None = None,  # (B, S); default arange
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,  # (B,) decode step / chunk-resume start
    block_table: torch.Tensor | None = None,  # (B, MB) — paged KV
    decode_chunk: bool = False,  # speculative-verify window
    query_rows: int = 0,  # decode-style attention's padded query rows
) -> tuple[torch.Tensor, dict | None]:
    """→ (logits (B, S, V), cache).

    ``cache_pos`` with S > 1 resumes prefill mid-prompt: the S tokens are
    the chunk at absolute positions ``cache_pos .. cache_pos+S-1`` over the
    cache's prefix.  ``decode_chunk=True`` (with ``cache_pos``, S > 1) is
    the speculative-verify window: the same writes, and each row attends as
    the sequential decode step it replaces (``layers.decode_attention``,
    its query rows padded to ``query_rows``, 0 = the device's default)."""
    x = L.embed_apply(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        if cache_pos is not None:
            # decode / chunk-resume: absolute positions continue from each
            # row's cache offset
            positions = cache_pos[:, None] + positions
    x, cache = trunk_apply(params, cfg, x, positions, cache, cache_pos, block_table,
                           decode_chunk, query_rows)
    x = L.norm_apply(params["final_norm"], x)
    return L.lm_head_apply(params["lm_head"], x), cache


def _kv_cache(shape: tuple[int, ...], device, dtype, quant_int8: bool) -> dict:
    if quant_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16, cache_quant_int8: bool = False) -> dict:
    """Dense KV cache: {"k", "v"} each (L, B, max_len, KH, Dh), zeros.  With
    ``cache_quant_int8`` (the reference's ``MeshPlan.cache_quant_int8``) k
    and v are int8 and ``k_scale`` / ``v_scale`` (L, B, max_len, KH) fp32
    hold one scale per position and head.  One decode step maps the cache
    to the same leaves (``registry.check_decode_cache_carry``)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return _kv_cache(shape, device, dtype, cache_quant_int8)


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_len: int, device,
                     dtype=torch.bfloat16, cache_quant_int8: bool = False) -> dict:
    """Paged serving cache: a pool of KV blocks shared by every slot, leaves
    (L, n_blocks, block_len, KH, Dh) (the int8 scale pools drop Dh), the
    block axis where the dense layout's slot axis is
    (``registry.CACHE_BLOCK_AXIS``).  The serving layer reserves the first
    n_slots blocks as per-slot scratch (``layers.paged_cache_write``)."""
    if n_blocks < 2 or block_len < 1:
        raise ValueError(f"a pool needs n_blocks >= 2 and block_len >= 1, got "
                         f"{(n_blocks, block_len)}")
    shape = (cfg.n_layers, n_blocks, block_len, cfg.n_kv_heads, cfg.head_dim)
    return _kv_cache(shape, device, dtype, cache_quant_int8)

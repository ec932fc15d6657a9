"""Transformer LM assembly: dense / MoE / encoder / VLM families.

embed (or the caller's embeddings) → L × layer → final norm → LM head (or
the tied embedding).  The port of ``repro.models.transformer``.  Layer
params are stacked on a leading (n_layers,) axis as in the reference (so
converted JAX trees load as they are); ``trunk_apply`` walks them with a
Python loop where the reference ran ``lax.scan``.  One code path serves
the encoder forward, prefill, chunk-resume, decode and the verify window
over dense, paged and int8 KV caches; the mode is picked by (cache,
cache_pos, block_table, decode_chunk) exactly as in
``layers.attention_apply``.  A layer's FFN is the MoE block
(``models.moe``) when the config has experts.

``plan`` (a ``sharding.mesh.MeshPlan``; None = one device) shards the
forward as the reference's: the residual stream sequence-parallel
(``(dp, tp, None)`` when S > 1), each sublayer's output constrained before
its residual add, the logits vocab-sharded, KV heads repeated
``plan.kv_repeat``× in the cache.  A meshed forward takes DTensor params and
inputs and runs under ``implicit_replication`` (the positions and masks it
makes are the same on every rank).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.sharding.mesh import MeshPlan
from repro_torch.utils.remat import remat as remat_fn

NO_PLAN = MeshPlan()

Params = dict[str, Any]


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen`` (which must live on ``device``)."""
    lead = (cfg.n_layers,)
    embed = L.embed_init(gen, cfg, device)
    layers = {
        "ln1": L.norm_init(cfg, device, lead),
        "attn": L.attention_init(gen, cfg, device, lead),
        "ln2": L.norm_init(cfg, device, lead),
    }
    if cfg.n_experts:
        layers["moe"] = M.moe_init(gen, cfg, device, lead)
    else:
        layers["ffn"] = L.ffn_init(gen, cfg, device, lead)
    p = {"embed": embed, "layers": layers,
         "final_norm": L.norm_init(cfg, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.lm_head_init(gen, cfg, device)
    return p


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
    plan: MeshPlan = NO_PLAN,
) -> torch.Tensor:
    s = x.shape[1]
    seq = plan.tp if s > 1 else None  # SP only when the seq dim exists
    h, _ = L.attention_apply(
        p["attn"], cfg, L.norm_apply(p["ln1"], x), positions, plan=plan,
        cache=None if cache is None else cache[:2],
        cache_scales=cache[2:] if cache is not None and len(cache) == 4 else None,
        cache_pos=cache_pos, block_table=block_table, causal=not cfg.encoder_only,
        decode_chunk=decode_chunk, query_rows=query_rows)
    # constrain the sublayer OUTPUT (a TP partial sum) before the residual
    # add, so the partial sum reduce-scatters into the sequence shards
    h = plan.constrain(h, plan.dp, seq, None)
    x = x + h
    hin = L.norm_apply(p["ln2"], x)
    if cfg.n_experts:
        h2 = M.moe_apply(p["moe"], cfg, hin, plan=plan)
    else:
        h2 = L.ffn_apply(p["ffn"], hin)
    h2 = plan.constrain(h2, plan.dp, seq, None)
    return plan.constrain(x + h2, plan.dp, seq, None)


def layer_trees(tree: Params, n: int) -> list[Params]:
    """The params of each of the n layers: views of every stacked (L, …)
    leaf, one ``unbind`` per leaf (whose backward stacks the n gradients
    at once, where n indexed views would each scatter into a zero tensor
    of the whole stack's size)."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    per_key = {k: layer_trees(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


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
    remat: bool = False,  # training: recompute each layer in the backward
    plan: MeshPlan = NO_PLAN,
) -> tuple[torch.Tensor, dict | None]:
    """Apply the stacked layers in order.  The cache is updated in place
    (each layer writes its view of every leaf) and returned.  With
    ``block_table`` the leaves are block pools (L, n_blocks, block_len, …),
    the table shared by every layer; with ``k_scale`` / ``v_scale`` leaves
    the cache is int8 KV.  ``remat`` (without a cache) recomputes each
    layer in the backward pass by ``cfg.remat_policy``."""
    leaves = [] if cache is None else [n for n in CACHE_LEAVES if n in cache]
    apply = remat_fn(layer_apply, cfg.remat_policy) if remat and cache is None else layer_apply
    for i, lp in enumerate(layer_trees(params["layers"], cfg.n_layers)):
        kv = tuple(cache[n][i] for n in leaves) or None
        x = apply(lp, cfg, x, positions, kv, cache_pos, block_table, decode_chunk, query_rows,
                  plan)
    return x, cache


def forward(
    params: Params,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor | None = None,  # (B, S) int
    embeds: torch.Tensor | None = None,  # (B, S, D): stubbed modality frontends
    positions: torch.Tensor | None = None,  # (B, S) / (B, 3, S); default arange
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,  # (B,) decode step / chunk-resume start
    block_table: torch.Tensor | None = None,  # (B, MB) — paged KV
    decode_chunk: bool = False,  # speculative-verify window
    query_rows: int = 0,  # decode-style attention's padded query rows
    remat: bool = False,  # training: recompute each layer in the backward
    plan: MeshPlan | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """→ (logits (B, S, V), cache).

    ``cache_pos`` with S > 1 resumes prefill mid-prompt: the S tokens are
    the chunk at absolute positions ``cache_pos .. cache_pos+S-1`` over the
    cache's prefix.  ``decode_chunk=True`` (with ``cache_pos``, S > 1) is
    the speculative-verify window: the same writes, and each row attends as
    the sequential decode step it replaces (``layers.decode_attention``;
    its plain version pads the query rows to ``query_rows``, 0 = the
    device's default).
    ``embeds`` replaces the token embedding (hubert's frames, qwen2-vl's
    patch and text embeddings); M-RoPE positions are (B, 3, S)."""
    plan = plan or NO_PLAN
    with plan.replicating():
        return _forward(params, cfg, plan, tokens, embeds, positions, cache, cache_pos,
                        block_table, decode_chunk, query_rows, remat)


def _forward(params, cfg, plan, tokens, embeds, positions, cache, cache_pos, block_table,
             decode_chunk, query_rows, remat):
    dtype = getattr(torch, cfg.compute_dtype)
    if embeds is None:
        if tokens is None:
            raise ValueError("forward needs tokens or embeds")
        x = L.embed_apply(params["embed"], tokens, dtype)
    else:
        x = embeds.to(dtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        if cache_pos is not None:
            # decode / chunk-resume: absolute positions continue from each
            # row's cache offset
            positions = cache_pos[:, None] + positions
    x = plan.constrain(x, plan.dp, plan.tp if s > 1 else None, None)
    x, cache = trunk_apply(params, cfg, x, positions, cache, cache_pos, block_table,
                           decode_chunk, query_rows, remat, plan)
    x = L.norm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.tied_head_apply(params["embed"], x)
    else:
        logits = L.lm_head_apply(params["lm_head"], x)
    return plan.constrain(logits, plan.dp, None, plan.tp), cache


def _kv_cache(shape: tuple[int, ...], device, dtype, quant_int8: bool) -> dict:
    if quant_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16, cache_quant_int8: bool = False,
               plan: MeshPlan | None = None) -> dict:
    """Dense KV cache: {"k", "v"} each (L, B, max_len, KH, Dh), zeros.  With
    ``cache_quant_int8`` (the reference's ``MeshPlan.cache_quant_int8``) k
    and v are int8 and ``k_scale`` / ``v_scale`` (L, B, max_len, KH) fp32
    hold one scale per position and head.  One decode step maps the cache
    to the same leaves (``registry.check_decode_cache_carry``).  Under a
    ``plan`` the KV heads are ``plan.kv_repeat``× n_kv_heads and
    ``plan.cache_quant_int8`` also asks for int8 (``registry.Arch.init_cache``
    lays the leaves out on the plan's mesh)."""
    kh_eff = cfg.n_kv_heads * (plan.kv_repeat if plan else 1)
    shape = (cfg.n_layers, batch, max_len, kh_eff, cfg.head_dim)
    return _kv_cache(shape, device, dtype,
                     cache_quant_int8 or bool(plan and plan.cache_quant_int8))


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


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32 over logits (B, S, V) and labels
    (B, S) (−1 = ignore), divided by max(valid tokens, 1).  The label's
    logit is taken by a compare-and-sum over the vocab, as the reference
    takes it."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    onehot = labels[..., None] == torch.arange(lf.shape[-1], device=lf.device)
    ll = torch.where(onehot, lf, 0.0).sum(-1)
    valid = (labels >= 0).float()
    return ((lse - ll) * valid).sum() / torch.clamp(valid.sum(), min=1.0)

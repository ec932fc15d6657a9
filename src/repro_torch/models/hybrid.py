"""zamba2-style hybrid: Mamba2 backbone + ONE shared attention block invoked
every ``cfg.shared_attention_every`` layers (weights reused, a KV cache per
invocation).

The port of ``repro.models.hybrid``.  The Mamba2 layer params are stacked
(L, …) as in the reference; the shared block's are not.  The reference's
``lax.scan`` with ``lax.cond(idx % every == 0)`` becomes a Python loop over
layers with an ``if``; invocation ``idx // every`` reads and writes its own
(B, S, KH, Dh) slice of the attention leaves.  Every cache leaf is written
in place: the attention's k / v where it writes them, each layer's ssm and
conv state copied over once the layer has run.

Cache leaves (``init_cache``): ``attn_k`` / ``attn_v`` (n_inv, B, S, KH, Dh)
bf16, ``ssm`` (L, B, H, N, P) fp32, ``conv`` (L, B, W−1, conv_dim) in the
compute type (the type the reference's forward returns it in).  The batch
axis is ``registry.CACHE_SLOT_AXIS`` = 1 for all four; the attention leaves'
leading axis is the invocation, not the layer.

Serving modes: a whole-prompt prefill (a cache, no ``cache_pos``) and a
decode step (S == 1 at ``cache_pos``).  Chunk-resume, the verify window and
paged KV are refused with the registry's reasons (the reference's strings).
``advance`` (B,) or () bool: where False, the step leaves the recurrent
state as it was (a predicated step of a while segment that has stopped).
Training (no cache) with ``remat`` recomputes each layer, its shared block
included, in the backward pass, nothing saved (the reference's
``nothing_saveable`` around its scan body).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import NO_PLAN, layer_trees
from repro_torch.models.mamba2 import mamba2_apply, mamba2_dims, mamba2_init
from repro_torch.sharding.mesh import MeshPlan
from repro_torch.utils.remat import remat as remat_fn

Params = dict[str, Any]

CHUNKED_REASON = ("hybrid cache mixes attention KV with O(1) ssm/conv "
                  "state; chunk-resume over the recurrent leaves is not "
                  "wired yet")
PAGED_REASON = ("hybrid cache mixes attention KV with O(1) ssm/conv "
                "state; per-leaf paging not wired yet")


def n_shared_invocations(cfg: ModelConfig) -> int:
    every = cfg.shared_attention_every
    return (cfg.n_layers + every - 1) // every if every else 0


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen`` (which must live on ``device``)."""
    lead = (cfg.n_layers,)
    return {
        "embed": L.embed_init(gen, cfg, device),
        "mamba_layers": {"ln": L.norm_init(cfg, device, lead),
                         "block": mamba2_init(gen, cfg, device, lead)},
        "shared": {
            "ln_a": L.norm_init(cfg, device),
            "attn": L.attention_init(gen, cfg, device),
            "ln_f": L.norm_init(cfg, device),
            "ffn": L.ffn_init(gen, cfg, device),
        },
        "final_norm": L.norm_init(cfg, device),
        "lm_head": L.lm_head_init(gen, cfg, device),
    }


def _shared_block(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                  cache: tuple | None, cache_pos: torch.Tensor | None,
                  query_rows: int, plan: MeshPlan = NO_PLAN) -> torch.Tensor:
    seq = plan.tp if x.shape[1] > 1 else None
    h, _ = L.attention_apply(p["attn"], cfg, L.norm_apply(p["ln_a"], x), positions,
                             plan=plan, cache=cache, cache_pos=cache_pos, causal=True,
                             query_rows=query_rows)
    x = plan.constrain(x + h, plan.dp, seq, None)
    h2 = L.ffn_apply(p["ffn"], L.norm_apply(p["ln_f"], x))
    return plan.constrain(x + h2, plan.dp, seq, None)


def store(leaf: torch.Tensor, new: torch.Tensor, advance: torch.Tensor | None) -> None:
    """leaf ← new in place; where ``advance`` (() or (B,), over leaf's first
    axis) is False, leaf keeps what it holds."""
    new = new.to(leaf.dtype)
    if advance is not None:
        new = torch.where(advance.reshape(-1, *(1,) * (leaf.dim() - 1)), new, leaf)
    leaf.copy_(new)


def refuse_modes(chunked: str, paged: str, s: int, cache_pos, block_table,
                 decode_chunk: bool) -> None:
    """The serving modes a recurrent family's forward does not take: paged
    KV, the verify window and chunk-resume raise ``NotImplementedError``
    with the family's reasons (the registry's)."""
    if block_table is not None:
        raise NotImplementedError(paged)
    if decode_chunk or (cache_pos is not None and s > 1):
        raise NotImplementedError(chunked)


def forward(
    params: Params,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor | None = None,
    embeds: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    cache: dict | None = None,  # see init_cache
    cache_pos: torch.Tensor | None = None,
    block_table: torch.Tensor | None = None,
    decode_chunk: bool = False,
    query_rows: int = 0,
    advance: torch.Tensor | None = None,
    remat: bool = False,  # training: recompute each layer in the backward
    plan: MeshPlan | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """→ (logits (B, S, V), cache), the cache updated in place.  ``plan``
    shards as ``models.transformer``'s (the reference's sites: the residual
    stream sequence-parallel, the logits vocab-sharded)."""
    plan = plan or NO_PLAN
    with plan.replicating():
        return _forward(params, cfg, plan, tokens, embeds, positions, cache, cache_pos,
                        block_table, decode_chunk, query_rows, advance, remat)


def _forward(params, cfg, plan, tokens, embeds, positions, cache, cache_pos, block_table,
             decode_chunk, query_rows, advance, remat):
    dtype = getattr(torch, cfg.compute_dtype)
    x = L.embed_apply(params["embed"], tokens, dtype) if embeds is None else embeds.to(dtype)
    b, s = x.shape[:2]
    refuse_modes(CHUNKED_REASON, PAGED_REASON, s, cache_pos, block_table, decode_chunk)
    if positions is None:
        positions = (torch.arange(s, device=x.device).expand(b, s) if cache_pos is None
                     else cache_pos[:, None])
    seq = plan.tp if s > 1 else None
    x = plan.constrain(x, plan.dp, seq, None)
    every = cfg.shared_attention_every

    def layer(i: int, lp: Params, x: torch.Tensor) -> torch.Tensor:
        if i % every == 0:
            inv = i // every
            kv = None if cache is None else (cache["attn_k"][inv], cache["attn_v"][inv])
            x = _shared_block(params["shared"], cfg, x, positions, kv, cache_pos, query_rows,
                              plan)
        mstate = None if cache is None else {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}
        h, new = mamba2_apply(lp["block"], cfg, L.norm_apply(lp["ln"], x), mstate, plan)
        if cache is not None:
            store(cache["ssm"][i], new["ssm"], advance)
            store(cache["conv"][i], new["conv"], advance)
        return plan.constrain(x + h, plan.dp, seq, None)

    apply = remat_fn(layer) if remat and cache is None else layer
    for i, lp in enumerate(layer_trees(params["mamba_layers"], cfg.n_layers)):
        x = apply(i, lp, x)
    x = L.norm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params["lm_head"], x)
    return plan.constrain(logits, plan.dp, None, plan.tp), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=torch.bfloat16,
               cache_quant_int8: bool = False, plan: MeshPlan | None = None) -> dict:
    """The leaves of the module docstring, zeros.  ``cache_quant_int8`` is
    ignored, as the reference's ``init_cache`` makes no scale leaves for
    this family (its int8-KV flag does nothing here)."""
    del cache_quant_int8
    dm = mamba2_dims(cfg)
    n_inv = n_shared_invocations(cfg)
    kv = (n_inv, batch, max_len, cfg.n_kv_heads * (plan.kv_repeat if plan else 1),
          cfg.head_dim)
    return {
        "attn_k": torch.zeros(kv, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, dm["h"], dm["n"], dm["p"]),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv_width - 1, dm["conv_dim"]),
                            dtype=getattr(torch, cfg.compute_dtype), device=device),
    }

"""RWKV6 full-model assembly (rwkv6-3b): embed → embed norm → L × (time-mix
+ channel-mix) layers → final norm → head.

The port of ``repro.models.rwkv_model``.  Per-layer recurrent states
replace the KV cache; their size is O(1) in the sequence length, so
``init_cache`` ignores ``max_len``.  Cache leaves: ``shift_t`` /
``shift_c`` (L, B, d) in the compute type (the type the reference's
forward returns them in) and ``wkv`` (L, B, H, n, n) fp32, the batch on
``registry.CACHE_SLOT_AXIS`` = 1; each layer's new state is copied into
them in place once the layer has run.

The forward is attention-free: ``positions`` and ``cache_pos`` are
ignored, as in the reference (a decode step continues from the state the
cache holds), and so is ``query_rows``.  The verify window and paged KV
are refused with the registry's reasons.  ``advance`` and ``remat`` as in
``models.hybrid``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import NO_PLAN, layer_trees
from repro_torch.models.hybrid import refuse_modes, store
from repro_torch.models.rwkv6 import (
    rwkv6_channel_mix_apply,
    rwkv6_channel_mix_init,
    rwkv6_init_state,
    rwkv6_time_mix_apply,
    rwkv6_time_mix_init,
)
from repro_torch.sharding.mesh import MeshPlan
from repro_torch.utils.remat import remat as remat_fn

Params = dict[str, Any]

CHUNKED_REASON = ("rwkv carries O(1) recurrent state, not a growing KV "
                  "cache; resuming prefill mid-prompt needs a state-"
                  "snapshot contract that is not wired yet")
PAGED_REASON = ("rwkv state is O(1) in sequence length — there is no "
                "growing KV cache to page")


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen`` (which must live on ``device``)."""
    lead = (cfg.n_layers,)
    return {
        "embed": L.embed_init(gen, cfg, device),
        "embed_norm": L.norm_init(cfg, device),  # rwkv norms right after the embedding
        "layers": {
            "ln1": L.norm_init(cfg, device, lead),
            "time_mix": rwkv6_time_mix_init(gen, cfg, device, lead),
            "ln2": L.norm_init(cfg, device, lead),
            "channel_mix": rwkv6_channel_mix_init(gen, cfg, device, lead),
        },
        "final_norm": L.norm_init(cfg, device),
        "lm_head": L.lm_head_init(gen, cfg, device),
    }


def forward(
    params: Params,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor | None = None,
    embeds: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,  # unused (attention-free)
    cache: dict | None = None,  # stacked rwkv6_init_state over layers
    cache_pos: torch.Tensor | None = None,  # unused
    block_table: torch.Tensor | None = None,
    decode_chunk: bool = False,
    query_rows: int = 0,  # unused
    advance: torch.Tensor | None = None,
    remat: bool = False,  # training: recompute each layer in the backward
    plan: MeshPlan | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """→ (logits (B, S, V), cache), the cache updated in place.  ``plan``
    shards as the reference's (the residual stream sequence-parallel, the
    logits vocab-sharded; ``rwkv6_time_mix_apply`` scans each device's
    own batch rows and heads)."""
    del positions, cache_pos, query_rows
    refuse_modes(CHUNKED_REASON, PAGED_REASON, 1, None, block_table, decode_chunk)
    plan = plan or NO_PLAN
    with plan.replicating():
        return _forward(params, cfg, plan, tokens, embeds, cache, advance, remat)


def _forward(params, cfg, plan, tokens, embeds, cache, advance, remat):
    dtype = getattr(torch, cfg.compute_dtype)
    x = L.embed_apply(params["embed"], tokens, dtype) if embeds is None else embeds.to(dtype)
    x = L.norm_apply(params["embed_norm"], x)
    seq = plan.tp if x.shape[1] > 1 else None
    x = plan.constrain(x, plan.dp, seq, None)

    def layer(i: int, lp: Params, x: torch.Tensor) -> torch.Tensor:
        st = None if cache is None else {name: leaf[i] for name, leaf in cache.items()}
        h, new_t = rwkv6_time_mix_apply(
            lp["time_mix"], cfg, L.norm_apply(lp["ln1"], x),
            None if st is None else {"shift_t": st["shift_t"], "wkv": st["wkv"]}, plan=plan)
        x = plan.constrain(x + h, plan.dp, seq, None)
        h2, new_c = rwkv6_channel_mix_apply(
            lp["channel_mix"], cfg, L.norm_apply(lp["ln2"], x),
            None if st is None else {"shift_c": st["shift_c"]})
        x = plan.constrain(x + h2, plan.dp, seq, None)
        if st is not None:
            for name, new in {**new_t, **new_c}.items():
                store(st[name], new, advance)
        return x

    apply = remat_fn(layer) if remat and cache is None else layer
    for i, lp in enumerate(layer_trees(params["layers"], cfg.n_layers)):
        x = apply(i, lp, x)
    x = L.norm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params["lm_head"], x)
    return plan.constrain(logits, plan.dp, None, plan.tp), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None,
               cache_quant_int8: bool = False, plan: MeshPlan | None = None) -> dict:
    """Zeros; ``max_len`` is ignored (the state is O(1) in length) and so
    is ``cache_quant_int8``, as the reference's ``init_cache`` makes no
    scale leaves for this family."""
    del max_len, cache_quant_int8, plan
    one = rwkv6_init_state(cfg, batch, device, dtype or getattr(torch, cfg.compute_dtype))
    return {name: leaf.expand(cfg.n_layers, *leaf.shape).clone() for name, leaf in one.items()}

"""Closed-form FLOP / HBM-byte models of a whole cell and of one serving launch.

The port of ``repro.roofline.analytic``: ``CellCost`` / ``analytic_cost``
and the per-launch serving cost models (``StepCost``, ``decode_step_cost``,
``prefill_chunk_cost``, ``spec_verify_cost``, ``step_time``), for the
families the port serves: the transformer's dense, MoE, encoder and VLM
configs (SwiGLU or gelu-MLP FFNs, tied or untied LM head, experts), the
hybrid (zamba2: Mamba2 layers and a shared attention block priced once per
invocation) and rwkv.  The arithmetic is the reference's, term for term
and in its order, so both packages price a launch to the same float.

These price what the serving programs in ``serve/engine.py`` EXECUTE, not
what is useful: a decode segment attends the full max_len row every step
and runs all n_slots rows (masked ones included), a chunked-prefill launch
is padded to a power-of-two width, and an MoE prefill runs its experts'
capacity padding.  The trace recorder (``serve/trace.py``) and the knob
autotuner (``roofline/autotune.py``) both price work through these, so
their flops/bytes columns are directly comparable.

``analytic_cost`` is the reference's whole-cell model over a ``ShapeSpec``
(train / prefill / decode), term for term: ``model_flops`` (useful work,
6·N·D train / 2·N·D inference plus causal-half attention), ``hlo_flops_est``
(what the program executes: full S² attention, the remat re-forward, MoE
capacity padding) and the HBM bytes; the dry run prices its cells with it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.roofline.hw import HWTarget



def _n_inv(cfg: ModelConfig) -> int:
    """The hybrid's shared-block invocations."""
    return (cfg.n_layers + cfg.shared_attention_every - 1) // cfg.shared_attention_every


def _param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(active non-embedding + LM head, total) parameter counts."""
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = V * d * (1 if cfg.tie_embeddings else 2)  # embed + lm_head
    if cfg.rwkv_head_size:
        tm = 5 * d * d + 2 * d * cfg.rwkv_lora_decay + 2 * d
        cm = d * f + f * d + d * d
        per_layer = tm + cm
        total = embed + L * per_layer
        return L * per_layer + V * d, total
    attn = d * h * dh + 2 * d * kh * dh + h * dh * d
    n_ffn_mats = 3 if cfg.ffn == "swiglu" else 2
    ffn_dense = n_ffn_mats * d * f
    if cfg.family == "hybrid":
        dm_in = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        mamba = d * dm_in + cfg.d_inner * d + cfg.ssm_conv_width * (
            cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        )
        shared = attn + ffn_dense  # ONE shared block
        total = embed + L * mamba + shared
        active = L * mamba + _n_inv(cfg) * shared + V * d  # shared reused n_inv times
        return active, total
    if cfg.n_experts:
        experts = cfg.n_experts * n_ffn_mats * d * f
        active_experts = cfg.experts_per_token * n_ffn_mats * d * f
        router = d * cfg.n_experts
        total = embed + L * (attn + experts + router)
        active = L * (attn + active_experts + router) + V * d
        return active, total
    total = embed + L * (attn + ffn_dense)
    return L * (attn + ffn_dense) + V * d, total


def _attn_flops(cfg: ModelConfig, tokens: float, s_ctx: float, causal: bool,
                decode: bool) -> tuple[float, float]:
    """(useful, executed) attention score+pv FLOPs (projections excluded)."""
    h, dh = cfg.n_heads, cfg.head_dim
    if cfg.rwkv_head_size:  # WKV recurrence: ~6·d·n per token
        fl = 6.0 * cfg.d_model * cfg.rwkv_head_size * tokens * cfg.n_layers
        return fl, fl
    if cfg.family == "hybrid":
        # SSD per token: intra-chunk 2·Lc·(G·N + H·P) + inter 4·H·N·P
        Lc = cfg.ssm_chunk
        hS, nS, pS, gS = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups
        per_tok = 2 * Lc * (gS * nS + hS * pS) + 4 * hS * nS * pS
        if decode:
            per_tok = 6 * hS * nS * pS
        ssd = per_tok * tokens * cfg.n_layers
        # shared attention invocations
        useful_ctx = s_ctx / 2 if (causal and not decode) else s_ctx
        attn_u = 4 * h * dh * useful_ctx * tokens * _n_inv(cfg)
        attn_x = 4 * h * dh * s_ctx * tokens * _n_inv(cfg)
        return ssd + attn_u, ssd + attn_x
    useful_ctx = s_ctx / 2 if (causal and not decode and not cfg.encoder_only) else s_ctx
    return (
        4 * h * dh * useful_ctx * tokens * cfg.n_layers,
        4 * h * dh * s_ctx * tokens * cfg.n_layers,
    )


@dataclasses.dataclass
class CellCost:
    model_flops: float  # global useful FLOPs per step
    hlo_flops_est: float  # global executed FLOPs per step
    hbm_bytes: float  # global HBM traffic per step (bytes)
    n_active: float  # active non-embedding params
    n_total: float
    breakdown: dict


def analytic_cost(
    cfg: ModelConfig, shape: ShapeSpec, cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> CellCost:
    """``cache_bytes_per_elem``: 2.0 for a bf16 KV cache, 1.03 for the int8 +
    per-position-scale cache.  ``weight_bytes_per_elem``: 2.0 for bf16
    weights, ~1.01·(1 − sparsity) for the int8 block-sparse serving format."""
    n_active, n_total = _param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = float(b * s) if kind != "decode" else float(b)
    s_ctx = float(s)
    bytes_per = 2.0  # bf16 activations on the wire
    wb = weight_bytes_per_elem

    lin_u = 2.0 * n_active * tokens  # useful linear FLOPs, fwd
    attn_u, attn_x = _attn_flops(cfg, tokens, s_ctx, causal=True,
                                 decode=(kind == "decode"))

    moe_pad = 1.0
    if cfg.n_experts and kind != "decode":
        moe_pad = cfg.moe_capacity_factor  # capacity padding executes as real work

    if kind == "train":
        # bwd = 2× fwd; remat(nothing_saveable) re-runs fwd once more
        model = 3.0 * (lin_u + attn_u)
        hlo = (3.0 + 1.0) * (lin_u * moe_pad + attn_x)
        weight_traffic = 3.0 * n_total * wb  # fwd + remat-fwd + bwd reads
        opt_traffic = 2.0 * n_total * (2 + 2) * 2  # m,v read+write (bf16/fp32 mix)
        act_traffic = 12.0 * tokens * cfg.d_model * bytes_per * cfg.n_layers
        hbm = weight_traffic + opt_traffic + act_traffic
    elif kind == "prefill":
        model = lin_u + attn_u
        hlo = lin_u * moe_pad + attn_x
        weight_traffic = n_total * wb
        act_traffic = 8.0 * tokens * cfg.d_model * bytes_per * cfg.n_layers
        hbm = weight_traffic + act_traffic
    else:  # decode
        model = lin_u + attn_u
        hlo = lin_u + attn_x
        weight_traffic = n_active * wb  # active weights read once
        kh_eff = cfg.n_kv_heads
        cb = cache_bytes_per_elem
        cache_traffic = (
            2.0 * b * s_ctx * kh_eff * cfg.head_dim * cb * cfg.n_layers
            if not (cfg.rwkv_head_size or cfg.family == "hybrid")
            else 0.0
        )
        if cfg.family == "hybrid":
            n_inv = _n_inv(cfg)
            cache_traffic = 2.0 * b * s_ctx * cfg.n_kv_heads * cfg.head_dim * cb * n_inv
            cache_traffic += (2.0 * b * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
                              * cfg.n_layers)
        if cfg.rwkv_head_size:
            cache_traffic = 2.0 * b * cfg.d_model * cfg.rwkv_head_size * 4 * cfg.n_layers
        hbm = (weight_traffic + cache_traffic
               + 4.0 * b * cfg.d_model * bytes_per * cfg.n_layers)
    return CellCost(
        model_flops=model,
        hlo_flops_est=hlo,
        hbm_bytes=hbm,
        n_active=n_active,
        n_total=n_total,
        breakdown={
            "linear_useful": lin_u,
            "attn_useful": attn_u,
            "attn_executed": attn_x,
            "moe_capacity_pad": moe_pad,
            "tokens": tokens,
        },
    )


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Executed FLOPs + HBM bytes for one serving launch."""

    flops: float
    hbm_bytes: float
    breakdown: dict


def decode_step_cost(
    cfg: ModelConfig, batch: int, s_ctx: int, cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> StepCost:
    """One masked decode step over ``batch`` slot rows attending ``s_ctx``
    key positions each (wb = weight_bytes_per_elem, cb =
    cache_bytes_per_elem):

      flops = 2·n_active·b  +  4·h·dh·s_ctx·b·L
      bytes = wb·n_active  +  2·b·s_ctx·kh·dh·cb·L  +  4·b·d·2·L

    The recurrent families replace the KV term: the hybrid reads its
    n_inv shared-block caches and reads and writes its fp32 SSM state
    (2·b·H·N·P·4·L); rwkv reads and writes its fp32 WKV state
    (2·b·d·n·4·L).  ``cache_bytes_per_elem``: 2.0 for the bf16 KV cache, 1.03 for int8 with
    one fp32 scale per position and head.  ``weight_bytes_per_elem``: 2.0
    for bf16 weights, ~1.01·(1 − sparsity) for the int8 block-sparse
    serving format (int8 values, one fp32 scale and one int32 index per
    kept block; pruned blocks never leave HBM)."""
    n_active, _ = _param_counts(cfg)
    b = int(batch)
    tokens = float(b)
    s_ctx = float(int(s_ctx))
    lin_u = 2.0 * n_active * tokens
    attn_u, attn_x = _attn_flops(cfg, tokens, s_ctx, causal=True, decode=True)
    hlo = lin_u + attn_x
    weight_traffic = n_active * weight_bytes_per_elem  # active weights read once
    cb = cache_bytes_per_elem
    cache_traffic = (2.0 * b * s_ctx * cfg.n_kv_heads * cfg.head_dim * cb * cfg.n_layers
                     if not (cfg.rwkv_head_size or cfg.family == "hybrid") else 0.0)
    if cfg.family == "hybrid":
        cache_traffic = 2.0 * b * s_ctx * cfg.n_kv_heads * cfg.head_dim * cb * _n_inv(cfg)
        cache_traffic += (2.0 * b * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
                          * cfg.n_layers)
    if cfg.rwkv_head_size:
        cache_traffic = 2.0 * b * cfg.d_model * cfg.rwkv_head_size * 4 * cfg.n_layers
    hbm = weight_traffic + cache_traffic + 4.0 * b * cfg.d_model * 2.0 * cfg.n_layers
    return StepCost(hlo, hbm, {
        "linear_useful": lin_u,
        "attn_useful": attn_u,
        "attn_executed": attn_x,
        "moe_capacity_pad": 1.0,
        "tokens": tokens,
    })


def prefill_chunk_cost(
    cfg: ModelConfig,
    batch: int,
    chunk: int,
    start: int = 0,
    ctx_sum: float | None = None,
    cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> StepCost:
    """One (chunked-)prefill launch: ``batch`` rows × ``chunk`` tokens each,
    resuming at cache position ``start``.

    ``ctx_sum`` is the total attended context, summed over every (row,
    token): token i of a row starting at s attends s+i+1 key positions.
    When rows resume at different offsets (a bucketed launch) pass the
    exact sum; the default assumes all rows start at ``start``:

      ctx_sum = batch·(chunk·start + chunk·(chunk+1)/2)

    Closed form:

      flops = 2·n_active·tokens  +  4·h·dh·ctx_sum·L
      bytes = wb·n_total (weights, read once per launch)
              + 8·tokens·d·2·L (activations)
              + 2·ctx_sum·kh·dh·cb·L (KV write of the chunk + gather of the
                attended context; 0 for the recurrent families, whose
                state traffic the decode model prices)
    """
    n_active, n_total = _param_counts(cfg)
    tokens = float(batch * chunk)
    if ctx_sum is None:
        ctx_sum = batch * (chunk * start + chunk * (chunk + 1) / 2.0)
    ctx_sum = float(ctx_sum)
    s_mean = ctx_sum / max(tokens, 1.0)
    lin = 2.0 * n_active * tokens
    # executed attention at the mean context = exact Σ over rows (linear)
    _, attn_x = _attn_flops(cfg, tokens, s_mean, causal=True, decode=False)
    moe_pad = cfg.moe_capacity_factor if cfg.n_experts else 1.0
    flops = lin * moe_pad + attn_x
    act = 8.0 * tokens * cfg.d_model * 2.0 * cfg.n_layers
    if cfg.rwkv_head_size or cfg.family == "hybrid":
        kv = 0.0  # recurrent-state traffic is priced in the decode model
    else:
        kv = (2.0 * ctx_sum * cfg.n_kv_heads * cfg.head_dim
              * cache_bytes_per_elem * cfg.n_layers)
    hbm = weight_bytes_per_elem * n_total + act + kv
    return StepCost(flops, hbm, {
        "linear": lin * moe_pad,
        "attn_executed": attn_x,
        "weight_bytes": weight_bytes_per_elem * n_total,
        "act_bytes": act,
        "kv_bytes": kv,
        "tokens": tokens,
        "ctx_sum": ctx_sum,
    })


def spec_verify_cost(
    cfg: ModelConfig,
    k: int,
    batch: int,
    s_ctx: int,
    draft_layers: int | None = None,
    cache_bytes_per_elem: float = 2.0,
    weight_bytes_per_elem: float = 2.0,
) -> StepCost:
    """One speculative draft-and-verify round: k sequential drafter decode
    steps + one (k+1)-wide verify window of the served model.

    ``draft_layers``: layer count of the drafter (the ``truncate:N`` drafter
    runs a prefix of the verifier; the ``self`` drafter re-runs all layers
    on sparsified weights — same layer count, so the dense-equivalent FLOP
    price is the honest upper bound the roofline uses).
    """
    draft_cfg = cfg
    if draft_layers and draft_layers != cfg.n_layers:
        draft_cfg = dataclasses.replace(cfg, n_layers=int(draft_layers))
    d = decode_step_cost(draft_cfg, batch, s_ctx, cache_bytes_per_elem,
                         weight_bytes_per_elem)
    v = prefill_chunk_cost(cfg, batch, k + 1, start=int(s_ctx),
                           cache_bytes_per_elem=cache_bytes_per_elem,
                           weight_bytes_per_elem=weight_bytes_per_elem)
    return StepCost(
        k * d.flops + v.flops,
        k * d.hbm_bytes + v.hbm_bytes,
        {"draft_flops": k * d.flops, "verify_flops": v.flops,
         "draft_bytes": k * d.hbm_bytes, "verify_bytes": v.hbm_bytes},
    )


def step_time(cost: StepCost, hw: HWTarget, n_chips: int = 1) -> float:
    """Roofline device time for one launch: max(compute, memory) seconds."""
    return max(cost.flops / (n_chips * hw.peak_flops_bf16),
               cost.hbm_bytes / (n_chips * hw.hbm_bw))

"""Closed-form FLOP / HBM-byte models of one serving launch.

The port of the per-launch serving cost models of
``repro.roofline.analytic`` (``StepCost``, ``decode_step_cost``,
``prefill_chunk_cost``, ``spec_verify_cost``, ``step_time``), for the
family the port serves: the dense decoder (SwiGLU FFN, untied LM head, no
experts).  The arithmetic is the reference's, term for term and in its
order, so both packages price a launch to the same float.  The
reference's ``analytic_cost`` over a ``ShapeSpec`` (training and
whole-cell costs) is not ported.

These price what the serving programs in ``serve/engine.py`` EXECUTE, not
what is useful: a decode segment attends the full max_len row every step
and runs all n_slots rows (masked ones included), a chunked-prefill launch
is padded to a power-of-two width.  The trace recorder
(``serve/trace.py``) and the knob autotuner (``roofline/autotune.py``)
both price work through these, so their flops/bytes columns are directly
comparable.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.roofline.hw import HWTarget


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"the serving cost models price the dense decoder, not "
                         f"{cfg.family!r}")


def _param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(active non-embedding + LM head, total) parameter counts."""
    _check_family(cfg)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = V * d * 2  # embed + untied lm_head
    attn = d * h * dh + 2 * d * kh * dh + h * dh * d
    ffn_dense = 3 * d * f  # swiglu: wi, wg, wo
    total = embed + L * (attn + ffn_dense)
    return L * (attn + ffn_dense) + V * d, total


def _attn_flops(cfg: ModelConfig, tokens: float, s_ctx: float, causal: bool,
                decode: bool) -> tuple[float, float]:
    """(useful, executed) attention score+pv FLOPs (projections excluded)."""
    h, dh = cfg.n_heads, cfg.head_dim
    useful_ctx = s_ctx / 2 if (causal and not decode) else s_ctx
    return (
        4 * h * dh * useful_ctx * tokens * cfg.n_layers,
        4 * h * dh * s_ctx * tokens * cfg.n_layers,
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

    ``cache_bytes_per_elem``: 2.0 for the bf16 KV cache, 1.03 for int8 with
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
    cache_traffic = (2.0 * b * s_ctx * cfg.n_kv_heads * cfg.head_dim
                     * cache_bytes_per_elem * cfg.n_layers)
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
                attended context)
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
    moe_pad = 1.0
    flops = lin * moe_pad + attn_x
    act = 8.0 * tokens * cfg.d_model * 2.0 * cfg.n_layers
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

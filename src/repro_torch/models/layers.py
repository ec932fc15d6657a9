"""Decoder layers: RMSNorm, RoPE, GQA attention (chunked online-softmax
prefill + cached decode), SwiGLU FFN, embedding and LM head.

The port of ``repro.models.layers`` for the dense decoder path.

Conventions:
  * params are nested dicts of tensors; init fns mirror apply fns and take
    an explicit ``torch.Generator`` and device.  ``lead`` prepends axes, so
    a stack of layers is initialised as one (L, …) tensor per leaf.
  * activations flow in ``cfg.compute_dtype`` (bf16); norms/softmax in fp32.
  * attention tensors are laid out (B, S, H, Dh), as in the reference.
  * the KV cache is written in place (the reference returned a new array).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sonic_layers import serve_quant_apply

Params = dict[str, Any]


# ---------------------------------------------------------------- init utils


def _normal(gen: torch.Generator, shape, dtype, scale: float, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, lead=()) -> Params:
    return {"kernel": _normal(gen, (*lead, d_in, d_out), dtype, d_in**-0.5, device)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "qvalues" in p:  # int8 block-sparse serving weights: the projection
        # dict was rewritten by ``quantize_serve_params``; the kernels
        # contract only the kept blocks against their per-block scales
        return serve_quant_apply(p, x)
    return x @ p["kernel"].to(x.dtype)


def norm_init(cfg: ModelConfig, device, lead=()) -> Params:
    return {"scale": torch.ones((*lead, cfg.d_model), dtype=torch.float32, device=device)}


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, back to x's type."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


# ----------------------------------------------------------------- RoPE


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (B, S) → angles (B, S, head_dim/2) fp32 (standard RoPE)."""
    half = cfg.head_dim // 2
    slots = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv_freq = cfg.rope_theta ** (-slots / half)
    return positions[..., None].float() * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh), angles (B, S, Dh/2) → rotated x (rotate-half conv.)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------------- attention


def attention_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wq": dense_init(gen, d, h * dh, dt, device, lead),
        "wk": dense_init(gen, d, kh * dh, dt, device, lead),
        "wv": dense_init(gen, d, kh * dh, dt, device, lead),
        "wo": dense_init(gen, h * dh, d, dt, device, lead),
    }


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,KH,G,Dh), k (B,Skv,KH,Dh) → scores (B,KH,G,Sq,Skv) fp32.

    Mixed types promote as in the reference (fp32 queries over a bf16
    cache are scored in fp32)."""
    dt = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(dt), k.to(dt)).float() * scale


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KH, Dh)
    v: torch.Tensor,  # (B, Skv, KH, Dh)
    q_positions: torch.Tensor,  # (B, Sq)
    kv_positions: torch.Tensor,  # (B, Skv)
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Memory-efficient (online-softmax) attention in plain torch ops.

    Walks KV chunks per Q chunk, so the materialized score block is
    (B, KH, G, q_chunk, kv_chunk).  Masking is position-based: a kv position
    participates iff kv_pos <= q_pos (causal) and kv_pos >= 0 (padding
    convention: pos < 0)."""
    b, sq, h, dh = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = dh**-0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks must divide the sequences: {(sq, q_chunk, skv, kv_chunk)}")

    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].reshape(b, q_chunk, kh, g, dh)
        qpi = q_positions[:, q0:q0 + q_chunk]
        acc = torch.zeros((b, kh, g, q_chunk, dh), dtype=v.dtype, device=v.device)
        m = torch.full((b, kh, g, q_chunk), -torch.inf, dtype=torch.float32, device=v.device)
        l = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32, device=v.device)
        for k0 in range(0, skv, kv_chunk):
            ki, vi = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpi = kv_positions[:, k0:k0 + kv_chunk]
            s = _gqa_scores(qi, ki, scale)  # (B,KH,G,qc,kvc) fp32
            mask = kpi[:, None, None, None, :] >= 0
            if causal:
                mask = mask & (qpi[:, None, None, :, None] >= kpi[:, None, None, None, :])
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vi.dtype), vi)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype))
    out = torch.cat(outs, dim=3)  # (B, KH, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def decode_attention(
    q: torch.Tensor,  # (B, C, H, Dh) — C decode-style queries per row
    k_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    v_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    pos: torch.Tensor,  # (B,) position of the FIRST query token
) -> torch.Tensor:
    """Decode-style attention over the cache: query i (at absolute position
    ``pos + i``) attends cache positions ``<= pos + i``; everything beyond is
    masked.  One plain softmax per query row (not the online-softmax flash
    path), as in the reference."""
    b, c, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, c, kh, g, dh)
    s = _gqa_scores(qg, k_cache, dh**-0.5)  # (B,KH,G,C,S_max) fp32
    idx = torch.arange(k_cache.shape[1], device=q.device)
    qpos = pos[:, None] + torch.arange(c, dtype=pos.dtype, device=q.device)[None, :]
    mask = idx[None, None, :] <= qpos[:, :, None]  # (B, C, S_max)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype), v_cache)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh)


def update_kv_cache(
    k_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, S_new, KH, Dh)
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) write offsets
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write k_new / v_new into the caches at per-row offsets, IN PLACE (the
    reference returned updated copies).  Returns the same two tensors."""
    b, s = k_new.shape[:2]
    rows = torch.arange(b, device=k_cache.device)[:, None]
    cols = pos[:, None] + torch.arange(s, device=k_cache.device)[None, :]
    k_cache[rows, cols] = k_new.to(k_cache.dtype)  # in place
    v_cache[rows, cols] = v_new.to(v_cache.dtype)  # in place
    return k_cache, v_cache


def attention_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    *,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: torch.Tensor | None = None,  # (B,)
) -> tuple[torch.Tensor, tuple | None]:
    """Full attention block (no norm/residual).  Returns (out, cache).

    Modes:
      * cache is None           → forward without a cache (no cache out).
      * cache given, S > 1, no cache_pos → whole-prompt prefill: writes the
        cache at 0..S in place, attends over the fresh k/v.
      * cache given, S == 1     → decode step at ``cache_pos``: writes the
        cache in place, attends over it with ``decode_attention``.
    The reference's chunk-resume, speculative-verify and paged modes are not
    ported yet.
    """
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(b, s, h, dh)
    k = dense_apply(p["wk"], x).reshape(b, s, kh, dh)
    v = dense_apply(p["wv"], x).reshape(b, s, kh, dh)
    ang = rope_angles(cfg, positions)
    q = apply_rope(q, ang)
    k = apply_rope(k, ang)

    if cache is None:
        out = flash_attention(q, k, v, positions, positions)
    elif s == 1:
        if cache_pos is None:
            raise ValueError("a decode step (S == 1) needs cache_pos")
        update_kv_cache(*cache, k, v, cache_pos)
        out = decode_attention(q, *cache, cache_pos)
    elif cache_pos is None:
        update_kv_cache(*cache, k, v, torch.zeros(b, dtype=torch.long, device=x.device))
        out = flash_attention(q, k, v, positions, positions)
    else:
        raise NotImplementedError("chunk-resume prefill (S > 1 with cache_pos) "
                                  "is not ported yet")
    return dense_apply(p["wo"], out.reshape(b, s, h * dh)), cache


# ----------------------------------------------------------------- FFN


def ffn_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wi": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
        "wg": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
        "wo": dense_init(gen, cfg.d_ff, cfg.d_model, dt, device, lead),
    }


def ffn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: wo(silu(wi x) * wg x)."""
    h = torch.nn.functional.silu(dense_apply(p["wi"], x)) * dense_apply(p["wg"], x)
    return dense_apply(p["wo"], h)


# ------------------------------------------------------------- embeddings


def embed_init(gen, cfg: ModelConfig, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), dt, 1.0, device)}


def embed_apply(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"][tokens].to(dtype)


def lm_head_init(gen, cfg: ModelConfig, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)


def lm_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense_apply(p, x)

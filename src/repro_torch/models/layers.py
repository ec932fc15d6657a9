"""Shared model layers: RMSNorm / layernorm, RoPE / M-RoPE, GQA attention
(chunked online-softmax prefill, cached decode and verify windows, paged
and int8 KV caches), SwiGLU and gelu-MLP FFNs, embedding and LM head.

The port of ``repro.models.layers``.

Conventions:
  * params are nested dicts of tensors; init fns mirror apply fns and take
    an explicit ``torch.Generator`` and device.  ``lead`` prepends axes, so
    a stack of layers is initialised as one (L, …) tensor per leaf.
  * activations flow in ``cfg.compute_dtype`` (bf16); norms/softmax in fp32.
  * attention tensors are laid out (B, S, H, Dh), as in the reference.
  * every KV cache and pool is written in place (the reference returned new
    arrays).
  * a row's bits do not depend on how many rows come with it
    (``utils.rows``): a decode step, a verify window and a chunked prefill
    give each token the bits of the same token in any other of them.  The
    dense projections run in chunks of a fixed row count on the card
    (``fixed_rows``), the norm's mean pads its rows to a fixed floor, the
    decode-style attention pads its query rows to ``DECODE_QUERY_ROWS``,
    and every cached prefill walks its queries in chunks of
    ``PREFILL_QUERY_CHUNK`` over the whole cache length.
  * a dense product that autograd records (training) is one product over
    all its rows: its weight gradient is then one sum over the rows,
    accumulated in fp32 and rounded once, where 64-row chunks would add
    M / 64 partial gradients in the weight's (bf16) type.  Training has no
    row-independence contract; serving runs under ``torch.inference_mode``
    and keeps the chunks.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sonic_layers import draft_apply, serve_quant_apply
from repro_torch.utils.rows import CPU_ROWS, DENSE_CUDA_ROWS, at_least_rows, in_row_chunks

Params = dict[str, Any]

# Query rows per sequence that decode-style attention computes (a decode
# step's 1, a verify window's k + 1, padded): one shape for every window up
# to this size.  Queries per chunk of a cached prefill: a prompt of up to
# 64 tokens is one chunk, and a shorter chunk-resume pads to it.
DECODE_QUERY_ROWS = {"cpu": CPU_ROWS, "cuda": 16}
PREFILL_QUERY_CHUNK = 64


def decode_query_rows(device_type: str, k: int = 0) -> int:
    """The query rows an engine pads its decode-style attention to, so that
    its decode steps and its verify windows of k + 1 rows (k = 0: no
    speculation) run one shape: on the card the multiple of
    ``DECODE_QUERY_ROWS["cuda"]`` at or above k + 1; elsewhere the floor of
    ``DECODE_QUERY_ROWS`` (the plain versions' rows do not depend on it)."""
    base = DECODE_QUERY_ROWS.get(device_type, 1)
    if device_type != "cuda":
        return base
    return base * -(-(k + 1) // base)


def _row_floor(x: torch.Tensor) -> int:
    return DENSE_CUDA_ROWS if x.device.type == "cuda" else CPU_ROWS


def fixed_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over the rows of x (M, K) in the decode step's shape: on the card
    every call of fn sees exactly ``DENSE_CUDA_ROWS`` rows (``in_row_chunks``,
    at any M); elsewhere at least ``CPU_ROWS``."""
    if x.device.type == "cuda":
        return in_row_chunks(fn, x, DENSE_CUDA_ROWS)
    return at_least_rows(fn, x, CPU_ROWS)


# ---------------------------------------------------------------- init utils


def _normal(gen: torch.Generator, shape, dtype, scale: float, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, lead=(), bias: bool = False) -> Params:
    p = {"kernel": _normal(gen, (*lead, d_in, d_out), dtype, d_in**-0.5, device)}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "qvalues" in p:  # int8 block-sparse serving weights: the projection
        # dict was rewritten by ``quantize_serve_params``; the kernels
        # contract only the kept blocks against their per-block scales
        y = serve_quant_apply(p, x)
    elif "bsvalues" in p:  # the self-drafter's block-sparse weights
        # (``sparse_draft_params``), on ``block_sparse_matmul``
        y = draft_apply(p, x)
    else:
        w = p["kernel"].to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = x2 @ w  # training: one product, so dW is one fp32-accumulated sum
        else:
            y = fixed_rows(lambda xx: xx @ w, x2)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def norm_init(cfg: ModelConfig, device, lead=()) -> Params:
    p = {"scale": torch.ones((*lead, cfg.d_model), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["norm_bias"] = torch.zeros((*lead, cfg.d_model), dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, or layernorm where ``p`` has a ``norm_bias``, in fp32, back
    to x's type.  Each mean runs over at least the row floor (a CUDA
    reduction picks its threads by the number of rows)."""

    def mean(t: torch.Tensor) -> torch.Tensor:
        m = at_least_rows(lambda tt: tt.mean(-1, keepdim=True), t.reshape(-1, t.shape[-1]),
                          _row_floor(x))
        return m.reshape(*t.shape[:-1], 1)

    xf = x.float()
    if "norm_bias" in p:  # layernorm
        mu = mean(xf)
        var = mean((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["norm_bias"]
    else:  # rmsnorm
        y = xf * torch.rsqrt(mean(xf * xf) + eps) * p["scale"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- RoPE


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (B, S) or (B, 3, S) → angles (B, S, head_dim/2) fp32.

    Standard RoPE for (B, S); M-RoPE (qwen2-vl) for (B, 3, S): the dh/2
    frequency slots are split into ``mrope_sections`` = (t, h, w) groups,
    each driven by its own position row."""
    half = cfg.head_dim // 2
    slots = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv_freq = cfg.rope_theta ** (-slots / half)
    if positions.dim() == 2:  # (B, S)
        return positions[..., None].float() * inv_freq
    st, sh, sw = cfg.mrope_sections
    if st + sh + sw != half:
        raise ValueError(f"mrope_sections {cfg.mrope_sections} must sum to head_dim / 2 "
                         f"= {half}")
    slot = torch.arange(half, device=positions.device)
    section = (slot >= st).long() + (slot >= st + sh).long()  # 0, 1, 2 by (t, h, w)
    pos_per_slot = positions.index_select(1, section)  # (B, half, S)
    return pos_per_slot.transpose(1, 2).float() * inv_freq


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
    dt, bias = getattr(torch, cfg.param_dtype), cfg.use_bias
    return {
        "wq": dense_init(gen, d, h * dh, dt, device, lead, bias),
        "wk": dense_init(gen, d, kh * dh, dt, device, lead, bias),
        "wv": dense_init(gen, d, kh * dh, dt, device, lead, bias),
        "wo": dense_init(gen, h * dh, d, dt, device, lead, bias),
    }


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,KH,G,Dh), k (B,Skv,KH,Dh) → scores (B,KH,G,Sq,Skv) fp32.

    Mixed types promote as in the reference (fp32 queries over a bf16
    cache are scored in fp32)."""
    dt = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(dt), k.to(dt)).float() * scale


def _pad_axis1(t: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """t padded along axis 1 to length n with ``value``."""
    if t.shape[1] >= n:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n - t.shape[1]), value=value)


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
    convention: pos < 0).  Where the reference shrinks q_chunk to Sq and
    requires the chunks to divide the sequences, the port pads: queries to
    a multiple of q_chunk (their rows dropped), so every chunk has q_chunk
    rows, and keys to a multiple of kv_chunk (at position −1, so they never
    attend)."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = dh**-0.5
    kv_chunk = min(kv_chunk, skv)
    sq_pad, skv_pad = -(-sq // q_chunk) * q_chunk, -(-skv // kv_chunk) * kv_chunk
    q, q_positions = _pad_axis1(q, sq_pad), _pad_axis1(q_positions, sq_pad, -1)
    k, v = _pad_axis1(k, skv_pad), _pad_axis1(v, skv_pad)
    kv_positions = _pad_axis1(kv_positions, skv_pad, -1)

    outs = []
    for q0 in range(0, sq_pad, q_chunk):
        qi = q[:, q0:q0 + q_chunk].reshape(b, q_chunk, kh, g, dh)
        qpi = q_positions[:, q0:q0 + q_chunk]
        acc = torch.zeros((b, kh, g, q_chunk, dh), dtype=v.dtype, device=v.device)
        m = torch.full((b, kh, g, q_chunk), -torch.inf, dtype=torch.float32, device=v.device)
        l = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32, device=v.device)
        for k0 in range(0, skv_pad, kv_chunk):
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
    out = torch.cat(outs, dim=3)[:, :, :, :sq]  # (B, KH, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def decode_attention(
    q: torch.Tensor,  # (B, C, H, Dh) — C decode-style queries per row
    k_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    v_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    pos: torch.Tensor,  # (B,) position of the FIRST query token
    rows: int = 0,  # query rows to pad to; 0 = DECODE_QUERY_ROWS
) -> torch.Tensor:
    """Decode-style attention over the cache: query i (at absolute position
    ``pos + i``) attends cache positions ``<= pos + i``; everything beyond is
    masked.  One plain softmax per query row (not the online-softmax flash
    path), as in the reference: C == 1 is a decode step, C > 1 the
    speculative-verify window, whose rows are each the decode step they
    replace.  The query rows are padded to ``rows`` (the engine's
    ``decode_query_rows``; by default ``DECODE_QUERY_ROWS``), their outputs
    dropped, so a step and a window up to that size run the same shapes and
    give a row the same bits."""
    b, c, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    cp = max(c, rows or DECODE_QUERY_ROWS.get(q.device.type, 1))
    qg = _pad_axis1(q, cp).reshape(b, cp, kh, g, dh)
    s = _gqa_scores(qg, k_cache, dh**-0.5)  # (B,KH,G,Cp,S_max) fp32
    idx = torch.arange(k_cache.shape[1], device=q.device)
    qpos = pos[:, None] + torch.arange(cp, dtype=pos.dtype, device=q.device)[None, :]
    mask = idx[None, None, :] <= qpos[:, :, None]  # (B, Cp, S_max)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype), v_cache)
    return out[:, :, :, :c].permute(0, 3, 1, 2, 4).reshape(b, c, h, dh)


def _write_rows(pairs, pos: torch.Tensor) -> None:
    """cache[b, pos[b] + j] = new[b, j] for each (cache, new) of ``pairs``
    (all (B, S_max, …) against (B, S, …)), in place: the reference's
    per-row ``dynamic_update_slice``, which clamps the start so the slice
    fits."""
    cache, new = pairs[0]
    b, s = new.shape[:2]
    start = torch.clamp(pos, 0, cache.shape[1] - s)
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=cache.device)[None, :]
    for cache, new in pairs:
        cache[rows, cols] = new.to(cache.dtype)


# ---------------- paged KV cache (block pool + block table, serving) --------
#
# The layout of the reference (``repro.models.layers``): KV lives in a pool
# of (n_blocks, block_len, KH, Dh) physical blocks shared by every slot; a
# (n_slots, max_blocks) int32 block table maps each slot's logical block j
# to a physical block id.  Physical blocks 0..n_slots−1 are per-slot
# scratch: slot s's unmapped entries point at block s, so every decode-step
# write lands at a unique (block, offset) pair.  The gather rebuilds the
# per-slot virtual cache (n_slots, max_blocks·block_len, KH, Dh); with
# max_blocks·block_len == max_len the attention shapes, and so the outputs,
# are the dense layout's bit for bit.  Out-of-range block ids (the dummy
# rows of a fixed-width batched prefill) clamp in the gather (the
# reference's mode="clip") and drop in the writes (mode="drop"); on the
# card an index out of range would be a device-side assert, so both are
# explicit here.


def paged_cache_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool (n_blocks, block_len, …), block_table (B, MB) int → virtual
    per-slot cache (B, MB·block_len, …); out-of-range ids clamp."""
    ids = torch.clamp(block_table.long(), 0, pool.shape[0] - 1)
    g = pool[ids]  # (B, MB, bl, …)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _scatter_drop(pool: torch.Tensor, phys: torch.Tensor, off: torch.Tensor,
                  new: torch.Tensor) -> None:
    """pool[phys[i], off[i]] = new[i] in place for every entry whose block
    id is in range; the others are dropped, with no host sync: each is
    redirected to the first valid entry's place and value (or, when none is
    valid, to rewrite the value already at entry 0's clamped place), so
    every place is written with one value only.  In-range entries must name
    distinct places, as the reference's ``unique_indices`` requires."""
    phys, off = phys.reshape(-1).long(), off.reshape(-1).long()
    new = new.reshape(phys.shape[0], *pool.shape[2:]).to(pool.dtype)
    valid = (phys >= 0) & (phys < pool.shape[0])
    first = torch.argmax(valid.to(torch.int32)).reshape(1)  # 0 when none is valid
    phys_c = torch.clamp(phys, 0, pool.shape[0] - 1)
    sink_phys, sink_off = phys_c[first], off[first]
    shape = (-1,) + (1,) * (new.dim() - 1)
    sink_val = torch.where(valid[first].view(shape), new[first], pool[sink_phys, sink_off])
    vals = torch.where(valid.view(shape), new, sink_val)
    pool[torch.where(valid, phys_c, sink_phys), torch.where(valid, off, sink_off)] = vals


def _physical(block_table: torch.Tensor, logical: torch.Tensor, bl: int) -> torch.Tensor:
    """The physical block of each logical position (B, C); −1 (dropped by
    the writes) past the table's width."""
    blk = logical // bl
    mb = block_table.shape[1]
    phys = torch.gather(block_table.long(), 1, torch.clamp(blk, 0, mb - 1))
    return torch.where((blk >= 0) & (blk < mb), phys, -1)


def paged_cache_write(
    pool: torch.Tensor,  # (n_blocks, block_len, …)
    block_table: torch.Tensor,  # (B, MB) int
    new: torch.Tensor,  # (B, 1, …) — one decode token per slot
    pos: torch.Tensor,  # (B,) logical write position per slot
) -> torch.Tensor:
    """Scatter one decode token per slot into its mapped physical block, in
    place; returns the pool."""
    bl = pool.shape[1]
    _scatter_drop(pool, _physical(block_table, pos.long()[:, None], bl), pos.long() % bl,
                  new[:, 0])
    return pool


def paged_cache_write_chunk(
    pool: torch.Tensor,  # (n_blocks, block_len, …)
    block_table: torch.Tensor,  # (B, MB) int
    new: torch.Tensor,  # (B, C, …) — one prefill chunk per slot
    pos0: torch.Tensor,  # (B,) logical start position of the chunk per slot
) -> torch.Tensor:
    """Scatter a whole chunk per slot at its block-table offsets, in place
    (each token resolves its own physical block, so a chunk may straddle
    blocks); entries with an out-of-range physical id drop.  Returns the
    pool."""
    bl = pool.shape[1]
    logical = pos0.long()[:, None] + torch.arange(new.shape[1], device=pool.device)[None, :]
    _scatter_drop(pool, _physical(block_table, logical, bl), logical % bl, new)
    return pool


# -------- int8 KV cache (SONIC C2 applied to the cache) ---------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, Dh) → (int8 values, (…,) fp32 per-position-per-head scale), with
    the reference's ``+1e-8`` on the scale; ``torch.round`` rounds half to
    even as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _kv_positions(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).expand(b, n)


def attention_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) or (B, 3, S) for mrope
    *,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_scales: tuple[torch.Tensor, torch.Tensor] | None = None,  # int8 cache
    cache_pos: torch.Tensor | None = None,  # (B,)
    block_table: torch.Tensor | None = None,  # (B, MB) — paged cache
    causal: bool = True,
    decode_chunk: bool = False,  # speculative-verify window
    query_rows: int = 0,  # decode-style attention's padded query rows
) -> tuple[torch.Tensor, tuple | None]:
    """Full attention block (no norm/residual).  Returns (out, cache); every
    cache array is updated in place.

    Modes, as in the reference:
      * cache is None                    → forward without a cache.
      * cache given, S > 1, no cache_pos → whole-prompt prefill: writes the
        cache at 0..S, attends over the fresh k/v padded with zeros to the
        cache length (so its sums run over the length chunk-resume's do,
        and the two give the same bits).
      * cache given, S > 1, cache_pos    → chunk-resume prefill: writes the
        chunk at per-row offsets ``cache_pos`` and attends over the updated
        cache with absolute-position causal masking.
      * … and ``decode_chunk``           → speculative-verify window: the
        same writes, attention through ``decode_attention``, each row the
        decode step it replaces.
      * cache given, S == 1              → decode step at ``cache_pos``.
      * block_table given                → paged: ``cache`` is a (k_pool,
        v_pool) block pool; decode scatters one token (``paged_cache_write``),
        chunk-resume and verify scatter the chunk
        (``paged_cache_write_chunk``); attention runs over the gathered
        virtual cache.
      * cache_scales given               → int8 KV: k/v are quantized per
        position and head as written; every prefill, whole-prompt or
        chunk-resume, attends the dequantized cache it has just written,
        and decode and verify attend the same values.
    M-RoPE positions (B, 3, S) rotate q and k by their sections; the flash
    paths mask by the temporal row, ``positions[:, 0]``, as the reference.
    ``causal=False`` (an encoder) drops the causal mask of the flash paths.
    The reference's mesh constraints are not ported.
    """
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(b, s, h, dh)
    k = dense_apply(p["wk"], x).reshape(b, s, kh, dh)
    v = dense_apply(p["wv"], x).reshape(b, s, kh, dh)
    if cfg.pos_enc in ("rope", "mrope"):
        ang = rope_angles(cfg, positions)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    pos2d = positions if positions.dim() == 2 else positions[:, 0, :]

    if cache is None:  # training and the encoder: marked for the profiler's split
        with record_function("attention"):
            out = flash_attention(q, k, v, pos2d, pos2d, causal=causal, q_chunk=min(512, s))
        return dense_apply(p["wo"], out.reshape(b, s, h * dh)), None
    if cache_pos is None and (s == 1 or block_table is not None):
        raise ValueError("a decode step (S == 1) and a paged forward need cache_pos")
    quant = cache_scales is not None
    k_c, v_c = cache
    if quant:
        ks_c, vs_c = cache_scales
        (k_w, ks_new), (v_w, vs_new) = quantize_kv(k), quantize_kv(v)
    else:
        k_w, v_w = k, v
    if block_table is not None:
        write = paged_cache_write if s == 1 else paged_cache_write_chunk
        for pool, new in ((k_c, k_w), (v_c, v_w)) + (
                ((ks_c, ks_new), (vs_c, vs_new)) if quant else ()):
            write(pool, block_table, new, cache_pos)

        def read(pool):
            return paged_cache_gather(pool, block_table)
    else:
        write_pos = (cache_pos if cache_pos is not None
                     else torch.zeros((b,), dtype=torch.long, device=x.device))
        _write_rows(((k_c, k_w), (v_c, v_w)) + (
            ((ks_c, ks_new), (vs_c, vs_new)) if quant else ()), write_pos)

        def read(arr):
            return arr

    if quant:
        k_att = dequantize_kv(read(k_c), read(ks_c), q.dtype)
        v_att = dequantize_kv(read(v_c), read(vs_c), q.dtype)
    else:
        k_att, v_att = read(k_c), read(v_c)
    s_max = k_att.shape[1]
    if s == 1 or (decode_chunk and cache_pos is not None):
        out = decode_attention(q, k_att, v_att, cache_pos, query_rows)
    elif cache_pos is not None or quant:  # chunk-resume, or any int8-KV prefill
        out = flash_attention(q, k_att, v_att, pos2d, _kv_positions(b, s_max, x.device),
                              causal=causal, q_chunk=PREFILL_QUERY_CHUNK)
    else:  # whole-prompt prefill: the fresh (exact) k/v over the cache length
        out = flash_attention(q, _pad_axis1(k, s_max), _pad_axis1(v, s_max), pos2d,
                              _kv_positions(b, s_max, x.device),
                              causal=causal, q_chunk=PREFILL_QUERY_CHUNK)
    new_cache = (k_c, v_c, ks_c, vs_c) if quant else (k_c, v_c)
    return dense_apply(p["wo"], out.reshape(b, s, h * dh)), new_cache


# ----------------------------------------------------------------- FFN


def ffn_init(gen, cfg: ModelConfig, device, lead=()) -> Params:
    dt, d, f, bias = getattr(torch, cfg.param_dtype), cfg.d_model, cfg.d_ff, cfg.use_bias
    if cfg.ffn == "swiglu":
        return {
            "wi": dense_init(gen, d, f, dt, device, lead, bias),
            "wg": dense_init(gen, d, f, dt, device, lead, bias),
            "wo": dense_init(gen, f, d, dt, device, lead, bias),
        }
    return {
        "wi": dense_init(gen, d, f, dt, device, lead, bias),
        "wo": dense_init(gen, f, d, dt, device, lead, bias),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, wo(silu(wi x) * wg x), where ``p`` has a ``wg``; else the
    gelu MLP, wo(gelu(wi x))."""
    if "wg" in p:
        h = F.silu(dense_apply(p["wi"], x)) * dense_apply(p["wg"], x)
    else:
        h = gelu(dense_apply(p["wi"], x))
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


def tied_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The tied LM head: x @ embedding.T in x's type (``tie_embeddings``)."""
    return dense_apply({"kernel": p["embedding"].to(x.dtype).T}, x)

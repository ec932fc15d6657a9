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
    decode-style attention runs on the card in a kernel whose rows are
    independent (``kernels/decode_attention``) and elsewhere pads its query
    rows to ``DECODE_QUERY_ROWS``, and every cached prefill walks its
    queries in chunks of ``PREFILL_QUERY_CHUNK`` over the whole cache
    length.
  * a dense product that autograd records (training) is one product over
    all its rows: its weight gradient is then one sum over the rows,
    accumulated in fp32 and rounded once, where 64-row chunks would add
    M / 64 partial gradients in the weight's (bf16) type.  Training has no
    row-independence contract; serving runs under ``torch.inference_mode``
    and keeps the chunks.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.profiler import record_function
from torch.utils.flop_counter import register_flop_formula

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sonic_layers import draft_apply, serve_quant_apply
from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.utils.rows import CPU_ROWS, DENSE_CUDA_ROWS, at_least_rows, in_row_chunks

Params = dict[str, Any]

# Query rows per sequence that the plain decode-style attention computes (a
# decode step's 1, a verify window's k + 1, padded): one shape for every
# window up to this size (the card's kernel takes the real rows).  Queries
# per chunk of a cached prefill: a prompt of up to 64 tokens is one chunk,
# and a shorter chunk-resume pads to it.
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


def _rows_gathered(x: DTensor) -> DTensor:
    """x with its middle dims (the sequence) gathered: a product's rows are
    (B·S), sharded by the batch only, as sequence parallelism gathers the
    sequence before a projection."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def rows(i, q):
        if isinstance(q, (Replicate, Partial)):
            return q
        if type(q) is not Shard:  # a strided split a reshape left
            return Replicate()
        if 0 < q.dim < x.dim() - 1 or x.device_mesh.size(i) == 1:  # (1 device: free)
            return Replicate()
        return q

    pl = tuple(rows(i, q) for i, q in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


class _GradInLayout(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    (a product's gradient then reaches its backward in the rows' layout,
    not in a sequence-sharded one it cannot flatten)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Partial, Replicate

        # a partial sum's gradient is the same on every device
        ctx.layout = (y.device_mesh, tuple(Replicate() if isinstance(q, Partial) else q
                                           for q in y.placements))
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.layout
        return g if tuple(g.placements) == pl else g.redistribute(mesh, pl)


def grad_in_layout(t: torch.Tensor) -> torch.Tensor:
    """t, its gradient laid out as t (``_GradInLayout``) if it is a DTensor."""
    return _GradInLayout.apply(t) if isinstance(t, DTensor) else t


def _from_local(y: torch.Tensor, mesh, placements, shape) -> DTensor:
    """y, each device's block, as the DTensor of global ``shape`` (contiguous)
    laid out by ``placements``."""
    shape = torch.Size(shape)
    return DTensor.from_local(y, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """t (B, S, n·dh) → (B, S, n, dh).  A DTensor whose last dim is sharded
    over more devices than n divides is gathered on that dim first (as
    GSPMD reshards a head split it cannot keep)."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import Replicate, Shard

        on_last = [i for i, q in enumerate(t.placements)
                   if isinstance(q, Shard) and q.dim == t.dim() - 1]
        if n % math.prod(t.device_mesh.size(i) for i in on_last):
            pl = tuple(Replicate() if i in on_last else q for i, q in enumerate(t.placements))
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, dh)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """t (B, S, H, Dh) → (B, S, H·Dh).  A DTensor split over Dh, or over H
    unevenly, is gathered on those dims first (a merge could keep only an
    even split of H)."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import Replicate, Shard

        mesh = t.device_mesh
        pl = tuple(Replicate() if isinstance(q, Shard) and (
            q.dim == 3 or type(q) is not Shard
            or (q.dim == 2 and t.shape[2] % mesh.size(i))) else q
            for i, q in enumerate(t.placements))
        if pl != tuple(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:2], t.shape[2] * t.shape[3])


def _blocks_meshed(apply, p: Params, x: DTensor) -> DTensor:
    """A column-block projection (int8 ``qvalues`` or the self drafter's
    ``bsvalues``, laid out by ``partition.block_column_spec``) on DTensors:
    x gathered but for its batch split, so each device's kernels run on
    its rows' whole K and its own column blocks; y (…, N) split as x's
    batch and the blocks' columns.  The hand kernels have no DTensor
    rules: they run on the local blocks, one launch per device."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    vals = p["qvalues"] if "qvalues" in p else p["bsvalues"]
    nb_dim = vals.dim() - 4
    xpl = tuple(q if type(q) is Shard and q.dim == 0 else Replicate() for q in x.placements)
    if xpl != tuple(x.placements):
        x = x.redistribute(mesh, xpl)
    ypl = tuple(Shard(x.dim() - 1) if isinstance(q, Shard) and q.dim == nb_dim else xpl[i]
                for i, q in enumerate(vals.placements))
    y = apply({k: v.to_local() for k, v in p.items() if k != "bias"}, x.to_local())
    return _from_local(y, mesh, ypl, (*x.shape[:-1], vals.shape[nb_dim] * vals.shape[-1]))


def _dense_meshed(x: DTensor, w: DTensor) -> DTensor:
    """x @ w (w (K, N)) on DTensors as the plain serving path computes it:
    each device's own rows through ``fixed_rows`` against its own block of
    w, so a row's bits do not depend on M.  Per mesh dim: x's batch split
    and w's column split carry over to y; a K split on both gives partial
    sums, gathered and added in rank order (an all-reduce adds in an order
    that follows its chunking of the output, so depends on M); any other
    split of w is gathered first (FSDP)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.dim() - 1
    wpl, ypl = list(w.placements), []
    for i, (qx, qw) in enumerate(zip(x.placements, w.placements)):
        x_k = type(qx) is Shard and qx.dim == last
        if mesh.size(i) == 1:
            ypl.append(Replicate())
        elif x_k and type(qw) is Shard and qw.dim == 0:
            ypl.append(Partial())  # summed below
        elif x_k or not isinstance(qx, (Replicate, Shard)) or isinstance(qw, Partial):
            raise ValueError(f"dense_apply: no local product for x {x.placements} "
                             f"@ w {w.placements}")
        elif type(qw) is Shard and qw.dim == 1 and isinstance(qx, Replicate):
            ypl.append(Shard(last))
        else:  # w replicated over this dim, or gathered over it
            wpl[i] = Replicate()
            ypl.append(qx)
    if wpl != list(w.placements):
        w = w.redistribute(mesh, wpl)
    xl, wl = x.to_local(), w.to_local()
    y = fixed_rows(lambda xx: xx @ wl, xl.reshape(-1, xl.shape[-1]))
    for i, q in enumerate(ypl):
        if isinstance(q, Partial):
            parts = funcol.all_gather_tensor(y, 0, (mesh, i)).view(mesh.size(i), *y.shape)
            y = parts[0]
            for j in range(1, mesh.size(i)):
                y = y + parts[j]
            ypl[i] = Replicate()
    return _from_local(y.reshape(*xl.shape[:-1], wl.shape[-1]), mesh, tuple(ypl),
                       (*x.shape[:-1], w.shape[-1]))


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor) and ("qvalues" in p or "bsvalues" in p):
        y = _blocks_meshed(serve_quant_apply if "qvalues" in p else draft_apply, p, x)
    elif "qvalues" in p:  # int8 block-sparse serving weights: the projection
        # dict was rewritten by ``quantize_serve_params``; the kernels
        # contract only the kept blocks against their per-block scales
        y = serve_quant_apply(p, x)
    elif "bsvalues" in p:  # the self-drafter's block-sparse weights
        # (``sparse_draft_params``), on ``block_sparse_matmul``
        y = draft_apply(p, x)
    else:
        w = p["kernel"].to(x.dtype)
        if isinstance(x, DTensor) and torch.is_grad_enabled():  # training: one product
            y = grad_in_layout(_rows_gathered(x) @ w)
        elif isinstance(x, DTensor):  # serving: each device's rows in fixed chunks
            y = _dense_meshed(_rows_gathered(x), w)
        else:
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


def _row_mean(t: torch.Tensor, floor: int) -> torch.Tensor:
    """The mean over t's last dim, over at least ``floor`` rows."""
    m = at_least_rows(lambda tt: tt.mean(-1, keepdim=True), t.reshape(-1, t.shape[-1]), floor)
    return m.reshape(*t.shape[:-1], 1)


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, or layernorm where ``p`` has a ``norm_bias``, in fp32, back
    to x's type.  Each mean runs over at least the row floor (a CUDA
    reduction picks its threads by the number of rows)."""

    floor = _row_floor(x)

    def mean(t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, DTensor):
            return _row_mean(t, floor)
        from torch.distributed.tensor import Replicate, Shard

        rows_whole = all(isinstance(q, Replicate) or (type(q) is Shard and q.dim < t.dim() - 1)
                         for q in t.placements)
        if torch.is_grad_enabled() or not rows_whole:  # as laid out
            return t.mean(-1, keepdim=True)
        # serving, the rows whole on each device: its own rows, with the
        # plain path's row floor
        return _from_local(_row_mean(t.to_local(), floor), t.device_mesh, t.placements,
                           (*t.shape[:-1], 1))

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
    rows: int = 0,  # the plain version's padded query rows; 0 = DECODE_QUERY_ROWS
) -> torch.Tensor:
    """Decode-style attention over the cache: query i (at absolute position
    ``pos + i``) attends cache positions ``<= pos + i``; everything beyond is
    masked.  C == 1 is a decode step, C > 1 the speculative-verify window,
    whose rows are each the decode step they replace.  A CPU tensor takes
    ``decode_attention_plain``; any other the hand kernel
    (``decode_attention_kernel``: the real C rows, each row's bits its own),
    which launches or raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, rows)
    return decode_attention_kernel(q, k_cache, v_cache, pos)


def decode_attention_plain(
    q: torch.Tensor,  # (B, C, H, Dh)
    k_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    v_cache: torch.Tensor,  # (B, S_max, KH, Dh)
    pos: torch.Tensor,  # (B,)
    rows: int = 0,  # query rows to pad to; 0 = DECODE_QUERY_ROWS
) -> torch.Tensor:
    """``decode_attention`` in plain PyTorch: one plain softmax per query row
    over all S_max positions (not the online-softmax flash path), as in the
    reference.  The query rows are padded to ``rows`` (the engine's
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


# Attention as one operator, for meshed runs.  Under a mesh each device
# attends with its own block of heads (or of query rows), and that math is
# the operator ``repro_torch::flash_attention``: its implementation is
# ``flash_attention`` itself, and its backward recomputes the forward and
# differentiates it (the graph plain autograd would run).  Being one
# operator, it has a shape function, so a run on fake tensors (the dry run)
# steps over the chunk loops in one call, and a FLOP formula, so
# ``FlopCounterMode`` counts what the loops execute.  Its transient score
# blocks are not seen by a memory tracker.


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor, causal: bool,
                       q_chunk: int, kv_chunk: int) -> torch.Tensor:
    return flash_attention(q, k, v, q_positions, kv_positions, causal, q_chunk, kv_chunk)


@flash_attention_op.register_fake
def _(q, k, v, q_positions, kv_positions, causal, q_chunk, kv_chunk):
    return q.new_empty(q.shape, dtype=v.dtype)


# The dispatcher's state outside any operator: an operator's backward runs
# its recomputation under it, so autograd records there (an operator's
# implementation is otherwise entered below the autograd keys).
_TOP_LEVEL_KEYS = (torch._C._dispatch_tls_local_include_set(),
                   torch._C._dispatch_tls_local_exclude_set())


def recompute_grad(fn, inputs, grads, *args):
    """The vector-Jacobian product of ``fn(*inputs, *args)`` with ``grads``,
    by running fn again under autograd (an operator's backward)."""
    with torch._C._ForceDispatchKeyGuard(*_TOP_LEVEL_KEYS), torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves, *args)
        return torch.autograd.grad(out, leaves, grads, allow_unused=True,
                                   materialize_grads=True)


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_attention_backward(grad: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_positions: torch.Tensor,
                              kv_positions: torch.Tensor, causal: bool, q_chunk: int,
                              kv_chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = recompute_grad(flash_attention, (q, k, v), grad, q_positions, kv_positions,
                                causal, q_chunk, kv_chunk)
    return dq, dk, dv


@_flash_attention_backward.register_fake
def _(grad, q, k, v, q_positions, kv_positions, causal, q_chunk, kv_chunk):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.args = inputs[5:]


def _flash_backward(ctx, grad):
    dq, dk, dv = _flash_attention_backward(grad, *ctx.saved_tensors, *ctx.args)
    return dq, dk, dv, None, None, None, None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def attention_flops(q_shape, k_shape, q_chunk: int, kv_chunk: int) -> int:
    """The products ``flash_attention`` executes: scores and p·v over every
    (padded) query chunk × key chunk."""
    b, sq, h, dh = q_shape
    skv = k_shape[1]
    kvc = min(kv_chunk, skv)
    return 4 * b * h * (-(-sq // q_chunk) * q_chunk) * (-(-skv // kvc) * kvc) * dh


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, qp_shape, kvp_shape, causal, q_chunk, kv_chunk, *args,
      **kwargs) -> int:
    return attention_flops(q_shape, k_shape, q_chunk, kv_chunk)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(grad_shape, q_shape, k_shape, v_shape, qp_shape, kvp_shape, causal, q_chunk, kv_chunk,
      *args, **kwargs) -> int:
    # the recomputed forward (2 products a block) and the four backward ones
    return 3 * attention_flops(q_shape, k_shape, q_chunk, kv_chunk)


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


def kv_repeat_factor(cfg: ModelConfig, tp: int) -> int:
    """Replication of KV heads so the head axis shards over ``tp`` devices
    (MaxText-style kv replication).  1 when no replication is needed."""
    kh = cfg.n_kv_heads
    r = 1
    while (kh * r) % tp and (kh * r) < cfg.n_heads:
        r += 1
    return r if (kh * r) % tp == 0 or (kh * r) == cfg.n_heads else 1


def _repeat_heads(t: torch.Tensor, r: int) -> torch.Tensor:
    """t (B, S, KH, Dh) with each head repeated r times in place
    (``jnp.repeat`` along the head axis)."""
    b, s, kh, dh = t.shape
    return t[:, :, :, None, :].expand(b, s, kh, r, dh).reshape(b, s, kh * r, dh)


def _cached_attention(flash, q, k, v, k_att, v_att, pos2d, cache_pos, *, decode: bool,
                      causal: bool, quant: bool, query_rows: int) -> torch.Tensor:
    """Attention over a cache that has just been written (see
    ``attention_apply``); ``flash`` is ``flash_attention`` or its operator,
    ``decode`` whether the rows attend decode-style (a decode step or a
    verify window)."""
    b = q.shape[0]
    s_max = k_att.shape[1]
    if decode:
        return decode_attention(q, k_att, v_att, cache_pos, query_rows)
    kv_pos = _kv_positions(b, s_max, q.device)
    if cache_pos is not None or quant:  # chunk-resume, or any int8-KV prefill
        return flash(q, k_att, v_att, pos2d, kv_pos, causal, PREFILL_QUERY_CHUNK, 1024)
    # whole-prompt prefill: the fresh (exact) k/v over the cache length
    return flash(q, _pad_axis1(k, s_max), _pad_axis1(v, s_max), pos2d, kv_pos, causal,
                 PREFILL_QUERY_CHUNK, 1024)


def _as_dtensor(plan, t: torch.Tensor) -> DTensor:
    return t if isinstance(t, DTensor) else plan.shard(t)


def _dim_offset(t: DTensor, dim: int) -> int:
    """Where this rank's block of ``t`` starts along ``dim`` (DTensor's
    nested split, mesh dims in order), from the mesh coordinate alone."""
    from torch.distributed.tensor import Shard

    size, off = t.shape[dim], 0
    coord = t.device_mesh.get_coordinate()
    for i, q in enumerate(t.placements):
        if isinstance(q, Shard) and q.dim == dim:
            chunk = -(-size // t.device_mesh.size(i))
            start = min(coord[i] * chunk, size)
            off, size = off + start, max(0, min(chunk, size - start))
    return off


def _write_rows_meshed(plan, pairs, pos: torch.Tensor) -> None:
    """``_write_rows`` into DTensor caches: each device writes the rows of
    its own block of the cache (the sequence dim too, where it is sharded),
    in place, with the reference's clamp of the start."""
    from torch.distributed.tensor import Replicate, Shard

    for cache, new in pairs:
        mesh, pl = cache.device_mesh, tuple(cache.placements)
        new_pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in pl)
        pos_pl = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in pl)
        n = _as_dtensor(plan, new).redistribute(mesh, new_pl).to_local()
        p = _as_dtensor(plan, pos).redistribute(mesh, pos_pl).to_local()
        c = cache.to_local()
        if not any(isinstance(q, Shard) and q.dim == 1 for q in pl):
            _write_rows(((c, n),), p)
            continue
        s = n.shape[1]
        start = torch.clamp(p.long(), 0, cache.shape[1] - s)
        rel = (torch.arange(c.shape[1], device=c.device)[None, :] + _dim_offset(cache, 1)
               - start[:, None])  # (B_loc, S_loc): the new row each place takes
        keep = (rel >= 0) & (rel < s)
        idx = torch.clamp(rel, 0, s - 1).reshape(*rel.shape, *([1] * (c.dim() - 2)))
        src = torch.gather(n.to(c.dtype), 1, idx.expand(*rel.shape, *c.shape[2:]))
        c.copy_(torch.where(keep.reshape(idx.shape), src, c))


def attention_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) or (B, 3, S) for mrope
    *,
    plan=None,  # MeshPlan | None
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
    Sharding (when ``plan`` has a mesh and x is a DTensor), as the
    reference: KV heads are repeated ``plan.kv_repeat``× so the head axis
    divides TP; q/k/v are constrained head-sharded (``heads``), query rows
    sequence-sharded with K/V replicated over tp (``seq``, S > 1) or
    head_dim-sharded (``head_dim``).  In the first two modes every device
    attends with its own heads or query rows (``plan.local`` over the
    ``repro_torch::flash_attention`` operator); a decode step in ``seq``
    mode (its cache sequence-sharded) and ``head_dim`` mode run as DTensor
    ops.  The cache is written where each device holds it and constrained
    to ``plan.cache_spec()``.  The paged pool has no meshed layout.
    """
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(dense_apply(p["wq"], x), h, dh)
    k = split_heads(dense_apply(p["wk"], x), kh, dh)
    v = split_heads(dense_apply(p["wv"], x), kh, dh)
    if cfg.pos_enc in ("rope", "mrope"):
        ang = rope_angles(cfg, positions)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    pos2d = positions if positions.dim() == 2 else positions[:, 0, :]

    meshed = plan is not None and plan.mesh is not None and isinstance(x, DTensor)
    if meshed:
        return _attention_meshed(p, plan, q, k, v, pos2d, cache=cache,
                                 cache_scales=cache_scales, cache_pos=cache_pos,
                                 block_table=block_table, causal=causal,
                                 decode_chunk=decode_chunk, query_rows=query_rows)
    if cache is None:  # training and the encoder: marked for the profiler's split
        with record_function("attention"):
            out = flash_attention(q, k, v, pos2d, pos2d, causal=causal, q_chunk=min(512, s))
        return dense_apply(p["wo"], merge_heads(out)), None
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
    out = _cached_attention(flash_attention, q, k, v, k_att, v_att, pos2d, cache_pos,
                            decode=s == 1 or (decode_chunk and cache_pos is not None),
                            causal=causal, quant=quant, query_rows=query_rows)
    new_cache = (k_c, v_c, ks_c, vs_c) if quant else (k_c, v_c)
    return dense_apply(p["wo"], merge_heads(out)), new_cache


def _attention_meshed(p, plan, q, k, v, pos2d, *, cache, cache_scales, cache_pos, block_table,
                      causal, decode_chunk, query_rows):
    """``attention_apply`` on DTensors (see its docstring)."""
    b, s, h, dh = q.shape
    if plan.kv_repeat > 1:  # TP-friendly KV head replication
        k, v = _repeat_heads(k, plan.kv_repeat), _repeat_heads(v, plan.kv_repeat)
    dp, tp = plan.dp, plan.tp
    local = plan.attn_shard == "heads" or (plan.attn_shard == "seq" and s > 1)
    if plan.attn_shard == "heads":
        q_spec = kv_spec = (dp, None, tp, None)
        qpos_spec = (dp, None)
    elif plan.attn_shard == "seq" and s > 1:
        # sequence-parallel attention: queries keep their S-shard, K/V
        # replicate over tp; each shard attends its query slice over full K/V
        # (a prompt whose length tp does not divide: every device attends
        # all of it, as an uneven split has no local blocks of one shape)
        q_spec, kv_spec, qpos_spec = (dp, tp, None, None), (dp, None, None, None), (dp, tp)
        if s % plan.tp_size:
            q_spec, qpos_spec = kv_spec, (dp, None)
    elif plan.attn_shard == "head_dim":
        q_spec = kv_spec = (dp, None, None, tp)
        qpos_spec = (dp, None)
    else:
        q_spec = kv_spec = qpos_spec = None
    if q_spec is not None:
        q, k, v = plan.constrain(q, *q_spec), plan.constrain(k, *kv_spec), plan.constrain(
            v, *kv_spec)

    if cache is None:
        with record_function("attention"):
            if local:  # this device's heads / query rows, one operator
                out = plan.local(flash_attention_op, q_spec, q, k, v,
                                 plan.shard(pos2d, *qpos_spec), plan.shard(pos2d, dp, None),
                                 causal, min(512, s), 1024)
            else:
                out = flash_attention(q, k, v, pos2d, pos2d, causal=causal, q_chunk=min(512, s))
        return dense_apply(p["wo"], merge_heads(out)), None
    if block_table is not None:
        raise NotImplementedError("the paged KV pool has no meshed layout")
    if cache_pos is None and s == 1:
        raise ValueError("a decode step (S == 1) needs cache_pos")
    quant = cache_scales is not None
    k_c, v_c = cache
    pairs = ((k_c, k), (v_c, v))
    if quant:
        ks_c, vs_c = cache_scales
        (k_w, ks_new), (v_w, vs_new) = quantize_kv(k), quantize_kv(v)
        pairs = ((k_c, k_w), (v_c, v_w), (ks_c, ks_new), (vs_c, vs_new))
    write_pos = (cache_pos if cache_pos is not None
                 else torch.zeros((b,), dtype=torch.long, device=q.device))
    _write_rows_meshed(plan, pairs, write_pos)
    cspec = plan.cache_spec()
    k_c, v_c = plan.constrain(k_c, *cspec), plan.constrain(v_c, *cspec)
    if quant:
        ks_c, vs_c = plan.constrain(ks_c, *cspec[:3]), plan.constrain(vs_c, *cspec[:3])
        k_att, v_att = dequantize_kv(k_c, ks_c, q.dtype), dequantize_kv(v_c, vs_c, q.dtype)
    else:
        k_att, v_att = k_c, v_c
    kw = dict(decode=s == 1 or (decode_chunk and cache_pos is not None), causal=causal,
              quant=quant, query_rows=query_rows)
    if local:
        k_att, v_att = plan.constrain(k_att, *kv_spec), plan.constrain(v_att, *kv_spec)
        cp = None if cache_pos is None else plan.shard(cache_pos, dp)
        out = plan.local(
            lambda q_, k_, v_, ka, va, pos_, cp_: _cached_attention(
                flash_attention_op, q_, k_, v_, ka, va, pos_, cp_, **kw),
            q_spec, q, k, v, k_att, v_att, plan.shard(pos2d, *qpos_spec), cp)
    elif plan.attn_shard == "seq" and (s == 1 or decode_chunk):
        # flash-decode: each device attends over its block of the
        # sequence-sharded cache, the partial softmaxes combined over tp
        q = plan.constrain(q, dp, None, None, None)
        off, group = _dim_offset(k_att, 1), plan.mesh.get_group(plan.tp_axis)
        out = plan.local(
            lambda q_, ka, va, cp_: _decode_over_shards(q_, ka, va, cp_, off, group, query_rows),
            (dp, None, None, None), q, k_att, v_att, plan.shard(cache_pos, dp))
    else:
        out = _cached_attention(flash_attention, q, k, v, k_att, v_att, pos2d, cache_pos, **kw)
    new_cache = (k_c, v_c, ks_c, vs_c) if quant else (k_c, v_c)
    return dense_apply(p["wo"], merge_heads(out)), new_cache


def _decode_over_shards(q, k, v, pos, off: int, group, rows: int) -> torch.Tensor:
    """``decode_attention`` over one device's block of the cache (positions
    off … off + S_loc − 1), its softmax's max, sum and p·v combined over
    ``group`` (flash-decode).  The same math as ``decode_attention`` up to
    the order of the sums."""
    from torch.distributed import _functional_collectives as fc

    b, c, h, dh = q.shape
    kh = k.shape[2]
    cp = max(c, rows or DECODE_QUERY_ROWS.get(q.device.type, 1))
    qg = _pad_axis1(q, cp).reshape(b, cp, kh, h // kh, dh)
    s = _gqa_scores(qg, k, dh**-0.5)  # (B,KH,G,Cp,S_loc) fp32
    idx = off + torch.arange(k.shape[1], device=q.device)
    qpos = pos[:, None] + torch.arange(cp, dtype=pos.dtype, device=q.device)[None, :]
    s = torch.where((idx[None, None, :] <= qpos[:, :, None])[:, None, None], s, -1e30)
    m = (s.amax(-1, keepdim=True) if s.shape[-1]  # (an uneven split may leave none)
         else s.new_full((*s.shape[:-1], 1), -1e30))
    m = fc.all_reduce(m, "max", group)
    e = torch.exp(s - m)
    denom = fc.all_reduce(e.sum(-1, keepdim=True), "sum", group)
    num = fc.all_reduce(torch.einsum("bkgqs,bskd->bkgqd", e, v.float()), "sum", group)
    out = (num / denom).to(v.dtype)
    return out[:, :, :, :c].permute(0, 3, 1, 2, 4).reshape(b, c, h, dh)


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
    if isinstance(tokens, DTensor):  # DTensor's embedding rule (a row gather)
        return F.embedding(tokens, p["embedding"]).to(dtype)
    return p["embedding"][tokens].to(dtype)


def lm_head_init(gen, cfg: ModelConfig, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)


def lm_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense_apply(p, x)


def tied_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The tied LM head: x @ embedding.T in x's type (``tie_embeddings``)."""
    return dense_apply({"kernel": p["embedding"].to(x.dtype).T}, x)

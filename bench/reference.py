"""The plain reference: a dense GQA SwiGLU transformer (Mistral's and
InternLM2's layer equations) in float32, with no kernel, cache or batching,
run layer by layer over whole sequences: the reference of every
configuration that names none.  It imports nothing of the program.

It makes each layer's bf16 weights again from the seed, with the dense
family's draws (``bench/families/dense.py``, over ``bench/weights.py``), and
works out the served weights from them itself: balanced top-|L1| block
pruning, then one symmetric int8 scale per kept block (max|block| / 127),
as SONIC's C1 step and the int8 serving format define them.  TF32 is off
while it runs.

``control`` runs beside it the same model with every product's two operands
rounded to float8 e4m3 (a scale per row of the activations, per block of
the weights): the precision below the bf16 the configuration states.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from bench import weights as W
from bench.families import dense as D

FP8_MAX = 448.0  # float8 e4m3's largest finite value


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def served_weight(w: torch.Tensor, block, sparsity: float) -> torch.Tensor:
    """(K, N) float32: w block-pruned (top-|L1| K-blocks per column block,
    the kept count rounded from (1 − sparsity)) and int8-quantized with one
    scale per block, dequantized."""
    k, n = w.shape
    bk, bn = block
    kb, nb = k // bk, n // bn
    kept = max(int(round(kb * (1.0 - sparsity))), 1)
    blocks = w.float().view(kb, bk, nb, bn)
    l1 = blocks.abs().sum(dim=(1, 3))  # (kb, nb)
    keep = torch.zeros_like(l1, dtype=torch.bool)
    keep.scatter_(0, l1.topk(kept, dim=0).indices, True)
    absmax = blocks.abs().amax(dim=(1, 3))
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[:, None, :, None]), -127, 127)
    return (q * (scale * keep)[:, None, :, None]).view(k, n)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last dim), back in
    float32."""
    s = x.abs().amax(dim=-1, keepdim=True) / FP8_MAX
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_weight(w: torch.Tensor, block) -> torch.Tensor:
    """A (K, N) weight rounded to float8 e4m3 with one scale per block."""
    k, n = w.shape
    bk, bn = block
    b = w.view(k // bk, bk, n // bn, bn)
    s = b.abs().amax(dim=(1, 3), keepdim=True) / FP8_MAX
    s = torch.where(s > 0, s, torch.ones_like(s))
    return ((b / s).to(torch.float8_e4m3fn).float() * s).view(k, n)


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) rotated by its positions 0..T−1 (rotate-half)."""
    t, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Stream:
    """One precision's pass: the products' operands as they are (float32)
    or rounded to float8."""

    def __init__(self, low: bool, block):
        self.low, self.block = low, block

    def act(self, x):
        return fp8(x) if self.low else x

    def weight(self, w):
        return fp8_weight(w, self.block) if self.low else w


def _attention(s: _Stream, q, k, v, chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention of q (T, H, hd) over k, v (T, KH, hd)."""
    t, h, hd = q.shape
    g = h // k.shape[1]
    k = s.act(k).repeat_interleave(g, dim=1).transpose(0, 1)  # (H, T, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    v = s.act(v.transpose(1, 2)).transpose(1, 2)  # scaled along T, p·v's contraction
    q = s.act(q).transpose(0, 1)
    out = []
    for q0 in range(0, t, chunk):
        qi = q[:, q0:q0 + chunk]
        sc = qi @ k.transpose(1, 2) / math.sqrt(hd)  # (H, c, T)
        pos = torch.arange(q0, q0 + qi.shape[1], device=q.device)
        sc = sc.masked_fill(torch.arange(t, device=q.device)[None] > pos[:, None], -math.inf)
        out.append(s.act(torch.softmax(sc, dim=-1)) @ v)
    return torch.cat(out, dim=1).transpose(0, 1).reshape(t, h * hd)


def _layer(s: _Stream, model: dict, ws: dict, x: torch.Tensor) -> torch.Tensor:
    h, kh, hd = model["num_attention_heads"], model["num_key_value_heads"], model["head_dim"]
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    a = s.act(_rms(x, eps))
    q = _rope((a @ ws["attn/wq"]).view(-1, h, hd), theta)
    k = _rope((a @ ws["attn/wk"]).view(-1, kh, hd), theta)
    v = (a @ ws["attn/wv"]).view(-1, kh, hd)
    x = x + s.act(_attention(s, q, k, v)) @ ws["attn/wo"]
    b = s.act(_rms(x, eps))
    f = torch.nn.functional.silu(b @ ws["ffn/wi"]) * (b @ ws["ffn/wg"])
    return x + s.act(f) @ ws["ffn/wo"]


@torch.inference_mode()
def logit_gaps(model: dict, seed: int, device, seqs: list[tuple[np.ndarray, list[int]]],
               control: bool = False) -> dict:
    """Over every served token of ``seqs`` (prompt, served tokens): the gap
    by which the served token's logit lies below the reference's best
    there.  Returns {"gap": the widest, "tokens": how many were read, and
    with ``control`` "control_gap": the widest gap of the token that the
    float8 pass puts first at each of the same positions}."""
    block, sparsity = model["compression"]["block"], model["compression"]["sparsity"]
    streams = [_Stream(False, block)] + ([_Stream(True, block)] if control else [])
    toks = [torch.as_tensor(np.concatenate([p, np.asarray(o[:-1], np.int64)]), device=device)
            for p, o in seqs]
    with no_tf32():
        emb = W.embedding(model, seed, device)
        xs = [[emb[t].float() for t in toks] for _ in streams]
        del emb
        for layer in range(model["num_hidden_layers"]):
            ws = {name: served_weight(D.projection(model, seed, name, layer, device), block,
                                      sparsity) for name in D.shapes(model)}
            for s, x in zip(streams, xs):
                sw = {name: s.weight(w) for name, w in ws.items()}
                x[:] = [_layer(s, model, sw, xi) for xi in x]
            del ws
        head = served_weight(D.projection(model, seed, "lm_head", -1, device), block, sparsity)
        out = {"gap": 0.0, "tokens": 0}
        if control:
            out["control_gap"] = 0.0
        low_head = streams[-1].weight(head) if control else None
        for i, (p, o) in enumerate(seqs):
            first = len(p) - 1
            ref = _rms(xs[0][i][first:], model["rms_norm_eps"]) @ head  # (n, V)
            best = ref.max(dim=-1).values
            served = torch.as_tensor(o, device=device)
            gaps = best - ref.gather(1, served[:, None])[:, 0]
            out["gap"] = max(out["gap"], _widest(gaps))
            out["tokens"] += len(o)
            if control:
                low = streams[1].act(_rms(xs[1][i][first:], model["rms_norm_eps"])) @ low_head
                pick = low.argmax(dim=-1)
                out["control_gap"] = max(out["control_gap"],
                                         _widest(best - ref.gather(1, pick[:, None])[:, 0]))
    return out


def _widest(gaps: torch.Tensor) -> float:
    """The largest gap; inf where any reading is not finite."""
    if not bool(torch.isfinite(gaps).all()):
        return math.inf
    return float(gaps.max())

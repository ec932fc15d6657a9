"""SONIC serving weight formats: balanced block sparsity and int8 blocks.

The port of ``repro.core.sonic_layers`` for the served model's path: the
block-sparse and int8 block-sparse weight formats, their converters, and the
one-time rewrite of a model's projections into int8 block-sparse form
(``quantize_serve_params``).  ``serve_quant_apply`` is how a rewritten
projection is applied: through the hand-written kernels on the card, their
plain versions on the CPU (``repro_torch.kernels.sonic_matmul.ops``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BlockSparseWeight:
    """Balanced block-sparse weight for x[.., K] @ W[K, N].

    W is partitioned into (bk × bn) blocks on a (Kb × Nb) grid; every output
    column-block keeps the same number r of nonzero K-blocks.

      values:  (Nb, r, bk, bn)   kept blocks, dense inside
      indices: (Nb, r) int32     which K-block each kept block came from
    """

    values: torch.Tensor
    indices: torch.Tensor
    k_blocks: int  # Kb

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        return _densify(self.values.to(dtype), self.indices, self.k_blocks)


def _densify(values: torch.Tensor, indices: torch.Tensor, k_blocks: int) -> torch.Tensor:
    """Scatter kept (Nb, r, bk, bn) blocks back into a dense (K, N) matrix."""
    nb, _, bk, bn = values.shape
    out = torch.zeros((k_blocks, nb, bk, bn), dtype=values.dtype, device=values.device)
    cols = torch.arange(nb, device=values.device)[:, None]
    out[indices.long(), cols] = values
    return out.permute(0, 2, 1, 3).reshape(k_blocks * bk, nb * bn)


def make_block_sparse(
    w: torch.Tensor, sparsity: float, block: tuple[int, int]
) -> BlockSparseWeight:
    """Balanced block-prune W[K, N]: keep top-r L1-norm K-blocks per N-block."""
    k, n = w.shape
    bk, bn = block
    if k % bk or n % bn:
        raise ValueError(f"{tuple(w.shape)} not divisible by block {block}")
    kb, nb = k // bk, n // bn
    r = max(int(round(kb * (1.0 - sparsity))), 1)
    blocks = w.reshape(kb, bk, nb, bn).permute(2, 0, 1, 3)  # (nb, kb, bk, bn)
    norms = blocks.float().abs().sum(dim=(-2, -1))  # (nb, kb)
    idx = torch.topk(norms, r, dim=1).indices
    idx = idx.sort(dim=1).values  # ascending K order → sequential streaming
    vals = torch.take_along_dim(blocks, idx[:, :, None, None], dim=1)
    return BlockSparseWeight(values=vals.contiguous(), indices=idx.to(torch.int32),
                             k_blocks=kb)


@dataclasses.dataclass
class BlockSparseWeightInt8:
    """Int8-quantized balanced block-sparse weight.

    Same (Nb × r) kept-block structure as :class:`BlockSparseWeight`, with
    the block values stored as int8 and one fp32 scale per kept block; the
    kernels dequantize against ``scales`` as they stream the block.

      values:  (Nb, r, bk, bn) int8   kept blocks, symmetric per-block quant
      scales:  (Nb, r) float32        dequant scale (value = int8 * scale)
      indices: (Nb, r) int32          which K-block each kept block came from

    All-zero blocks get scale 1.0 and all-zero int8 values, so they
    dequantize to exact zeros.
    """

    values: torch.Tensor
    scales: torch.Tensor
    indices: torch.Tensor
    k_blocks: int  # Kb

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        deq = self.values.float() * self.scales[:, :, None, None]
        return _densify(deq, self.indices, self.k_blocks).to(dtype)


def quantize_block_sparse(bs: BlockSparseWeight) -> BlockSparseWeightInt8:
    """Symmetric per-block int8 quantization of a block-sparse weight.

    scale = max|block| / 127, except all-zero blocks take scale 1.0 so their
    dequantized values are EXACTLY zero (a divide-by-zero epsilon would turn
    pruned blocks into tiny nonzeros and break the density-0 identity)."""
    vals = bs.values.float()
    absmax = vals.abs().amax(dim=(-2, -1))  # (nb, r)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(vals / scales[:, :, None, None]), -127, 127)
    return BlockSparseWeightInt8(
        values=q.to(torch.int8),
        scales=scales.to(torch.float32),
        indices=bs.indices,
        k_blocks=bs.k_blocks,
    )


def make_block_sparse_int8(
    w: torch.Tensor, sparsity: float, block: tuple[int, int]
) -> BlockSparseWeightInt8:
    """Block-prune then int8-quantize W[K, N] (prune → per-block scale)."""
    return quantize_block_sparse(make_block_sparse(w, sparsity, block))


def block_sparse_int8_matmul_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    scales: torch.Tensor,
    indices: torch.Tensor,
    k_blocks: int,
) -> torch.Tensor:
    """Gather the live K-blocks of x and contract only the kept blocks
    (density × dense flops).  Like the reference, the dequantized weights are
    cast to ``x.dtype``, so the product runs in x's type; the kernels'
    plain versions call this with fp32 x."""
    nb, _, bk, bn = values.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    xg = x2.reshape(m, k_blocks, bk)[:, indices.long()]  # (m, nb, r, bk)
    deq = values.to(x2.dtype) * scales[:, :, None, None].to(x2.dtype)
    y = torch.einsum("mnrk,nrkj->mnj", xg, deq)
    return y.reshape(*lead, nb * bn)


def _auto_block(k: int, n: int, cap: int = 128) -> tuple[int, int]:
    """Largest power-of-two block ≤ ``cap`` dividing each dim."""

    def side(d: int) -> int:
        b = 1
        while b * 2 <= min(cap, d) and d % (b * 2) == 0:
            b *= 2
        return b

    return side(k), side(n)


def quantize_serve_params(
    params: dict,
    sparsity: float = 0.0,
    block: tuple[int, int] | None = None,
) -> dict:
    """Quantize a transformer's linear weights to int8 block-sparse form for
    serving.

    Every ``{"kernel": ...}`` projection dict in the tree (stacked (L, K, N)
    layer kernels AND the 2-D LM head) is rewritten as

        {"qvalues":  (..., Nb, r, bk, bn) int8,
         "qscales":  (..., Nb, r) float32,
         "qindices": (..., Nb, r) int32}

    with the leading L axis kept for stacked kernels.  Every other leaf
    (embeddings, norm scales) rides along unchanged.  ``sparsity=0.0`` keeps
    every block: pure quantization, no pruning.  Runs on whatever device the
    weights are on."""

    def quant_one(w: torch.Tensor) -> dict:
        blk = block or _auto_block(w.shape[0], w.shape[1])
        q = make_block_sparse_int8(w, sparsity, blk)
        return {"qvalues": q.values, "qscales": q.scales, "qindices": q.indices}

    def quant_stack(w: torch.Tensor) -> dict:
        per = [quant_one(w[i]) for i in range(w.shape[0])]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if key == "kernel" and getattr(val, "ndim", 0) in (2, 3):
                out.update(quant_one(val) if val.ndim == 2 else quant_stack(val))
            else:
                out[key] = walk(val)
        return out

    return walk(params)


def serve_quant_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply one quantized projection dict (``quantize_serve_params`` leaf,
    with any leading L axis already sliced off) to x (..., K)."""
    # imported here: the kernel modules import this one
    from repro_torch.kernels.sonic_matmul.ops import sonic_matmul_int8

    return sonic_matmul_int8(x, p["qvalues"], p["qscales"], p["qindices"])

"""SONIC weight formats and the switchable linear layer.

The port of ``repro.core.sonic_layers``: the block-sparse and int8
block-sparse weight formats and their converters, the one-time rewrite of a
model's projections into int8 block-sparse form (``quantize_serve_params``,
applied by ``serve_quant_apply``), and the execution-mode layer
``sonic_linear_apply`` with its converter ``convert_linear``.  Its modes:

  dense / masked     x @ W
  topk               static-k activation compression (plain torch ops)
  clustered          int8 cluster ids + codebook          (C2 serving path)
  block_sparse       only the kept blocks are streamed    (C1 serving path)
  sonic              block sparsity × cluster ids, fused  (C1+C2 serving path)
  block_sparse_int8  kept blocks as int8 × a per-block scale
  sonic_int8         the same, shape-dispatched like "sonic"

With ``use_kernel=True`` the last five run the hand-written kernels on a
CUDA tensor and their plain versions on a CPU tensor; with
``use_kernel=False`` they run the reference's fallbacks, in x's type.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

from repro_torch.core.activation_sparsity import sparse_ffn_matmul
from repro_torch.core.clustering import ClusteredWeight

Mode = Literal[
    "dense", "masked", "clustered", "block_sparse", "topk", "sonic",
    "block_sparse_int8", "sonic_int8",
]


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

    @property
    def dense_shape(self) -> tuple[int, int]:
        nb, _, bk, bn = self.values.shape
        return self.k_blocks * bk, nb * bn

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


@dataclasses.dataclass(frozen=True)
class SonicExecutionConfig:
    mode: Mode = "dense"
    use_kernel: bool = False  # the hand-written kernels (plain versions on the CPU)
    topk_frac: float = 0.25  # kept fraction for the "topk" path
    block: tuple[int, int] = (128, 128)
    weight_sparsity: float = 0.75
    num_clusters: int = 64


@dataclasses.dataclass
class SonicLinearParams:
    """Union container: exactly one representation is populated."""

    w: torch.Tensor | None = None  # (K, N) dense or masked
    clustered: ClusteredWeight | None = None
    block_sparse: BlockSparseWeight | None = None
    sonic: Any | None = None  # kernels.sonic_matmul.ops.SonicWeight (fused C1+C2)
    block_sparse_int8: BlockSparseWeightInt8 | None = None


def sonic_linear_apply(
    params: SonicLinearParams, x: torch.Tensor, config: SonicExecutionConfig
) -> torch.Tensor:
    """y = x @ W through the configured execution path; x (..., K) → (..., N)."""
    # the kernel modules import this one
    from repro_torch.kernels.block_sparse_matmul import ops as bs_ops
    from repro_torch.kernels.clustered_matmul import ops as cm_ops
    from repro_torch.kernels.sonic_matmul import ops as sm_ops
    from repro_torch.kernels.sonic_matmul.ref import sonic_matmul_ref

    mode = config.mode
    if mode in ("dense", "masked"):
        return x @ params.w.to(x.dtype)
    if mode == "topk":
        k = max(int(round(config.topk_frac * params.w.shape[0])), 1)
        return sparse_ffn_matmul(x, params.w.to(x.dtype), k)
    if mode == "clustered":
        cw = params.clustered
        if config.use_kernel:
            return cm_ops.clustered_matmul(x, cw.indices, cw.codebook)
        return x @ cw.dense(x.dtype)
    if mode == "block_sparse":
        bs = params.block_sparse
        if config.use_kernel:
            return bs_ops.block_sparse_matmul(x, bs)
        return x @ bs.dense(x.dtype)
    if mode in ("block_sparse_int8", "sonic_int8"):
        q = params.block_sparse_int8
        if config.use_kernel:
            # "sonic_int8" dispatches decode rows to the matvec kernel;
            # "block_sparse_int8" takes the tiled kernel for every M
            fn = (sm_ops.sonic_matmul_int8 if mode == "sonic_int8"
                  else bs_ops.block_sparse_matmul_int8)
            return fn(x, q.values, q.scales, q.indices)
        return block_sparse_int8_matmul_plain(x, q.values, q.scales, q.indices, q.k_blocks)
    if mode == "sonic":
        sw = params.sonic
        if config.use_kernel:
            return sm_ops.sonic_matmul(x, sw)
        lead = x.shape[:-1]
        y = sonic_matmul_ref(x.reshape(-1, x.shape[-1]), sw.idx_values, sw.codebook,
                             sw.indices, sw.k_blocks)
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)
    raise ValueError(f"unknown mode {mode!r}")


def convert_linear(w: torch.Tensor, config: SonicExecutionConfig) -> SonicLinearParams:
    """Convert a trained dense W[K, N] into the configured serving format, on
    W's device."""
    if config.mode == "clustered":
        from repro_torch.core.clustering import ClusteringConfig, pack_clustered

        cw = pack_clustered(w, ClusteringConfig(num_clusters=config.num_clusters))
        return SonicLinearParams(clustered=cw)
    if config.mode == "block_sparse":
        return SonicLinearParams(
            block_sparse=make_block_sparse(w, config.weight_sparsity, config.block))
    if config.mode == "sonic":
        from repro_torch.kernels.sonic_matmul.ops import make_sonic_weight

        return SonicLinearParams(sonic=make_sonic_weight(
            w, sparsity=config.weight_sparsity, block=config.block,
            num_clusters=config.num_clusters))
    if config.mode in ("block_sparse_int8", "sonic_int8"):
        return SonicLinearParams(block_sparse_int8=make_block_sparse_int8(
            w, config.weight_sparsity, config.block))
    return SonicLinearParams(w=w)


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

"""SONIC weight formats and the switchable linear layer.

The port of ``repro.core.sonic_layers``: the block-sparse and int8
block-sparse weight formats and their converters, the one-time rewrite of a
model's projections into int8 block-sparse form (``quantize_serve_params``,
applied by ``serve_quant_apply``), the two drafters of speculative decoding
(``sparse_draft_params``, kept block-sparse and applied by ``draft_apply``;
``truncated_draft_params``), and the execution-mode layer
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

from repro_torch.core.activation_sparsity import sparse_ffn_matmul, top_k
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
    idx = top_k(norms, r)
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


def sparse_draft_params(
    params: dict,
    sparsity: float,
    block: tuple[int, int] | None = None,
    num_clusters: int = 0,
    dtype: torch.dtype | None = None,
) -> dict:
    """The self-drafter of speculative decoding
    (``serve.engine.SpecConfig(draft="self")``): a transformer's stacked
    layer kernels in SONIC block-sparse form, kept block-sparse.

    Every stacked ``{"kernel": (L, K, N)}`` under ``params["layers"]`` is
    pruned as the reference prunes it (``make_block_sparse`` per layer at
    ``block`` or ``_auto_block``'s, then, when ``num_clusters > 0``,
    ``pack_clustered`` over the kept values of each matrix) and becomes

        {"bsvalues":  (L, Nb, R, bk, bn) in ``dtype`` (default: the kernel's),
         "bsindices": (L, Nb, R) int32}

    which ``models.layers.dense_apply`` runs on ``block_sparse_matmul``: the
    reference densifies the same blocks again and multiplies by them cast
    to x's type, so storing them in the compute type keeps its weights.
    A projection's other leaves (its ``bias``) ride along.  An MoE router's
    (L, d, E) kernel is pruned as every 3-D leaf is, and densified again in
    its own type (fp32), as the reference's: ``models.moe._router`` reads a
    dense fp32 kernel.  The 4-D expert stacks, embeddings and norms are
    shared unchanged, and so is the LM head but that, with ``dtype``, its
    kernel is cast to it once (the reference casts it at every use).
    ``sparsity=0.0`` keeps every block (an exact conversion)."""

    def convert(w: torch.Tensor, dtype=dtype) -> dict:
        blk = block or _auto_block(w.shape[1], w.shape[2])
        vals, idx = [], []
        for i in range(w.shape[0]):
            bs = make_block_sparse(w[i], sparsity, blk)
            v = bs.values
            if num_clusters > 0:
                from repro_torch.core.clustering import ClusteringConfig, pack_clustered

                nb, r, bk, bn = v.shape
                cw = pack_clustered(v.reshape(nb * r * bk, bn),
                                    ClusteringConfig(num_clusters=num_clusters))
                v = cw.dense(w.dtype).reshape(nb, r, bk, bn)
            vals.append(v.to(dtype or w.dtype))
            idx.append(bs.indices)
        return {"bsvalues": torch.stack(vals), "bsindices": torch.stack(idx)}

    def walk(node, name: str = ""):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if getattr(w, "ndim", 0) == 3:
            rest = {key: val for key, val in node.items() if key != "kernel"}
            if name == "router":
                return {**rest, "kernel": draft_leaf_dense(convert(w, None), w.shape[1])}
            return {**rest, **convert(w)}
        return {key: walk(val, key) for key, val in node.items()}

    out = {**params, "layers": walk(params["layers"])}
    head = params.get("lm_head", {})
    if dtype is not None and "kernel" in head:
        out["lm_head"] = {**head, "kernel": head["kernel"].to(dtype)}
    return out


def draft_leaf_dense(p: dict, k: int) -> torch.Tensor:
    """One ``sparse_draft_params`` leaf back in dense form (L, K, N), for
    checking it against the reference's densified drafter."""
    vals, idx = p["bsvalues"], p["bsindices"]
    kb = k // vals.shape[3]
    return torch.stack([_densify(vals[i], idx[i], kb) for i in range(vals.shape[0])])


def draft_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply one ``sparse_draft_params`` projection (any leading L axis
    already sliced off) to x (..., K) on ``block_sparse_matmul``."""
    # imported here: the kernel modules import this one
    from repro_torch.kernels.block_sparse_matmul.ops import block_sparse_matmul

    vals = p["bsvalues"]
    return block_sparse_matmul(x, BlockSparseWeight(vals, p["bsindices"],
                                                    x.shape[-1] // vals.shape[2]))


def truncated_draft_params(params: dict, n_layers: int) -> dict:
    """The first ``n_layers`` of a transformer's stacked layer params (views
    of the served leaves), sharing the embed, final norm and LM head: the
    layer-skipping self-drafter (``SpecConfig(draft="truncate:N")``).  Its
    weights are the verifier's first layers, so its KV for any context is
    the verifier's there, and it drafts from the verifier's cache."""

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(val) for key, val in node.items()}
        return node[:n_layers]

    return {**params, "layers": walk(params["layers"])}


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
    (embeddings, norm scales, biases) rides along unchanged.
    ``sparsity=0.0`` keeps every block: pure quantization, no pruning.  Runs
    on whatever device the weights are on.

    An MoE tree is refused (``ValueError``): the walk would rewrite the
    router's ``{"kernel": (L, d, E)}`` too, which ``models.moe._router``
    reads as a dense kernel (the reference fails there, later, with
    ``KeyError: 'kernel'``).  So are the hybrid (zamba2) and rwkv trees,
    whose Mamba2 and RWKV blocks read their projections as ``["kernel"]``
    (the reference fails there the same way): the error names the first
    leaf the block reads so."""
    moe = params.get("layers", {}).get("moe")
    if isinstance(moe, dict) and "kernel" in moe.get("router", {}):
        raise ValueError("weight_quant='int8' would rewrite the MoE router's kernel "
                         "(layers/moe/router/kernel), which the router reads dense: "
                         "serve an MoE model with weight_quant='none'")
    for leaf, family in (("mamba_layers/block/in_proj/kernel", "hybrid (Mamba2)"),
                         ("layers/time_mix/wr/kernel", "rwkv")):
        node = params
        for key in leaf.split("/")[:-1]:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        if isinstance(node, dict) and "kernel" in node:
            raise ValueError(f"weight_quant='int8' would rewrite {leaf}, which the "
                             f"{family} block reads as a dense kernel: serve this model "
                             f"with weight_quant='none'")

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

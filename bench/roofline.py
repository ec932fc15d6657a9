"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the problem a served step solves.

Counts come from the configuration's shapes alone, never from the program's
tensors or kernels, so a later change that fuses, splits or renames kernels
leaves them as they are.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, no structured sparsity),
the same figures as ``src/repro_torch/roofline/hw.py`` (``H100``) and
``chip_smoke.py``.  They hold at the card's full power limit (700 W); every
result line records the limit the card was set to.
"""
from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_HBM_BYTES_S = 3.35e12  # HBM3
KV_BYTES = 2  # bf16 cache


@dataclasses.dataclass(frozen=True)
class Projection:
    """One int8 block-sparse projection x (M, k) @ W (k, n), ``kept`` of its
    (k / bk) K-blocks kept in each of its (n / bn) column blocks."""

    name: str
    k: int
    n: int
    bk: int
    bn: int
    kept: int

    @property
    def int8_bytes(self) -> int:
        return (self.n // self.bn) * self.kept * self.bk * self.bn

    @property
    def blocks(self) -> int:
        return (self.n // self.bn) * self.kept


def kept_blocks(k: int, bk: int, sparsity: float) -> int:
    """K-blocks kept per column block under balanced block pruning."""
    return max(int(round((k // bk) * (1.0 - sparsity))), 1)


def projections(model: dict) -> tuple[list[Projection], Projection]:
    """(one layer's seven projections, the LM head) of a dense GQA SwiGLU
    model described by its configuration file's keys."""
    d, h, kh = model["hidden_size"], model["num_attention_heads"], model["num_key_value_heads"]
    hd, f, v = model["head_dim"], model["intermediate_size"], model["vocab_size"]
    bk, bn = model["compression"]["block"]
    s = model["compression"]["sparsity"]

    def proj(name, k, n):
        return Projection(name, k, n, bk, bn, kept_blocks(k, bk, s))

    layer = [proj("wq", d, h * hd), proj("wk", d, kh * hd), proj("wv", d, kh * hd),
             proj("wo", h * hd, d), proj("wi", d, f), proj("wg", d, f), proj("wo_ffn", f, d)]
    return layer, proj("lm_head", d, v)


def int8_launch(p: Projection, m: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 launch at M = m rows as launched:
    2·M·kept weights; kept int8 values, fp32 scales and int32 indices, x
    (bf16) read once and y (fp32) written once."""
    ops = 2.0 * m * p.int8_bytes
    nbytes = p.int8_bytes + 8 * p.blocks + 2 * m * p.k + 4 * m * p.n
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def int8_step_bound_s(model: dict, m: int, head: bool = True) -> float:
    """Σ over one forward's int8 launches (every layer's seven, and the LM
    head where ``head``) of each launch's bound at M = m."""
    layer, lm = projections(model)
    per_layer = sum(bound_s(*int8_launch(p, m)) for p in layer)
    return model["num_hidden_layers"] * per_layer + (bound_s(*int8_launch(lm, m)) if head else 0)


def kept_weight_bytes(model: dict, head: bool = True) -> int:
    """Bytes of every kept weight a forward reads once: int8 values, fp32
    scales and int32 indices, all layers (and the LM head)."""
    layer, lm = projections(model)
    per = sum(p.int8_bytes + 8 * p.blocks for p in layer)
    return model["num_hidden_layers"] * per + ((lm.int8_bytes + 8 * lm.blocks) if head else 0)


def kept_params(model: dict, head: bool = True) -> int:
    layer, lm = projections(model)
    return (model["num_hidden_layers"] * sum(p.int8_bytes for p in layer)
            + (lm.int8_bytes if head else 0))


def kv_bytes_per_token(model: dict) -> int:
    """Bytes of one position's keys and values over every layer."""
    return (2 * model["num_hidden_layers"] * model["num_key_value_heads"] * model["head_dim"]
            * KV_BYTES)


def attention_flops(model: dict, ctx: int) -> float:
    """Attention's operations for one query over ``ctx`` positions, every
    layer: q·k and p·v, 2 each per head dim."""
    return (4.0 * model["num_attention_heads"] * model["head_dim"] * ctx
            * model["num_hidden_layers"])


def decode_step(model: dict, contexts: list[int]) -> tuple[float, float]:
    """(operations, bytes) of one decode step's problem: the live rows only,
    each attending its real context (not the cache's length); the weights
    read once; each live context's keys and values read once and the new
    position's written."""
    live = len(contexts)
    ops = 2.0 * live * kept_params(model) + sum(attention_flops(model, c) for c in contexts)
    nbytes = (kept_weight_bytes(model) + kv_bytes_per_token(model) * (sum(contexts) + live)
              + 2 * live * model["hidden_size"])
    return ops, nbytes


def prefill_chunk(model: dict, rows: list[tuple[int, int, bool]]) -> tuple[float, float]:
    """(operations, bytes) of one prefill launch's problem: ``rows`` of
    (start, real tokens, final chunk); each token attends the positions up
    to its own, the prefix's keys and values read once and the chunk's
    written; the LM head runs for a final chunk's last token only."""
    ops = nbytes = 0.0
    trunk = kept_params(model, head=False)
    head = kept_params(model) - trunk
    finals = sum(final for *_, final in rows)
    for start, real, _ in rows:
        ops += 2.0 * real * trunk
        ops += attention_flops(model, real * start + real * (real + 1) // 2)
        nbytes += kv_bytes_per_token(model) * (start + real) + 2 * real * model["hidden_size"]
    ops += 2.0 * finals * head
    nbytes += kept_weight_bytes(model, head=finals > 0)
    return ops, nbytes

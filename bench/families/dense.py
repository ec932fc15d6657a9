"""The dense GQA SwiGLU transformer (Mistral's and InternLM2's layer
equations): the family file of every configuration that names none (the
contract is in ``bench/families/__init__.py``).

Its layer has seven int8 block-sparse projections (q, k, v, o; the gate, up
and down of the SwiGLU), RMS norms with unit scales, rotate-half RoPE and a
bf16 KV cache of ``num_key_value_heads`` heads; the LM head is untied.
"""
from __future__ import annotations

import torch

from bench import roofline as R
from bench import weights as W


def build_arch(model: dict):
    """The port's ``Arch`` for a configuration file: its sizes as the file
    states them."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.registry import Arch

    for key, want in (("hidden_act", "silu"), ("tie_word_embeddings", False),
                      ("rms_norm_eps", 1e-5)):
        if model[key] != want:
            raise SystemExit(f"{model['name']}: {key}={model[key]!r}; the port's dense "
                             f"transformer runs {want!r}")
    cfg = ModelConfig(arch_id=model["port_arch"], family="dense",
                      n_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
                      n_heads=model["num_attention_heads"],
                      n_kv_heads=model["num_key_value_heads"], head_dim=model["head_dim"],
                      d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
                      rope_theta=float(model["rope_theta"]))
    return Arch(arch_id=model["port_arch"], cfg=cfg)


# --- weights -----------------------------------------------------------------

def shapes(model: dict) -> dict[str, tuple[int, int]]:
    """(K, N) of each projection of a layer, by its name in the param tree."""
    d, h, kh = model["hidden_size"], model["num_attention_heads"], model["num_key_value_heads"]
    hd, f = model["head_dim"], model["intermediate_size"]
    return {"attn/wq": (d, h * hd), "attn/wk": (d, kh * hd), "attn/wv": (d, kh * hd),
            "attn/wo": (h * hd, d), "ffn/wi": (d, f), "ffn/wg": (d, f), "ffn/wo": (f, d)}


def projection(model: dict, seed: int, name: str, layer: int, device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 (K, N) projection ``name`` of ``layer`` (−1: the LM head),
    written into ``out`` when given."""
    shape = (model["hidden_size"], model["vocab_size"]) if layer < 0 else shapes(model)[name]
    return W.block_scaled(model, seed, name, layer, shape, device, out)


def param_tree(model: dict, seed: int, device) -> dict:
    """The port's param tree (``models.transformer.init_params``' leaf names,
    stacked (L, …) layer leaves), every weight bf16; the norm scales are
    ones, as ``models.layers.norm_init`` makes them."""
    n_layers, d = model["num_hidden_layers"], model["hidden_size"]
    layers: dict = {"attn": {}, "ffn": {}}
    for name, (k, n) in shapes(model).items():
        block, proj = name.split("/")
        stack = torch.empty((n_layers, k, n), dtype=W.DTYPE, device=device)
        for i in range(n_layers):
            projection(model, seed, name, i, device, out=stack[i])
        layers[block][proj] = {"kernel": stack}
    for norm in ("ln1", "ln2"):
        layers[norm] = {"scale": torch.ones((n_layers, d), dtype=torch.float32, device=device)}
    return {"embed": {"embedding": W.embedding(model, seed, device)}, "layers": layers,
            "final_norm": {"scale": torch.ones((d,), dtype=torch.float32, device=device)},
            "lm_head": {"kernel": projection(model, seed, "lm_head", -1, device)}}


# --- the problem's operations and bytes --------------------------------------

def projections(model: dict) -> tuple[list[R.Projection], R.Projection]:
    """(one layer's seven projections, the LM head), as launched."""
    bk, bn = model["compression"]["block"]
    s = model["compression"]["sparsity"]

    def proj(name, k, n):
        return R.Projection(name, k, n, bk, bn, R.kept_blocks(k, bk, s))

    layer = [proj(name, k, n) for name, (k, n) in shapes(model).items()]
    return layer, proj("lm_head", model["hidden_size"], model["vocab_size"])


def int8_step_bound_s(model: dict, m: int, head: bool = True) -> float:
    """Σ over one forward's int8 launches (every layer's seven, and the LM
    head where ``head``) of each launch's bound at M = m."""
    layer, lm = projections(model)
    per_layer = sum(R.bound_s(*R.int8_launch(p, m)) for p in layer)
    return (model["num_hidden_layers"] * per_layer
            + (R.bound_s(*R.int8_launch(lm, m)) if head else 0))


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
            * R.KV_BYTES)


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

"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]  81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64.

Adaptation notes (DESIGN.md §4): the real model uses two alternating shared
blocks with per-invocation LoRA; we implement one shared (attn + SwiGLU-FFN)
block invoked every 6 Mamba2 layers — the dataflow/roofline-relevant
structure — and note the simplification.  Runs long_500k (sub-quadratic
backbone; the shared-attn KV cache is O(invocations), not O(layers)).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=2,
    shared_attention_every=6,
    max_cache_len=524_288,
)

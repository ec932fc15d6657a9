"""grok-1-314b [moe] — 8 experts top-2.
[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8) d_ff=32768
(per expert) vocab=131072, MoE 8e top-2.

8 experts don't divide the 16-way model axis, so experts are TP-sharded on
d_ff rather than expert-parallel (DESIGN.md §4).  bf16 master params+moments
(314B params make fp32 masters exceed v5e HBM at 256 chips).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    n_experts=8,
    experts_per_token=2,
    param_dtype="bfloat16",
)

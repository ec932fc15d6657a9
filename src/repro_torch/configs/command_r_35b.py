"""command-r-35b [dense] — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]  40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000.

(The released model uses parallel attn+FFN blocks and layernorm; we use the
standard sequential pre-norm block — roofline-equivalent, noted in DESIGN.md.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    vocab_size=256_000,
    norm="layernorm",
    param_dtype="bfloat16",
)

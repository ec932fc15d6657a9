"""mistral-nemo-12b [dense] — 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128 (≠ d_model/n_heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
)

"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.
[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

The vision frontend (ViT) is a STUB per the brief: ``input_specs()`` provides
precomputed patch/text embeddings (B, S, d_model) plus M-RoPE (t, h, w)
position ids (B, 3, S).  mrope_sections (16, 24, 24) sum to head_dim/2.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    pos_enc="mrope",
    mrope_sections=(16, 24, 24),
)

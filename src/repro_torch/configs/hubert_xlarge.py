"""hubert-xlarge [audio] — encoder-only, same arch as wav2vec2.
[arXiv:2106.07447; unverified]  48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 (masked-prediction codebook targets).

The conv waveform frontend is a STUB: ``input_specs()`` feeds precomputed
frame embeddings (B, S, d_model).  No decode step exists (encoder-only);
decode_32k / long_500k are skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pos_enc="none",  # w2v2 conv-relpos frontend is part of the stub
    norm="layernorm",
    ffn="gelu_mlp",
    use_bias=True,
    encoder_only=True,
)

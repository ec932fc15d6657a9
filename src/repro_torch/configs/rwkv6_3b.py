"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536,
head_size=64 ⇒ 40 WKV heads.  O(1)-in-seq recurrent state ⇒ runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # = d_model / rwkv_head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    pos_enc="none",
    rwkv_head_size=64,
    ffn="gelu_mlp",  # rwkv channel-mix is a squared-relu 2-layer MLP (see models/rwkv6.py)
    max_cache_len=524_288,
)

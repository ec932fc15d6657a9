"""Config system: one frozen dataclass describes every supported architecture.

The port's own copy of ``repro.configs.base``, field for field.
``get_config(arch_id)`` pulls the full (published) config from
``repro_torch.configs.<arch>``; ``reduced_config`` shrinks any config for
CPU tests (same family/topology, tiny dims).  ``SHAPES`` are the
reference's assigned cells, which ``models.registry.Arch.supports`` rules
on.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encoder", "vlm"]
PosEnc = Literal["rope", "mrope", "none"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: Family

    # trunk
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # flavour
    pos_enc: PosEnc = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # qwen2-vl (t, h, w)
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    ffn: Literal["swiglu", "gelu_mlp"] = "swiglu"
    use_bias: bool = False
    encoder_only: bool = False
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0  # 0 ⇒ dense FFN
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    shared_attention_every: int = 0  # zamba2: shared attn block every k ssm layers

    # RWKV6
    rwkv_head_size: int = 0  # >0 ⇒ rwkv6 time-mix replaces attention
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # numerics
    param_dtype: str = "float32"  # training master dtype
    compute_dtype: str = "bfloat16"

    # lowering strategy (the reference's; the port walks the layers in a
    # Python loop whatever they say)
    unroll_layers: bool = False
    remat_policy: str = "nothing"  # "nothing" (recompute all) | "dots" (save matmuls)

    # serving
    max_cache_len: int = 32_768

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size if self.rwkv_head_size else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape.  ``kind`` picks which step fn is lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ALL_ARCH_IDS: tuple[str, ...] = (
    "hubert-xlarge",
    "zamba2-7b",
    "moonshot-v1-16b-a3b",
    "grok-1-314b",
    "command-r-35b",
    "mistral-nemo-12b",
    "tinyllama-1.1b",
    "internlm2-1.8b",
    "qwen2-vl-2b",
    "rwkv6-3b",
)

_MODULE_FOR: dict[str, str] = {
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok_1_314b",
    "command-r-35b": "command_r_35b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU tests (small layers/width, few
    experts, tiny embedding tables), the reference's."""
    cfg = get_config(arch_id)
    kw: dict = dict(
        n_layers=max(2, min(cfg.n_layers, 2)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_cache_len=128,
    )
    if cfg.n_experts:
        # ample capacity: smoke tests must be drop-free so prefill+decode
        # continuity is exact (dropping is sequence-length-dependent)
        kw.update(n_experts=4, experts_per_token=2, moe_capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if cfg.shared_attention_every:
            kw.update(n_layers=4, shared_attention_every=2)
    if cfg.rwkv_head_size:
        kw.update(rwkv_head_size=16, rwkv_lora_decay=8, rwkv_lora_mix=4)
    if cfg.mrope_sections != (16, 24, 24) or cfg.pos_enc == "mrope":
        kw.update(mrope_sections=(4, 2, 2))  # sums to head_dim/2 = 8
    return cfg.replace(**kw)

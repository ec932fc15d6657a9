"""Model configuration: one frozen dataclass per architecture.

The port's own copy of ``repro.configs.base``, cut to the fields the ported
decoder path reads.  ``get_config(arch_id)`` returns the full published
config; ``reduced_config`` shrinks it for CPU tests (same topology, tiny
dims).  Only ``tinyllama-1.1b`` is ported so far.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: str

    # trunk (rmsnorm, rope, swiglu, no biases, untied LM head)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_MODULE_FOR: dict[str, str] = {
    "tinyllama-1.1b": "tinyllama_1_1b",
}

ALL_ARCH_IDS: tuple[str, ...] = tuple(_MODULE_FOR)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU tests: the widths of the reference's
    ``reduced_config`` for a dense GQA decoder."""
    cfg = get_config(arch_id)
    return cfg.replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )

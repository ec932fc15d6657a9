"""Arch registry: maps a ported ``--arch`` id to its config and model module.

A minimal counterpart of ``repro.models.registry``: the dense decoder
(``models.transformer``) is the only ported family.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, get_config, reduced_config
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    cfg: ModelConfig

    def init_params(self, gen: torch.Generator, device):
        return transformer.init_params(self.cfg, gen, device)

    def forward(self, params, **kw):
        return transformer.forward(params, self.cfg, **kw)

    def init_cache(self, batch: int, max_len: int, device):
        return transformer.init_cache(self.cfg, batch, max_len, device)


def get_arch(arch_id: str, reduced: bool = False) -> Arch:
    cfg = reduced_config(arch_id) if reduced else get_config(arch_id)
    return Arch(arch_id=arch_id, cfg=cfg)

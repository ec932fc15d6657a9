"""AdamW with sparsity-mask support and optional bf16 moments.

The port of ``repro.train.optimizer``.  Masked updates implement §III.A's
"masks decide which weights participate in the forward execution of the
graph": gradients of masked weights are zeroed, and weights are re-masked
after the update, so pruned entries stay exactly 0 through training.
Gradients are clipped by their global norm; the decay is decoupled and
applies to leaves of rank ≥ 2 only.  That includes the stacked (L, d) norm
scales, which stacking makes 2-D: the reference decays them, and so does
the port.  ``moment_dtype="bfloat16"`` halves the optimizer's memory.

Every update is computed in fp32 and cast back to each leaf's type; the
step, learning rate and norms stay tensors on the params' device (no host
sync).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.tree import named_leaves, tree_map, tree_map_with_path_names


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    warmup_steps: int = 100


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``; fp32 0-dim."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def adamw_init(params: Any, cfg: AdamWConfig) -> dict[str, Any]:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for _, x in named_leaves(tree)))


def adamw_update(
    params: Any,
    grads: Any,
    opt_state: dict[str, Any],
    step: torch.Tensor,
    cfg: AdamWConfig,
    masks: Any | None = None,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, opt_state, metrics), all new
    tensors (the inputs are not written)."""
    if masks is not None:
        grads = tree_map(lambda g, m: g * m.to(g.dtype), grads, masks)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)

    def upd(p, g, m, v, mask=None):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices (and stacks) only
            update = update + cfg.weight_decay * p.float()
        p_new = p.float() - lr * update
        if mask is not None:
            p_new = p_new * mask.float()
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    g, m, v = (dict(named_leaves(tree)) for tree in (grads, opt_state["m"], opt_state["v"]))
    mk = dict(named_leaves(masks)) if masks is not None else {}
    new = {name: upd(p, g[name], m[name], v[name], mk.get(name))
           for name, p in named_leaves(params)}

    def pick(i):
        return tree_map_with_path_names(lambda name, _: new[name][i], params)

    return pick(0), {"m": pick(1), "v": pick(2)}, {"grad_norm": gnorm, "lr": lr}

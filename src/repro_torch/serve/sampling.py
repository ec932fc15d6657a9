"""Token sampling: greedy, or temperature sampling from a torch.Generator."""
from __future__ import annotations

import torch


def sample_token(
    logits: torch.Tensor,  # (B, V)
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """→ (B,) int64 next tokens.  ``temperature <= 0`` is greedy (argmax,
    first index on ties, as in the reference); otherwise one categorical
    draw per row from softmax(logits / temperature) using ``generator``,
    which must live on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

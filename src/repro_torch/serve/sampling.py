"""Token sampling: greedy, temperature, top-k and top-p (nucleus), plus the
greedy speculative-acceptance rule (``spec_accept``).

The port of ``repro.serve.sampling``.  Every path is tensor ops with no
read back to the host, so the sampler runs inside a captured decode step
(``serve.engine``).  The draw uses the caller's ``torch.Generator`` where
the reference splits a JAX key: the filtered logits and the greedy path are
the reference's, a draw is not.
"""
from __future__ import annotations

import torch


def filter_logits(
    logits: torch.Tensor,  # (B, V)
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """fp32 logits / temperature, with everything below the k-th largest
    (``top_k`` > 0) and everything outside the nucleus (0 < ``top_p`` < 1:
    the smallest logit-sorted prefix whose mass reaches ``top_p``; the first
    column is always kept) set to −inf, as the reference filters them."""
    lf = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, -torch.inf, lf)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(lf, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        exclusive_mass = torch.cumsum(probs, dim=-1) - probs
        kept = exclusive_mass < top_p
        thresh = torch.where(kept, srt, torch.inf).amin(-1, keepdim=True)
        lf = torch.where(lf < thresh, -torch.inf, lf)
    return lf


def sample_token(
    logits: torch.Tensor,  # (B, V)
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """→ (B,) int64 next tokens.  ``temperature <= 0`` is greedy (argmax,
    first index on ties, as in the reference); otherwise one categorical
    draw per row from softmax of ``filter_logits`` using ``generator``,
    which must live on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def spec_accept(
    window: torch.Tensor,  # (B, K+1) — [cur_tok, d_1 .. d_K] fed to verify
    verify: torch.Tensor,  # (B, K+1) — greedy verifier token per window row
    live: torch.Tensor,  # (B,) bool — slot is active and not done
    pos: torch.Tensor,  # (B,) — cache position of cur_tok (window row 0)
    limit: torch.Tensor,  # (B,) — last write position (token budget edge)
    eos_token: int,  # < 0 ⇒ never stop on eos
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy longest-matching-prefix acceptance for speculative decoding,
    the reference's integer rule: token i of the verify window may be
    emitted iff every earlier emission matched the draft fed after it, was
    not eos, and left budget (``pos + i < limit``); a live slot always
    emits row 0.  The emitted sequence is what K+1 sequential greedy steps
    give.

    Returns ``(emitted, n_emit, last)``: ``emitted`` (B, K+1) the verify
    tokens with the others set to −1, ``n_emit`` (B,) the count (0 where
    not live) and ``last`` (B,) the last emitted token (undefined where
    ``n_emit == 0``)."""
    kp1 = window.shape[1]
    steps = torch.arange(1, kp1, dtype=pos.dtype, device=pos.device)  # 1..K
    cont = window[:, 1:] == verify[:, :-1]  # (a) draft matched
    if eos_token >= 0:
        cont = cont & (verify[:, :-1] != eos_token)  # (b) no eos before it
    cont = cont & (pos[:, None] + steps[None, :] < limit[:, None])  # (c) budget left
    prefix = torch.cumprod(cont.to(torch.int32), dim=1).bool()
    emit = torch.cat([live[:, None], live[:, None] & prefix], dim=1)
    n_emit = emit.sum(dim=1).to(pos.dtype)
    emitted = torch.where(emit, verify, torch.full_like(verify, -1))
    last_idx = torch.clamp(n_emit - 1, 0, kp1 - 1).long()
    last = torch.gather(verify, 1, last_idx[:, None])[:, 0]
    return emitted, n_emit, last

"""Batched serving engine: generation with per-sequence stopping over
SONIC int8 block-sparse weights.

The port of ``repro.serve.engine`` for ``ServeEngine.generate``.  PyTorch
runs eagerly, so prefill and each decode step are plain ``forward`` calls;
no step reads a value back to the host, so the card runs ahead of Python.
The KV cache is updated in place.

Under ``ServeConfig(weight_quant="int8")`` every linear projection (q, k,
v, o, wi, wg, wo and the LM head) is rewritten once, at construction, into
int8 block-sparse form (``core.sonic_layers.quantize_serve_params``), on the
engine's device.  The model then runs every projection through the
hand-written kernels: the tiled matmul for prefill rows, the matvec for
decode rows.

Semantics (as in the reference): the first token is sampled from the
prefill logits and is never eos-pinned; every subsequent token is
eos-checked, and once a sequence has emitted ``eos_token`` all its later
tokens are pinned to ``eos_token``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sonic_layers import quantize_serve_params
from repro_torch.models.registry import Arch
from repro_torch.serve.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0
    eos_token: int = -1  # -1 ⇒ never stop early
    # "int8" rewrites every linear projection into int8 block-sparse form;
    # ``weight_quant_sparsity`` > 0 also block-prunes (balanced top-|L1|,
    # the SONIC C1 structure); block=None picks the largest power-of-two
    # block (≤ 128) dividing each dim.
    weight_quant: str = "none"  # "none" | "int8"
    weight_quant_sparsity: float = 0.0
    weight_quant_block: tuple[int, int] | None = None


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    def __init__(self, arch: Arch, params: dict, sc: ServeConfig, device="cuda"):
        if sc.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant must be 'none' or 'int8', got {sc.weight_quant!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to serve "
                               "on the CPU")
        params = _to_device(params, self.device)
        if sc.weight_quant == "int8":
            params = quantize_serve_params(params, sparsity=sc.weight_quant_sparsity,
                                           block=sc.weight_quant_block)
        self.arch, self.params, self.sc, self.cfg = arch, params, sc, arch.cfg
        self.call_counts: dict[str, int] = {"prefill": 0, "decode": 0}

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, n_new: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts (B, S_prompt) int → (B, n_new) generated tokens (int64).

        ``generator`` (on the engine's device) drives temperature sampling;
        greedy decoding ignores it."""
        sc = self.sc
        b, s_prompt = prompts.shape
        if n_new < 1 or s_prompt + n_new > sc.max_len:
            raise ValueError(f"prompt {s_prompt} + {n_new} new tokens must fit "
                             f"max_len {sc.max_len}")
        prompts = prompts.to(self.device)
        cache = self.arch.init_cache(b, sc.max_len, self.device)
        logits, cache = self.arch.forward(self.params, tokens=prompts, cache=cache)
        self.call_counts["prefill"] += 1
        tok = sample_token(logits[:, -1], sc.temperature, generator)
        pos = torch.full((b,), s_prompt, dtype=torch.long, device=self.device)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        out = [tok]
        for _ in range(n_new - 1):
            logits, cache = self.arch.forward(self.params, tokens=tok[:, None],
                                              cache=cache, cache_pos=pos)
            self.call_counts["decode"] += 1
            tok = sample_token(logits[:, 0], sc.temperature, generator)
            if sc.eos_token >= 0:
                done = done | (tok == sc.eos_token)
                tok = torch.where(done, sc.eos_token, tok)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1)

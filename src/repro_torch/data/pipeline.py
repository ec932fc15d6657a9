"""Deterministic, step-indexed synthetic data pipeline.

The port of ``repro.data.pipeline``.  Every batch is a pure function of
(seed, step): a restarted job replays the exact token stream from its
checkpointed step with no data-loader state to persist.

The "language" is a Zipf-like token stream with a deterministic next-token
structure (t_{i+1} = perm[t_i] with probability ``structure``, else uniform
noise), so cross-entropy has learnable signal and the training loss drops
within a few hundred steps.

The contract is the reference's; the random bits are not.  The
permutation is ``np.random.RandomState(seed).permutation(V)``, bit for bit
the reference's; the first token follows the logits −log1p(arange V); each
next token follows the permutation with probability ``structure`` and is
otherwise uniform; labels are the tokens shifted left, ending in −1.  The
draws come from a ``torch.Generator`` seeded from (seed, step) where the
reference uses ``jax.random``'s threefry, so the two packages' streams
differ token for token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose state is a function of (seed, step) only."""
    entropy = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(entropy))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.7  # P(next token follows the permutation rule)

    def _perm(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.permutation(self.vocab_size)

    def batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """{"tokens", "labels"}: (global_batch, seq_len) int64, on ``device``
        (the CPU by default); drawn on the CPU, so every device gets the
        same batch."""
        g = step_generator(self.seed, step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        zipf = torch.softmax(-torch.log1p(torch.arange(v, dtype=torch.float32)), dim=0)
        first = torch.multinomial(zipf.expand(b, v), 1, generator=g)[:, 0].numpy()
        noise = torch.randint(0, v, (b, s), generator=g).numpy()
        follow = (torch.rand((b, s), generator=g) < self.structure).numpy()
        perm = self._perm()
        tokens = np.empty((b, s), np.int64)
        tok = first
        for t in range(s):
            tok = np.where(follow[:, t], perm[tok], noise[:, t])
            tokens[:, t] = tok
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int64)], axis=1)
        return {"tokens": torch.from_numpy(tokens).to(device),
                "labels": torch.from_numpy(labels).to(device)}


def make_batch_fn(vocab_size: int, seq_len: int, global_batch: int, seed: int = 0,
                  device=None):
    """step → batch on ``device``."""
    ds = SyntheticLM(vocab_size, seq_len, global_batch, seed)
    return lambda step: ds.batch(step, device)

"""Teacher-labelled synthetic classification tasks.

The port of ``repro.data.teacher``.  A frozen random "teacher" CNN (a small
one of the student's input and output shape: at most 16 channels, the
first two conv stages, no hidden FC) labels random inputs; the student CNN
(the paper's architecture, ``models.cnn``) is trained, sparsified and
clustered against those labels, and accuracy *retention* is measured.

The teacher's weights come from ``seed`` through a ``torch.Generator``, or
are given (``teacher_params``, e.g. the reference's carried across with
``convert.params_from_jax``); a task's inputs at each step come from a
generator seeded from (seed + 1, step).  The reference draws both with
``jax.random``, so the two packages' tasks differ unless the teacher is
carried across and the inputs are shared.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.data.pipeline import step_generator
from repro_torch.models import cnn as cnn_lib


@dataclasses.dataclass
class TeacherTask:
    cfg: cnn_lib.CNNConfig
    seed: int = 42
    device: Any = "cpu"
    teacher_params: Any = None

    def __post_init__(self):
        self.teacher_cfg = dataclasses.replace(
            self.cfg,
            conv_channels=tuple(min(c, 16) for c in self.cfg.conv_channels[:2]),
            pool_after=tuple(p for p in self.cfg.pool_after if p < 2),
            fc_dims=(),
        )
        if self.teacher_params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.teacher_params = cnn_lib.init_params(self.teacher_cfg, gen)

    def labels(self, x: torch.Tensor) -> torch.Tensor:
        """The teacher's class for each input of x (B, H, W, C)."""
        return torch.argmax(cnn_lib.forward(self.teacher_params, self.teacher_cfg, x), -1)

    def batch(self, step: int, batch_size: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.randn((batch_size, *self.cfg.input_hw),
                        generator=step_generator(self.seed + 1, step)).to(self.device)
        return x, self.labels(x)

    def accuracy(self, params, n_batches: int = 8, batch_size: int = 128) -> float:
        correct = total = 0
        for i in range(n_batches):
            x, y = self.batch(10_000 + i, batch_size)
            pred = torch.argmax(cnn_lib.forward(params, self.cfg, x), -1)
            correct += int((pred == y).sum())
            total += batch_size
        return correct / total

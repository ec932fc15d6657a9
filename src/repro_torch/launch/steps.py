"""Step-function builders shared by the dry run and the launchers.

The port of ``repro.launch.steps``.  For every (arch × shape) cell this
module produces:
  * the step callable (train_step / prefill_step / decode_step),
  * its abstract inputs: a ``make_args`` that builds them, each a DTensor
    of each device's shard in its layout (under ``FakeTensorMode``: no
    data),
so running ``fn(*make_args())`` under a fake group is the whole dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models.registry import Arch, input_specs
from repro_torch.sharding.mesh import MeshPlan
from repro_torch.sharding.partition import sharded_abstract_params
from repro_torch.train.loop import TrainConfig, build_train_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import TrainState, abstract_train_state
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class StepBundle:
    name: str
    fn: Callable
    make_args: Callable[[], tuple]  # the positional abstract inputs
    donate_argnums: tuple[int, ...]


def _attach_state_shardings(abstract_state: TrainState, plan: MeshPlan) -> TrainState:
    """Params / moments / masks share the FSDP×TP spec; step is replicated
    (a plain tensor, the same on every rank)."""
    params = sharded_abstract_params(abstract_state.params, plan)
    m = sharded_abstract_params(abstract_state.opt_state["m"], plan)
    v = sharded_abstract_params(abstract_state.opt_state["v"], plan)
    masks = (
        sharded_abstract_params(abstract_state.masks, plan)
        if abstract_state.masks is not None
        else None
    )
    step = torch.zeros((), dtype=torch.int32)
    return TrainState(params=params, opt_state={"m": m, "v": v}, masks=masks, step=step)


def default_train_config(cfg: ModelConfig, paper_faithful: bool = True) -> TrainConfig:
    """Paper-faithful: sparsity-aware training ON (C1) with 128 × 128 blocks."""
    sparsity = (
        SparsityConfig(target_sparsity=0.75, block=(128, 128),
                       ramp_start_step=0, ramp_end_step=10_000)
        if paper_faithful
        else None
    )
    # microbatching bounds token-proportional transients (MoE dispatch
    # buffers, CE logits) for the big models
    n_total = _rough_param_count(cfg)
    grad_accum = 4 if n_total > 100e9 else (2 if n_total > 10e9 else 1)
    return TrainConfig(
        opt=AdamWConfig(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
                        else "float32"),
        sparsity=sparsity,
        mask_update_every=100,
        l2_coeff=1e-6 if paper_faithful else 0.0,
        grad_accum=grad_accum,
        remat=True,
    )


def _rough_param_count(cfg: ModelConfig) -> float:
    from repro_torch.roofline.analytic import _param_counts

    return _param_counts(cfg)[1]


def build_step_bundle(
    arch: Arch,
    shape: ShapeSpec,
    plan: MeshPlan,
    cfg: ModelConfig | None = None,
    train_cfg: TrainConfig | None = None,
) -> StepBundle:
    cfg = cfg or arch.cfg
    specs = input_specs(arch, shape, plan, cfg)

    def inputs(sp: dict) -> dict:
        return {k: v.empty() for k, v in sp.items()}

    if shape.kind == "train":
        tc = train_cfg or default_train_config(cfg)
        step = build_train_step(arch, tc, cfg, plan=plan)

        def train_step(state, batch):
            return step(state, batch, 0)

        def make_args():
            state = abstract_train_state(arch.abstract_params(cfg), tc.opt,
                                         with_masks=tc.sparsity is not None)
            return _attach_state_shardings(state, plan), inputs(specs)

        return StepBundle("train_step", train_step, make_args, donate_argnums=(0,))

    serve = plan.serve_stationary  # TP-only weights for inference

    def serve_params():
        return sharded_abstract_params(arch.abstract_params(cfg), plan, serve=serve)

    if shape.kind == "prefill":

        def prefill_step(params, batch):
            if cfg.encoder_only:  # encoders have no decode → no cache output
                logits, _ = arch.forward(params, cfg, plan=plan, **batch)
                return logits, None
            cache = arch.init_cache(shape.global_batch, shape.seq_len, None, cfg, plan=plan)
            logits, cache = arch.forward(params, cfg, plan=plan, cache=cache, **batch)
            return logits[:, -1], cache

        return StepBundle("prefill_step", prefill_step,
                          lambda: (serve_params(), inputs(specs)), ())

    # decode
    def decode_step(params, cache, batch, pos):
        kw = dict(batch)
        if arch.input_kind == "tokens":
            kw = {"tokens": kw.pop("token")}
        else:
            kw["embeds"] = kw.pop("token")
        logits, cache = arch.forward(params, cfg, plan=plan, cache=cache, cache_pos=pos, **kw)
        return logits[:, 0], cache

    cache_specs = specs.pop("cache")
    pos_spec = specs.pop("pos")

    def make_decode_args():
        cache = tree_map(lambda t: t.empty(), cache_specs)
        return serve_params(), cache, inputs(specs), pos_spec.empty()

    return StepBundle("decode_step", decode_step, make_decode_args, donate_argnums=(1,))

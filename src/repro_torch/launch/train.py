"""Training launcher: sparsity-aware training of any ``--arch``.

The port of ``repro.launch.train``.  Fault-tolerant by construction: it
resumes from the latest checkpoint under ``--ckpt-dir`` unless
``--no-resume``, checkpoints every ``--ckpt-every`` steps, at the end and on
SIGTERM, and the data pipeline is step-indexed, so a restart replays the
exact stream.  Weights are random, made from ``--seed`` on the device;
tokens come from ``data.pipeline.SyntheticLM`` (seed ``--seed``), and the
stubbed frontends (hubert, qwen2-vl) get bf16 embeddings from a generator
seeded from (7, step).  Sparsity (``--sparsity``, unless ``--no-sparsity``)
ramps on the cubic schedule over the first half of ``--steps``, with (8, 8)
blocks at ``--reduced`` and (128, 128) at published width, the masks
refreshed every ``--mask-update-every`` steps; L2 1e-6, remat on, warmup
over a twentieth of the steps, as the reference's launcher.
``--compressed-accum`` accumulates the ``--grad-accum`` microbatches'
gradients through the int8 accumulator.

``--device`` (default ``cuda``) picks the device: without a card it exits
unless ``--device cpu`` is given.  ``--mesh debug`` is the reference's
sharded run: under ``torchrun`` with 8 ranks (``gloo`` with ``--device
cpu``, ``nccl`` on 8 cards) it trains on ``make_debug_mesh()`` (data 2 ×
model 4) with ``make_plan(cfg, mesh, --batch)``: the state's leaves are
DTensors in ``sharding.partition``'s layouts, every rank makes the same
weights and the same batch and keeps its shard, rank 0 logs and writes the
checkpoints.  With another number of ranks it exits naming the 8 it needs.

Usage, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 20 --batch 2 --seq 4096 --grad-accum 2 --compressed-accum
On the CPU, at test size:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 4 --ckpt-dir /tmp/run1
Sharded, on the CPU:
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --mesh debug --reduced --device cpu --steps 4 --batch 8
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ALL_ARCH_IDS
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import make_batch_fn, step_generator
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.registry import Arch, get_arch
from repro_torch.sharding.mesh import MeshPlan, make_plan
from repro_torch.sharding.partition import shard_params
from repro_torch.train.loop import TrainConfig, build_train_step, train_loop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import TrainState, init_train_state
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")

DEBUG_RANKS = 8  # make_debug_mesh(): data 2 × model 4


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--no-sparsity", action="store_true")
    ap.add_argument("--mask-update-every", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compressed-accum", action="store_true",
                    help="accumulate microbatch gradients through the int8 accumulator")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "debug"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.batch < 1 or args.seq < 2 or args.grad_accum < 1:
        ap.error("--steps, --batch and --grad-accum must be >= 1 and --seq >= 2")
    if args.batch % args.grad_accum:
        ap.error("--batch must be a multiple of --grad-accum")
    if args.mask_update_every < 1:
        ap.error("--mask-update-every must be >= 1")
    return args


@dataclasses.dataclass
class Trainer:
    """What ``main`` runs: the train step, the state to start from, the
    step-indexed data and the checkpointer (None without ``--ckpt-dir``)."""
    arch: Arch
    tc: TrainConfig
    state: TrainState
    step: Callable[[TrainState, dict], tuple[TrainState, dict]]
    data: Callable[[int], dict[str, torch.Tensor]]
    checkpointer: Checkpointer | None
    plan: MeshPlan = MeshPlan()


def train_config(args: argparse.Namespace) -> TrainConfig:
    sparsity = None
    if not args.no_sparsity:
        sparsity = SparsityConfig(
            target_sparsity=args.sparsity,
            block=(8, 8) if args.reduced else (128, 128),
            ramp_start_step=0,
            ramp_end_step=max(args.steps // 2, 1),
        )
    return TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1)),
        sparsity=sparsity,
        mask_update_every=args.mask_update_every,
        l2_coeff=1e-6,
        grad_accum=args.grad_accum,
        remat=True,
        compressed_accum=args.compressed_accum,
    )


def build_trainer(args: argparse.Namespace, arch: Arch | None = None) -> Trainer:
    """Random weights from ``args.seed`` on the device, the train state (or
    the latest checkpoint's, unless ``--no-resume``), the step and the data;
    ``arch`` trains another model in place of ``--arch`` (one cut in depth).
    Autograd must be free to record (not under ``torch.inference_mode``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to train on the CPU")
    arch = arch or get_arch(args.arch, reduced=args.reduced)
    plan = MeshPlan()
    if args.mesh == "debug":
        plan = make_plan(arch.cfg, _debug_mesh(device), args.batch)
    tc = train_config(args)
    params = arch.init_params(torch.Generator(device=device).manual_seed(args.seed), device)
    state = init_train_state(params, tc.opt, tc.sparsity)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck is not None and not args.no_resume and ck.latest_step() is not None:
        state = ck.restore(state)
        log.info("resumed from step %d", int(state.step))
    if plan.mesh is not None:  # every rank made the same state: each keeps its shard
        state = TrainState(shard_params(state.params, plan),
                           {k: shard_params(v, plan) for k, v in state.opt_state.items()},
                           None if state.masks is None else shard_params(state.masks, plan),
                           state.step)
    batch_fn = make_batch_fn(arch.cfg.vocab_size, args.seq, args.batch, args.seed, device)

    def data(i: int) -> dict[str, torch.Tensor]:
        b = batch_fn(i)
        if arch.input_kind == "tokens":
            out = b
        else:
            emb = torch.randn((args.batch, args.seq, arch.cfg.d_model),
                              generator=step_generator(7, i)).to(device, torch.bfloat16)
            out = {"embeds": emb, "labels": b["labels"]}
            if arch.input_kind == "embeds+mrope":
                out["positions"] = torch.arange(args.seq, device=device).expand(
                    args.batch, 3, args.seq)
        return {k: plan.shard(v, plan.dp, *([None] * (v.dim() - 1))) for k, v in out.items()}

    return Trainer(arch, tc, state, build_train_step(arch, tc, plan=plan), data, ck, plan)


def _debug_mesh(device: torch.device):
    """The debug mesh over the group ``torchrun`` describes (gloo on the
    CPU, NCCL on cards); exits naming the ranks it needs."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != DEBUG_RANKS:
        raise SystemExit(f"--mesh debug needs {DEBUG_RANKS} ranks for its sharding mesh "
                         f"(torchrun --nproc-per-node {DEBUG_RANKS}); this run has {world}")
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DEBUG_RANKS))
    return make_debug_mesh(device_type=device.type)


def main(argv: list[str] | None = None) -> TrainState:
    args = parse_args(argv)
    run = build_trainer(args)

    lead = run.plan.mesh is None or dist.get_rank() == 0

    def on_metrics(i: int, m: dict[str, Any]) -> None:
        if lead and (i % 10 == 0 or i == args.steps - 1):
            log.info("step %d loss %.4f gnorm %.3f lr %.2e", i, m["loss"], m["grad_norm"],
                     m["lr"])

    state = train_loop(run.step, run.state, run.data, args.steps, run.checkpointer,
                       args.ckpt_every, on_metrics)
    if lead:
        log.info("done at step %d", int(state.step))
    if run.plan.mesh is not None:
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()

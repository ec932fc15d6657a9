"""Sparsity-aware training of a small LM through the PyTorch port, with
gradual magnitude pruning (Zhu & Gupta ramp), L2 regularization,
checkpoint / restart and a simulated preemption at the halfway point.

The port of ``examples/sparse_training.py``: the same ~40M-parameter demo
model (``--full``: the 110M configuration), the same schedule and the same
check that the loss falls.  Runs on the card by default; ``--device cpu``
runs it on the CPU.

Run:  PYTHONPATH=src python examples/sparse_training_torch.py [--steps N] [--full]
          [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.sparsity import SparsityConfig, sparsity_of  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402
from repro_torch.train.loop import TrainConfig, build_train_step, train_loop  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_state import init_train_state  # noqa: E402
from repro_torch.utils.tree import tree_param_count  # noqa: E402


def make_model(full: bool) -> Arch:
    cfg = ModelConfig(
        arch_id="demo-lm",
        family="dense",
        n_layers=12 if full else 4,
        d_model=768 if full else 256,
        n_heads=12 if full else 4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=3072 if full else 768,
        vocab_size=8192 if full else 4096,
    )
    return Arch(arch_id=cfg.arch_id, cfg=cfg)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu")

    arch = make_model(args.full)
    tc = TrainConfig(
        opt=AdamWConfig(lr=3e-3, warmup_steps=20),
        sparsity=SparsityConfig(
            target_sparsity=args.sparsity, block=(64, 64),
            ramp_start_step=10, ramp_end_step=args.steps // 2,
        ),
        mask_update_every=10,
        l2_coeff=1e-6,
        remat=True,
    )
    params = arch.init_params(torch.Generator(device=device).manual_seed(0), device)
    print(f"model: {tree_param_count(params):,} params on {device}")
    state = init_train_state(params, tc.opt, tc.sparsity)
    step = build_train_step(arch, tc)
    data = make_batch_fn(arch.cfg.vocab_size, args.seq, args.batch, seed=11, device=device)

    losses = []

    def on_metrics(i, m):
        losses.append(m["loss"])
        if i % 20 == 0:
            print(f"step {i:4d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f}")

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        half = args.steps // 2
        # phase 1: train to the halfway point, then "lose the job"
        state = train_loop(step, state, data, half, ck, checkpoint_every=25,
                           on_metrics=on_metrics)
        print(f"-- simulated preemption at step {int(state.step)}; restoring --")
        # phase 2: a fresh state restores and continues (the data replays
        # deterministically from the checkpointed step)
        fresh = init_train_state(arch.init_params(
            torch.Generator(device=device).manual_seed(1), device), tc.opt, tc.sparsity)
        state = train_loop(step, ck.restore(fresh), data, args.steps, ck,
                           checkpoint_every=25, on_metrics=on_metrics)

    w = state.params["layers"]["ffn"]["wi"]["kernel"][0]
    print(f"\nfinal: loss {np.mean(losses[-10:]):.4f} "
          f"(from {np.mean(losses[:10]):.4f}); ffn sparsity {sparsity_of(w):.2f} "
          f"(target {args.sparsity})")
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    print("sparse training e2e: OK")


if __name__ == "__main__":
    main()

"""Serving launcher: one fixed batch through ``ServeEngine.generate``.

Weights are random, made from ``--seed`` on the device; prompts from
``--seed + 1``.  Prints tok/s and the first two token rows.

Usage, on the card (the CUDA kernels build into ``build/`` at first use,
before the timed run):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --weight-quant int8 --weight-quant-sparsity 0.5 \
        --batch 4 --prompt-len 64 --new-tokens 32
On the CPU, at test size (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --weight-quant int8 --weight-quant-sparsity 0.5
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ALL_ARCH_IDS
from repro_torch.kernels import build
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-token", type=int, default=-1)
    ap.add_argument("--weight-quant", default="none", choices=("none", "int8"),
                    help="serve int8 block-sparse weights through the "
                         "hand-written kernels")
    ap.add_argument("--weight-quant-sparsity", type=float, default=0.0,
                    help="block-prune the served weights to this sparsity "
                         "before int8 quantization (requires --weight-quant int8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--batch, --prompt-len and --new-tokens must be >= 1")
    if args.weight_quant_sparsity and args.weight_quant != "int8":
        ap.error("--weight-quant-sparsity requires --weight-quant int8")
    if not 0.0 <= args.weight_quant_sparsity < 1.0:
        ap.error("--weight-quant-sparsity must be in [0, 1)")
    return args


def build_engine(args: argparse.Namespace) -> ServeEngine:
    """Random weights from ``args.seed`` made on the device, quantized there
    by the engine; on the card the kernels are built here too, as set-up."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu to run "
                             "on the CPU")
        build.load_library()
    arch = get_arch(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = arch.init_params(gen, device)
    sc = ServeConfig(
        max_len=args.prompt_len + args.new_tokens + 1,
        temperature=args.temperature,
        eos_token=args.eos_token,
        weight_quant=args.weight_quant,
        weight_quant_sparsity=args.weight_quant_sparsity,
    )
    return ServeEngine(arch, params, sc, device=device)


def make_prompts(args: argparse.Namespace, vocab_size: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(args.seed + 1)
    return torch.randint(0, vocab_size, (args.batch, args.prompt_len), generator=gen)


def run_batch(eng: ServeEngine, args: argparse.Namespace) -> torch.Tensor:
    """Generate once and report; returns the (batch, new_tokens) tokens."""
    prompts = make_prompts(args, eng.cfg.vocab_size)
    gen = torch.Generator(device=eng.device).manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.new_tokens, gen)
    out = out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "cpu")
    log.info("generated %s tokens in %.3fs (%.1f tok/s) on %s", tuple(out.shape), dt,
             args.batch * args.new_tokens / dt, where)
    print(out[:2].numpy())
    return out


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    run_batch(build_engine(args), args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero before the last line:
  1. device: a CUDA card (else exit 1), its name and power limit as
     nvidia-smi gives them; TF32 off for matmuls and cuDNN.
  2. build: the CUDA kernels from src/repro_torch/csrc into build/, timed,
     with ptxas's register / spill summary.
  3. kernels vs plain versions: each kernel against its plain PyTorch
     version at the main path's projection shapes (128×128 blocks,
     sparsity 0.5) and at small blocks, fp32 and bf16 x, fp32 outputs held
     to rtol = atol = 1e-4 (the sums run in another order over up to 5632
     terms); an all-zero weight must give exact zeros.
  4. main path: tinyllama-1.1b at full width, random weights from a seeded
     generator on the card, quantized there to int8 block-sparse
     (sparsity 0.5), greedy batch 4 × prompt 64 × 32 new tokens through
     ``repro_torch.launch.serve``.  The launch counters are zeroed just
     before and read just after; tokens must be in range and repeat on a
     second run.  Then prefill ms, decode ms/token and tok/s (host clock,
     medians of 7), and the card's busy time while generating 9 tokens
     (torch.profiler) against the same call's wall time.
  5. reference: the first two layers of the served model, fp32 compute,
     prefill + 2 decode steps on the card (kernels) against the CPU (plain
     versions), logits within 1e-4.
  6. kernel times for one step's worth of launches on the served weights
     (155 projections: 22 layers × 7 + the LM head) — kernel, plain version,
     torch.matmul on the densified bf16 weight (a yardstick the port never
     calls) and the bound — each step captured in a CUDA graph and replayed
     between CUDA events, so host launch overhead is left out.
  7. the four kernels of the execution-mode layer (sonic_matvec,
     sonic_matmul, block_sparse_matmul, clustered_matmul) against their
     plain versions, as in phase 3: the five projection shapes at
     (128, 128) blocks and (512, 384) at blocks (1, 1), (16, 16), (32, 64);
     fp32 and bf16 x, fp32 and bf16 values, int8 and int32 ids; exact zeros
     from an all-zero weight.
  8. layer path: the served model's seeded fp32 weights (all 155
     projections at full width) converted on the card by ``convert_linear``
     in modes "sonic", "block_sparse" and "clustered" (sparsity 0.5,
     (128, 128) blocks, 64 clusters), timed, twice, and required to repeat
     bit for bit; then ``sonic_linear_apply(use_kernel=True)`` over all 155
     at x (4, 1, K) and (4, 64, K) in bf16, launch counters zeroed just
     before and read just after (155 per pass: decode rows on sonic_matvec
     in mode "sonic", on the tiled kernels in the other two); then each
     projection at fp32 x against ``use_kernel=False`` within 1e-4.
  9. kernel times of the four, as in phase 6, on the weights of phase 8:
     sonic_matvec at M = 4, sonic_matmul at M = 256, block_sparse_matmul
     and clustered_matmul at both.
Prints ``{"kernels": [...]}`` (all six kernels) on the line before the
last, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.sonic_layers import (  # noqa: E402
    BlockSparseWeightInt8,
    SonicExecutionConfig,
    convert_linear,
    make_block_sparse_int8,
    sonic_linear_apply,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel  # noqa: E402
from repro_torch.kernels.clustered_matmul import kernel as cm_kernel  # noqa: E402
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
TOL = 1e-4
MAIN_ARGS = ["--arch", "tinyllama-1.1b", "--weight-quant", "int8",
             "--weight-quant-sparsity", "0.5", "--batch", "4", "--prompt-len", "64",
             "--new-tokens", "32"]
PROJECTIONS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo"))
KERNELS = {
    "sonic_matvec_int8": dict(
        wrapper=sm_kernel.sonic_matvec_int8_kernel, plain=sm_kernel.sonic_matvec_int8_plain,
        source="src/repro_torch/csrc/sonic_matvec_int8.cu",
        replaces="src/repro/kernels/sonic_matmul/kernel.py:93", rows=(1, 4, 7)),
    "block_sparse_matmul_int8": dict(
        wrapper=bs_kernel.block_sparse_matmul_int8_kernel,
        plain=bs_kernel.block_sparse_matmul_int8_plain,
        source="src/repro_torch/csrc/block_sparse_matmul_int8.cu",
        replaces="src/repro/kernels/block_sparse_matmul/kernel.py:91", rows=(8, 256, 257)),
}
# The execution-mode layer's kernels; ``weight`` names the format each takes.
LAYER_KERNELS = {
    "sonic_matvec": dict(
        wrapper=sm_kernel.sonic_matvec_kernel, plain=sm_kernel.sonic_matvec_plain,
        source="src/repro_torch/csrc/sonic_matvec.cu", weight="codebook",
        replaces="src/repro/kernels/sonic_matmul/kernel.py:37", rows=(1, 4, 7)),
    "sonic_matmul": dict(
        wrapper=sm_kernel.sonic_matmul_kernel, plain=sm_kernel.sonic_matmul_plain,
        source="src/repro_torch/csrc/sonic_matmul.cu", weight="codebook",
        replaces="src/repro/kernels/sonic_matmul/kernel.py:142", rows=(4, 8, 256, 257)),
    "block_sparse_matmul": dict(
        wrapper=bs_kernel.block_sparse_matmul_kernel, plain=bs_kernel.block_sparse_matmul_plain,
        source="src/repro_torch/csrc/block_sparse_matmul.cu", weight="fp",
        replaces="src/repro/kernels/block_sparse_matmul/kernel.py:40", rows=(4, 8, 256, 257)),
    "clustered_matmul": dict(
        wrapper=cm_kernel.clustered_matmul_kernel, plain=cm_kernel.clustered_matmul_plain,
        source="src/repro_torch/csrc/clustered_matmul.cu", weight="clustered",
        replaces="src/repro/kernels/clustered_matmul/kernel.py:39", rows=(4, 8, 256, 257)),
}
LAYER_MODES = ("sonic", "block_sparse", "clustered")
LAYER_BLOCK = (128, 128)
MAIN_SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    log = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(lib.relative_to(ROOT)), "kernels_compiled": len(regs),
          "max_registers": max(regs), "spill_store_bytes": spills})


def phase_kernels(dev: torch.device) -> dict[str, float]:
    """Each kernel against its plain version; returns the largest error at
    the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(k, n, (128, 128), True) for k, n in MAIN_SHAPES]
    cases += [(512, 384, (16, 16), False), (512, 384, (32, 64), False)]
    errs = dict.fromkeys(KERNELS, 0.0)
    for k, n, block, main in cases:
        w = torch.randn((k, n), generator=gen, device=dev) * k**-0.5
        q = make_block_sparse_int8(w, 0.5, block)
        for name, kn in KERNELS.items():
            for m in kn["rows"]:
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                    got = kn["wrapper"](x, q.values, q.scales, q.indices)
                    want = kn["plain"](x, q.values, q.scales, q.indices)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
                    if main:
                        errs[name] = max(errs[name], (got - want).abs().max().item())
    zero = make_block_sparse_int8(torch.zeros((2048, 2048), device=dev), 0.5, (128, 128))
    for kn in KERNELS.values():
        x = torch.randn((kn["rows"][1], 2048), device=dev, dtype=torch.bfloat16)
        if not (kn["wrapper"](x, zero.values, zero.scales, zero.indices) == 0).all():
            raise AssertionError("an all-zero weight gave nonzero outputs")
    emit({"phase": "kernels_vs_plain", "cases": len(cases), "tolerance": TOL,
          "max_abs_err_main_shapes": errs})
    return errs


def _seconds(fn, reps: int) -> float:
    """Median host seconds of fn(), each run ended by a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase_main_path(card: str):
    args = serve.parse_args(MAIN_ARGS)
    for kn in KERNELS.values():
        kn["wrapper"].launches = 0
    eng = serve.build_engine(args)
    tokens = serve.run_batch(eng, args)
    launches = {name: kn["wrapper"].launches for name, kn in KERNELS.items()}
    n_proj = eng.cfg.n_layers * len(PROJECTIONS) + 1
    want = {"block_sparse_matmul_int8": n_proj,
            "sonic_matvec_int8": n_proj * (args.new_tokens - 1)}
    for name, least in want.items():
        if launches[name] < least:
            raise AssertionError(f"{name}: {launches[name]} launches < {least}")
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < eng.cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tokens.shape}")
    if not torch.equal(serve.run_batch(eng, args), tokens):
        raise AssertionError("a second run gave other tokens")
    prompts = serve.make_prompts(args, eng.cfg.vocab_size)
    t_prefill = _seconds(lambda: eng.generate(prompts, 1), 7)
    t_all = _seconds(lambda: eng.generate(prompts, args.new_tokens), 7)
    emit({"phase": "main_path", "card": card, "launches": launches,
          "prefill_ms": t_prefill * 1e3,
          "decode_ms_per_token": (t_all - t_prefill) * 1e3 / (args.new_tokens - 1),
          "tok_s": args.batch * args.new_tokens / t_all,
          "generate_ms": t_all * 1e3})
    return eng, args, launches


def phase_profile(eng, args, card: str, n_new: int = 9) -> None:
    """Where generation spends the card's time: one ``generate`` of
    ``n_new`` tokens under torch.profiler (device busy time, by kernel),
    against the median wall time of the same call without the profiler."""
    prompts = serve.make_prompts(args, eng.cfg.vocab_size)
    wall = _seconds(lambda: eng.generate(prompts, n_new), 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, n_new)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "profile", "card": card, "new_tokens": n_new, "wall_ms": wall * 1e3,
          "device_busy_ms": busy_ms or None,  # None: the profiler saw no device time
          "device_idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms else None,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:70], "ms": e.self_device_time_total / 1e3,
                           "launches": e.count} for e in top]})


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def phase_reference(eng, depth: int = 2) -> None:
    """The served model cut to ``depth`` layers, fp32 compute: kernels on
    the card against plain versions on the CPU."""
    cfg = eng.cfg.replace(n_layers=depth, compute_dtype="float32")
    card = {**eng.params, "layers": _tree(lambda a: a[:depth], eng.params["layers"])}
    cpu = _tree(lambda a: a.cpu(), card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    outs = []
    for params, dev in ((card, eng.device), (cpu, torch.device("cpu"))):
        cache = transformer.init_cache(cfg, 2, 16, dev, dtype=torch.float32)
        lg, cache = transformer.forward(params, cfg, tokens=tokens.to(dev), cache=cache)
        logits = [lg[:, -1]]
        for step in range(2):  # decode steps fed the same tokens on both sides
            pos = torch.full((2,), 8 + step, device=dev)
            lg, cache = transformer.forward(params, cfg, tokens=tokens[:, step:step + 1].to(dev),
                                            cache=cache, cache_pos=pos)
            logits.append(lg[:, 0])
        outs.append(torch.stack(logits).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    torch.testing.assert_close(outs[0], outs[1], rtol=TOL, atol=TOL)
    emit({"phase": "reference", "layers": depth, "max_abs_logit_err": err,
          "tolerance": TOL})


def _step_ms(fn, reps: int = 10) -> float:
    """Device ms of one call of fn(): captured in a CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(eng, launches: dict, errs: dict) -> list[dict]:
    cfg, params, dev = eng.cfg, eng.params, eng.device
    weights = []  # (K, values, scales, indices) for one step's 155 projections
    for i in range(cfg.n_layers):
        for blk, proj in PROJECTIONS:
            p = params["layers"][blk][proj]
            k = cfg.d_ff if (blk, proj) == ("ffn", "wo") else cfg.d_model
            weights.append((k, p["qvalues"][i], p["qscales"][i], p["qindices"][i]))
    head = params["lm_head"]
    weights.append((cfg.d_model, head["qvalues"], head["qscales"], head["qindices"]))
    dense = [BlockSparseWeightInt8(v, s, ix, k // v.shape[2]).dense(torch.bfloat16)
             for k, v, s, ix in weights]
    rows = {"sonic_matvec_int8": 4, "block_sparse_matmul_int8": 256}  # batch 4; 4 × 64
    out = []
    for name, kn in KERNELS.items():
        m = rows[name]
        xs = {k: torch.randn((m, k), device=dev, dtype=torch.bfloat16)
              for k in (cfg.d_model, cfg.d_ff)}
        n_bytes = n_ops = bound_s = 0.0
        for k, v, s, ix in weights:
            # kept int8 + scales + indices, x read once (bf16), y written once (fp32)
            b = v.numel() + 4 * (s.numel() + ix.numel()) + 2 * m * k + 4 * m * v.shape[0] * v.shape[3]
            ops = 2.0 * m * v.numel()
            n_bytes, n_ops = n_bytes + b, n_ops + ops
            bound_s += max(b / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS)

        def run(fn):
            return lambda: [fn(xs[k], v, s, ix) for k, v, s, ix in weights]

        entry = {
            "name": name, "route": "cuda", "source": kn["source"], "replaces": kn["replaces"],
            "launches": launches[name], "max_abs_err": errs[name], "rows": m,
            "ms": _step_ms(run(kn["wrapper"])),
            "plain_ms": _step_ms(run(kn["plain"])),
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / BF16_TENSOR_FLOPS
            else "operations",
            "library_ms": _step_ms(lambda: [xs[k] @ d for (k, *_), d in zip(weights, dense)]),
        }
        emit({"phase": "kernel_time", "rows": m, "launches_per_step": len(weights),
              "kept_weight_bytes": sum(v.numel() for _, v, _, _ in weights),
              "kernel_ms": entry["ms"], **{k: v for k, v in entry.items() if k != "ms"}})
        out.append(entry)
    return out


def _layer_weights(k: int, n: int, block, gen, dev) -> list[tuple[str, tuple]]:
    """(name, args after x) of every weight form phase 7 holds each layer
    kernel to, on one random (k, n) weight's kept-block structure."""
    w = torch.randn((k, n), generator=gen, device=dev) * k**-0.5
    q = make_block_sparse_int8(w, 0.5, block)
    ids = torch.randint(0, 64, q.values.shape, generator=gen, device=dev, dtype=torch.int8)
    codebook = torch.randn((64,), generator=gen, device=dev) * k**-0.5
    values = q.values.float() * q.scales[:, :, None, None]
    dense_ids = torch.randint(0, 64, (k, n), generator=gen, device=dev, dtype=torch.int8)
    return [("codebook", (ids, codebook, q.indices)),
            ("fp", (values, q.indices)), ("fp", (values.bfloat16(), q.indices)),
            ("clustered", (dense_ids, codebook)), ("clustered", (dense_ids.int(), codebook))]


def phase_layer_kernels(dev: torch.device) -> dict[str, float]:
    """Each layer kernel against its plain version; returns the largest
    error at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(k, n, (128, 128), True) for k, n in MAIN_SHAPES]
    cases += [(512, 384, block, False) for block in ((1, 1), (16, 16), (32, 64))]
    errs = dict.fromkeys(LAYER_KERNELS, 0.0)
    n_checks = 0
    for k, n, block, main in cases:
        forms = _layer_weights(k, n, block, gen, dev)
        for name, kn in LAYER_KERNELS.items():
            for form, w in forms:
                if form != kn["weight"]:
                    continue
                for m in kn["rows"]:
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                        got = kn["wrapper"](x, *w)
                        want = kn["plain"](x, *w)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
                        n_checks += 1
                        if main:
                            errs[name] = max(errs[name], (got - want).abs().max().item())
    zero = {form: tuple(torch.zeros_like(a) if a.is_floating_point() else a for a in w)
            for form, w in _layer_weights(2048, 2048, (128, 128), gen, dev)}
    for kn in LAYER_KERNELS.values():
        x = torch.randn((kn["rows"][1], 2048), device=dev, dtype=torch.bfloat16)
        if not (kn["wrapper"](x, *zero[kn["weight"]]) == 0).all():
            raise AssertionError("an all-zero weight gave nonzero outputs")
    emit({"phase": "layer_kernels_vs_plain", "cases": len(cases), "checks": n_checks,
          "tolerance": TOL, "max_abs_err_main_shapes": errs})
    return errs


def _projection_weights(cfg, params) -> list[torch.Tensor]:
    """The 155 (K, N) projection weights of one step: 22 layers × 7 + head."""
    ws = [params["layers"][blk][proj]["kernel"][i]
          for i in range(cfg.n_layers) for blk, proj in PROJECTIONS]
    return ws + [params["lm_head"]["kernel"]]


def _weight(p, mode: str):
    """The populated weight of a converted layer, with its input width."""
    w = getattr(p, mode)
    return w, (w.shape if mode == "clustered" else w.dense_shape)[0]


def _same(a, b) -> bool:
    return all(torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
               for u, v in ((getattr(a, f.name), getattr(b, f.name))
                            for f in dataclasses.fields(a)))


def phase_layer_path(eng, card: str) -> tuple[dict, dict]:
    """Conversion, the counted run of ``sonic_linear_apply`` in the three
    kernel-backed modes, and the fp32 check against the fallbacks."""
    cfg, dev = eng.cfg, eng.device
    raw = eng.arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)  # served seed
    ws = _projection_weights(cfg, raw)
    configs = {mode: SonicExecutionConfig(mode=mode, use_kernel=True, weight_sparsity=0.5,
                                          block=LAYER_BLOCK, num_clusters=64)
               for mode in LAYER_MODES}
    converted, seconds = {}, {}
    for mode, sc in configs.items():
        seconds[mode] = []
        for _ in range(2):
            t0 = time.perf_counter()
            conv = [convert_linear(w, sc) for w in ws]
            torch.cuda.synchronize()
            seconds[mode].append(time.perf_counter() - t0)
            if mode not in converted:
                converted[mode] = conv
            elif not all(_same(_weight(a, mode)[0], _weight(b, mode)[0])
                         for a, b in zip(converted[mode], conv)):
                raise AssertionError(f"{mode}: a second conversion differs from the first")
        del conv
    n = len(ws)
    del raw, ws
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = {(s, k): torch.randn((4, s, k), generator=gen, device=dev, dtype=torch.bfloat16)
          for s in (1, 64) for k in (cfg.d_model, cfg.d_ff)}

    for kn in LAYER_KERNELS.values():
        kn["wrapper"].launches = 0
    good = 0
    for mode, sc in configs.items():
        for s in (1, 64):
            for p in converted[mode]:
                y = sonic_linear_apply(p, xs[(s, _weight(p, mode)[1])], sc)
                good += y.shape[:2] == (4, s) and y.dtype == torch.bfloat16
    torch.cuda.synchronize()
    launches = {name: kn["wrapper"].launches for name, kn in LAYER_KERNELS.items()}
    want = {"sonic_matvec": n, "sonic_matmul": n, "block_sparse_matmul": 2 * n,
            "clustered_matmul": 2 * n}
    if launches != want or good != 2 * n * len(configs):
        raise AssertionError(f"layer path: launches {launches}, want {want}; "
                             f"{good} well-shaped outputs")
    errs = {}
    for mode, sc in configs.items():
        fallback = dataclasses.replace(sc, use_kernel=False)
        errs[mode] = 0.0
        for s in (1, 64):
            for p in converted[mode]:
                x = xs[(s, _weight(p, mode)[1])].float()
                got, ref = sonic_linear_apply(p, x, sc), sonic_linear_apply(p, x, fallback)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{mode}: non-finite outputs")
                torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
                errs[mode] = max(errs[mode], (got - ref).abs().max().item())
    emit({"phase": "layer_path", "card": card, "projections": n,
          "convert_seconds_first_second": seconds, "launches": launches,
          "max_abs_err_vs_fallback_fp32": errs, "tolerance": TOL})
    return converted, launches


def phase_layer_timing(converted: dict, launches: dict, errs: dict) -> list[dict]:
    """One step's worth (155 projections) of each layer kernel: kernel,
    plain version, torch.matmul on the densified bf16 weight, and the bound
    (bytes: weights or ids + indices + codebook + x (bf16) + y (fp32);
    operations: 2·M·weights read, at the bf16 tensor-core peak)."""
    # kernel -> (mode, the rows it is timed at); its entry in the kernels
    # line is the first, the others ride along as "rows_<M>"
    plan = {"sonic_matvec": ("sonic", (4,)), "sonic_matmul": ("sonic", (256,)),
            "block_sparse_matmul": ("block_sparse", (256, 4)),
            "clustered_matmul": ("clustered", (256, 4))}
    out, dense = [], {}
    for name, (mode, rows) in plan.items():
        kn = LAYER_KERNELS[name]
        weights = []  # (K, args after x) per projection
        for p in converted[mode]:
            w, k = _weight(p, mode)
            args = ((w.idx_values, w.codebook, w.indices) if mode == "sonic" else
                    (w.values, w.indices) if mode == "block_sparse" else (w.indices, w.codebook))
            weights.append((k, args))
        if mode not in dense:
            dense = {mode: [_weight(p, mode)[0].dense(torch.bfloat16) for p in converted[mode]]}
        entry = None
        for m in rows:
            dev = weights[0][1][0].device
            xs = {k: torch.randn((m, k), device=dev, dtype=torch.bfloat16) for k, _ in weights}
            n_bytes = n_ops = bound_s = 0.0
            for (k, args), d in zip(weights, dense[mode]):
                b = (sum(a.numel() * a.element_size() for a in args)
                     + 2 * m * k + 4 * m * d.shape[1])
                ops = 2.0 * m * args[0].numel()  # kept weights, or every weight
                n_bytes, n_ops = n_bytes + b, n_ops + ops
                bound_s += max(b / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS)

            def run(fn):
                return lambda: [fn(xs[k], *args) for k, args in weights]

            row = {"rows": m, "ms": _step_ms(run(kn["wrapper"])),
                   "plain_ms": _step_ms(run(kn["plain"])), "bound_ms": bound_s * 1e3,
                   "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / BF16_TENSOR_FLOPS
                   else "operations",
                   "library_ms": _step_ms(
                       lambda: [xs[k] @ d for (k, _), d in zip(weights, dense[mode])])}
            emit({"phase": "kernel_time", "name": name, "launches_per_step": len(weights),
                  "weight_bytes": sum(args[0].numel() * args[0].element_size()
                                      for _, args in weights), **row})
            if entry is None:
                entry = {"name": name, "route": "cuda", "source": kn["source"],
                         "replaces": kn["replaces"], "launches": launches[name],
                         "max_abs_err": errs[name], **row}
            else:
                entry[f"rows_{m}"] = row
        out.append(entry)
    return out


@torch.inference_mode()
def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    errs = phase_kernels(dev)
    eng, args, launches = phase_main_path(card)
    phase_profile(eng, args, card)
    phase_reference(eng)
    kernels = phase_timing(eng, launches, errs)
    layer_errs = phase_layer_kernels(dev)
    converted, layer_launches = phase_layer_path(eng, card)
    kernels += phase_layer_timing(converted, layer_launches, layer_errs)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

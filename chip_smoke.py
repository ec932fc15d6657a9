#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero before the last line:
  1. device: a CUDA card (else exit 1), its name and power limit as
     nvidia-smi gives them; TF32 off for matmuls and cuDNN.
  2. build: the CUDA kernels from src/repro_torch/csrc into build/, timed,
     with ptxas's register / spill summary and each source's compile
     seconds.
  3. kernels vs plain versions: each kernel against its plain PyTorch
     version at the main path's projection shapes (128×128 blocks,
     sparsity 0.5) and at small blocks, fp32 and bf16 x, fp32 outputs held
     to rtol = atol = 1e-4 (the sums run in another order over up to 5632
     terms), the matvec at M = 1 … 7; an all-zero weight or x must give exact
     zeros.  Both int8 kernels have two routes (``build.mma_route``: bf16 x
     on the tensor cores where the blocks fit, the rest on the CUDA cores);
     each route of each must have run.
  4. main path: tinyllama-1.1b at full width, random weights from a seeded
     generator on the card, quantized there to int8 block-sparse
     (sparsity 0.5), greedy batch 4 × prompt 64 × 32 new tokens through
     ``repro_torch.launch.serve``.  The launch counters are zeroed just
     before and read just after, with both int8 kernels' route counters
     (every prefill and decode launch, bf16 x, on the tensor cores); tokens must be in
     range and repeat on a second run.  Then prefill ms, decode ms/token and
     tok/s (host clock, medians of 7), and the card's busy time while
     generating 9 tokens and in one prefill (torch.profiler) against the
     same calls' wall time.
  5. reference: the first two layers of the served model, fp32 compute,
     prefill + 2 decode steps on the card (kernels; fp32 x takes the int8
     tiled matmul on the CUDA cores at every M) against the CPU (plain
     versions), logits
     within 1e-4; then the same two layers in the served bf16 compute, every
     prefill and decode projection on the tensor cores, greedy prefill + 2
     decode steps on
     each side: the same tokens, logits within 2**-5 (two bf16 ulps at
     |logit| < 4, the bound of tests/test_torch_engine.py's bf16 test).
  6. kernel times for one step's worth of launches on the served weights
     (155 projections: 22 layers × 7 + the LM head) — kernel, plain version,
     torch.matmul on the densified bf16 weight (a yardstick the port never
     calls) and the bound — each step captured in a CUDA graph and replayed
     between CUDA events, so host launch overhead is left out (``eager_ms``:
     the same launches issued from Python, host clock); for both also the
     route the timed launches took, the achieved TFLOP/s and GB/s, the
     earlier time and µs per launch of each projection shape (for the
     matvec also at one block per 64-column tile, split 1).  Then what
     fp32 x at M = 4 costs on the tiled matmul, which takes every fp32
     launch since a row's bits must not depend on M, against the CUDA-core
     matvec it replaced there (``fp32_x_decode_cost``).
  7. the four kernels of the execution-mode layer (sonic_matvec,
     sonic_matmul, block_sparse_matmul, clustered_matmul) against their
     plain versions, as in phase 3: the five projection shapes at
     (128, 128) blocks and (512, 384) at blocks (1, 1), (16, 16), (32, 64);
     fp32 and bf16 x, fp32 and bf16 values, int8 and int32 ids; exact zeros
     from an all-zero weight.  sonic_matmul, block_sparse_matmul and
     clustered_matmul have two routes (``build.mma_route``); both must have
     run, and each route's largest error is reported.  Then the two routes
     and the plain version of clustered_matmul (unit-scale centroids),
     block_sparse_matmul (unit-scale fp32 values) and
     block_sparse_matmul_int8 against the exact (fp64) product, K = 5632,
     M = 257: each tensor-core route within 1e-4 of it, and for the three
     parts of fp32 weights no less accurate (rms) than the plain version.
     sonic_matvec's two routes are held as sonic_matmul's.  Then a row's
     bits across the decode threshold (``phase_row_bits``): at the five
     projection shapes, the int8 pair (sonic_matvec_int8 /
     block_sparse_matmul_int8) and the codebook pair (sonic_matvec /
     sonic_matmul), bf16 x and fp32 x, as the ops dispatch them, give each
     row at M = 1, 4, 7 the bits of the same row at M = 8, 12, 20 and 256,
     and the dense bf16 path (``layers.dense_apply``, rows padded to 64)
     at M = 8, 12, 20, or the run fails; the dense path's 256-row prefill
     and cuBLAS x @ W unpadded are reported beside them.  Then the
     serving modes at full width (``phase_serving_modes``: batch 4, prompt
     64, the served int8 weights and the dense bf16 weights of the same
     seed): a verify window at k = 4 (20 rows, ``decode_chunk``) ≡ 5
     sequential decode steps bit for bit, under bf16 and int8 KV, for both
     weight formats; chunk-resume in chunks of 16 ≡ whole-prompt prefill
     (held for int8 weights, reported for dense); paged (block_len 16, a
     scrambled table) ≡ dense through a prefill and 8 decode steps; int8
     KV against bf16 KV (max |Δ logit|, greedy-token agreement,
     reported); the greedy tokens of the scan, while and python loops
     equal.
  8. layer path: the served model's seeded fp32 weights (all 155
     projections at full width) converted on the card by ``convert_linear``
     in modes "sonic", "block_sparse" and "clustered" (sparsity 0.5,
     (128, 128) blocks, 64 clusters), timed, twice, and required to repeat
     bit for bit; then ``sonic_linear_apply(use_kernel=True)`` over all 155
     at x (4, 1, K) and (4, 64, K) in bf16, launch counters zeroed just
     before and read just after (155 per pass: decode rows on sonic_matvec
     in mode "sonic", on the matmul kernels in the other two), with every
     bf16 launch of sonic_matmul, block_sparse_matmul and clustered_matmul
     on the tensor-core route; then each projection at fp32 x against
     ``use_kernel=False`` within 1e-4.
  9. kernel times of the four, as in phase 6, on the weights of phase 8:
     sonic_matvec at M = 4, sonic_matmul at M = 256, block_sparse_matmul
     and clustered_matmul at both, each also issued from Python
     (``eager_ms``); for the four routed kernels also the route the timed
     launches took (their route counters), the achieved TFLOP/s
     (2·M·weights) and GB/s, the earlier time and µs per launch of each
     projection shape (sonic_matvec also at split 1; the kernels line keeps
     the measured times only).
 10. the C3 kernel (sparse_matvec) against its plain version: the five
     projection shapes at knz = round(K / 4) and B 1, 4, 7; knz 0, 1, 7 ×
     N 1, 96, 130 × B 1, 4, 7, 256; fp32 and bf16 x and rows, fp32 outputs
     held to 1e-4; exact zeros from an all-zero weight.  The kernel is one
     launch per projection (``csrc/sparse_matvec.cu``: the kept rows in
     chunks of 32 over a cluster of ``build.sparse_matvec_plan`` blocks per
     column tile, each warp's rows copied by cp.async into its own ring, the
     warp sums combined in one order through distributed shared memory; no
     second pass, no workspace), with two routes
     (``build.sparse_matvec_route``: ``async_copy`` where the rows start
     16-byte aligned, ``cuda_cores`` elsewhere, N = 1 and 130 here); both
     must have run.
 11. C3 paths: the STL10 CNN at its published width (96×96×3 input, fc0
     147,456 → 512) on a seeded batch of 4: fc0's input through
     ``topk_sparse_matmul`` (k = its batch-union nonzero count) and one row
     through ``compress_fc`` + ``sparse_matvec``, both against dense x @ W
     in fp32 (1e-4), with the activation sparsity; then the full-width
     tinyllama-1.1b C3 path: phase 8's seeded weights, all 155 projections
     in bf16 through ``topk_sparse_matmul`` at x (4, 1, K), k = round(K /
     4), launch counter zeroed just before and read just after (155), and
     each projection at fp32 against ``sparse_ffn_matmul`` (mode "topk"'s
     plain path) within 1e-4.  Then the kernel's times as in phase 6: 155
     launches in one CUDA graph (bf16, B = 4), the plain version, and the
     library call ``x_nz @ Wt.index_select(0, idx)`` (both in the graph);
     µs per launch of the kernel and the library call at each of the five
     shapes, the route the timed launches took, and the device kernels of
     one eager pass by name (torch.profiler: launches per projection and
     µs per launch).
 12. the SONIC pipeline of the repo's two examples, through the port on the
     card: C1 ``build_masks`` (sparsity 0.5, (8, 8) blocks) over the full
     tinyllama-1.1b params, C2 ``cluster_params`` (64 clusters), greedy
     generation (batch 4 × prompt 64 × 12 new tokens) with the dense and
     the clustered params and their token agreement, then the photonic
     model: ``lm_workload`` of the full model through ``evaluate_all``, and
     for each of the four Table 1 CNNs at its published width
     ``cnn_workload``, the five-variant ablation and ``evaluate_all`` with
     SONIC's FPS/W ratio against each baseline.  Those FPS, W and ratios are
     outputs of the analytical photonic model, not card measurements.
 13. continuous serving (``phase_continuous``, run after the serving
     modes): ``ContinuousScheduler`` over the served weights at max_len 128,
     its slot programs replayed from CUDA graphs.  8 ragged requests whose
     tokens must equal ``generate`` at B = 1 in ten configurations (scan /
     while × dense / paged, chunked admission, n_slots 8, int8 KV,
     overcommit 2.0 with recompute and with swap, where preemption must
     happen), every int8 launch on the tensor cores, each slot program
     captured once per shape and none run eagerly; then 32 requests at 100
     requests/s through ``launch.serve.run_poisson``, scan / while × dense /
     paged: tok/s, p50 / p95 latency and TTFT (median, min, max of 3 runs
     after one that captures), segments, admit ms per round, captures, and
     the card's busy time (torch.profiler) against the median wall.
 14. speculative decoding (``phase_speculative``, after continuous
     serving): the same 8 requests under k = 4 drafters — ``truncate:1``
     (scan / while × dense / paged), ``self`` (the seed's raw weights pruned
     to 0.75 and kept block-sparse in bf16, on block_sparse_matmul) and
     ``truncate:22`` (the whole model, whose drafts must all be accepted
     but at budget edges, at k = 4 and at k = 16: windows of 17 rows, the
     queries padded to 32, 68 rows a window) — and k = 2 ``truncate:1``
     with int8 KV, paged
     overcommit with recompute (preemption must happen) and chunked
     admission, each request equal to its own ``generate`` at B = 1; the
     counters zeroed just before each run and read just after (the int8
     pair, and block_sparse_matmul for ``self``, launched, every launch on
     the tensor cores); each spec program one graph of one round per
     geometry, none run eagerly, with its launches per round.  Then
     block_sparse_matmul's time for one draft step (154 projections, M = 4,
     bf16 values) beside its plain version, x @ W and the bound; and 32
     requests at 100 requests/s, dense while, plain and the three k = 4
     drafters: tok/s, latency and TTFT (median, min, max of 3), accepted
     tokens per round, predicated rounds, captures and the busy time.
 15. the serving front door (``phase_http``, after speculative decoding):
     ``serve.http.FrontDoor`` in this process on 127.0.0.1 port 0 over a
     ``ContinuousScheduler`` of the served weights (paged, n_slots 4, while
     segments of 8, the trace on, tenants acme:3 and hobby:1 under the
     default priority classes and an ``SloConfig``), the scheduler on the
     front door's worker thread.  16 requests from ``_poisson_draws``
     (prompts 4–64, 4–32 new tokens) as concurrent SSE clients (the port's
     client helpers), each ending in ``done`` with its streamed tokens
     equal to its final list and to ``generate`` at B = 1, beside the
     offline scheduler on the same requests (tok/s, p50 / p95 TTFT and
     latency of each), heartbeats while segments run, the counters zeroed
     just before and read just after (the int8 pair launched, on the
     tensor cores), the card's busy time against the trace's priced FLOPs
     and bytes (a model against the card), the photonic model's J/token,
     admissions per tenant and the brownout trajectory; then a client that
     disconnects mid-stream (slot and blocks back within one segment), a
     burst over ``max_pending`` (429 + Retry-After before admission; the
     drain predictor against the measured drain) and a graceful stop with
     streams in flight (all complete); the graphs captured on the main
     thread and replayed on the worker, and on a fresh engine captured on
     the worker and replayed on the main thread; no slot program eager.
Prints ``{"kernels": [...]}`` (all seven kernels) on the line before the
last, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.activation_sparsity import (  # noqa: E402
    column_scores,
    sparse_ffn_matmul,
    top_k,
)
from repro_torch.core.clustering import (  # noqa: E402
    ClusteringConfig,
    cluster_params,
    storage_bits,
)
from repro_torch.core.compression import compress_fc, compressed_fc_apply  # noqa: E402
from repro_torch.core.sonic_layers import (  # noqa: E402
    BlockSparseWeight,
    BlockSparseWeightInt8,
    SonicExecutionConfig,
    convert_linear,
    make_block_sparse_int8,
    sonic_linear_apply,
)
from repro_torch.kernels import build, counters  # noqa: E402
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel  # noqa: E402
from repro_torch.kernels.clustered_matmul import kernel as cm_kernel  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    SparsityConfig,
    apply_masks,
    build_masks,
    sparsity_of,
)
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.sonic_matmul import ops as sm_ops  # noqa: E402
from repro_torch.kernels.sparse_matvec import kernel as smv_kernel  # noqa: E402
from repro_torch.kernels.sparse_matvec import ops as smv_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import cnn, layers, transformer  # noqa: E402
from repro_torch.photonic.accelerator import SonicAccelerator, SonicHWConfig  # noqa: E402
from repro_torch.photonic.baselines import evaluate_all  # noqa: E402
from repro_torch.photonic.mapper import cnn_workload, lm_workload  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    SLOT_PROGRAMS,
    ServeConfig,
    ServeEngine,
    SpecConfig,
    no_gc,
)
from repro_torch.serve import http  # noqa: E402
from repro_torch.serve.policy import (  # noqa: E402
    DEFAULT_CLASSES,
    SloConfig,
    TenantPolicy,
    TenantSpec,
)
from repro_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.serve.trace import trace_energy  # noqa: E402
from repro_torch.utils.tree import tree_param_count  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
TOL = 1e-4
BF16_LOGIT_TOL = 2**-5  # two bf16 ulps at |logit| < 4 (tests/test_torch_engine.py's bound)
MAIN_ARGS = ["--arch", "tinyllama-1.1b", "--weight-quant", "int8",
             "--weight-quant-sparsity", "0.5", "--batch", "4", "--prompt-len", "64",
             "--new-tokens", "32"]
DECODE_ROWS = (1, 2, 3, 4, 5, 6, 7)  # the matvecs' rows: M < ops.DECODE_M_THRESHOLD
PROJECTIONS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo"))
KERNELS = {
    "sonic_matvec_int8": dict(
        wrapper=sm_kernel.sonic_matvec_int8_kernel, plain=sm_kernel.sonic_matvec_int8_plain,
        source="src/repro_torch/csrc/sonic_matvec_int8.cu",
        replaces="src/repro/kernels/sonic_matmul/kernel.py:93", rows=DECODE_ROWS),
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
        replaces="src/repro/kernels/sonic_matmul/kernel.py:37", rows=DECODE_ROWS),
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
C3_KERNEL = dict(name="sparse_matvec", source="src/repro_torch/csrc/sparse_matvec.cu",
                 replaces="src/repro/kernels/sparse_matvec/kernel.py:40",
                 design="one launch per projection: chunks of 32 kept rows over a "
                        "cluster of split blocks per column tile, cp.async rings per warp, "
                        "warp sums combined in order through distributed shared memory")
# The layer kernels with two routes (both kernels of KERNELS have them too),
# and the routed kernels' times before their tensor-core route, by rows
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the matmuls' on the CUDA cores,
# the matvecs' in their CUDA-core design
ROUTED = ("sonic_matvec", "sonic_matmul", "block_sparse_matmul", "clustered_matmul")
INT8_MATMUL = "block_sparse_matmul_int8"
INT8_MATVEC = "sonic_matvec_int8"
PREVIOUS_MS = {("sonic_matmul", 256): 23.137, ("clustered_matmul", 256): 44.351,
               ("clustered_matmul", 4): 17.647, (INT8_MATMUL, 256): 22.515,
               ("block_sparse_matmul", 256): 22.806, ("block_sparse_matmul", 4): 8.893,
               (INT8_MATVEC, 4): 2.902, ("sonic_matvec", 4): 2.906}
# The decode kernel's entry points, each timed at one block per tile too
# (split 1) beside build.decode_split's choice
DECODE_ENTRY = {INT8_MATVEC: "sonic_matvec_int8_mma", "sonic_matvec": "sonic_matvec_mma"}
WINDOWS = (8, 12, 20, 256)  # verify windows B·(k+1), B = 4, k = 1, 2, 4; a prefill
TOPK_FRAC = 0.25  # mode "topk"'s default kept fraction
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
    source_s = {name: float(sec) for name, sec in re.findall(r"^== (\S+) \(([\d.]+) s\)", log,
                                                             re.M)}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(lib.relative_to(ROOT)), "kernels_compiled": len(regs),
          "max_registers": max(regs), "spill_store_bytes": spills,
          "source_seconds": source_s})


def phase_kernels(dev: torch.device) -> dict[str, float]:
    """Each kernel against its plain version; returns the largest error at
    the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(k, n, (128, 128), True) for k, n in MAIN_SHAPES]
    cases += [(512, 384, (16, 16), False), (512, 384, (32, 64), False)]
    errs = dict.fromkeys(KERNELS, 0.0)
    for kn in KERNELS.values():
        kn["wrapper"].routes = dict.fromkeys(build.ROUTES, 0)
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
    w = make_block_sparse_int8(torch.randn((2048, 2048), device=dev), 0.5, (128, 128))
    for kn in KERNELS.values():
        x = torch.randn((kn["rows"][1], 2048), device=dev, dtype=torch.bfloat16)
        if not ((kn["wrapper"](x, zero.values, zero.scales, zero.indices) == 0).all()
                and (kn["wrapper"](torch.zeros_like(x), w.values, w.scales, w.indices) == 0).all()):
            raise AssertionError("an all-zero weight or x gave nonzero outputs")
    routes = {name: dict(kn["wrapper"].routes) for name, kn in KERNELS.items()}
    if not all(v > 0 for r in routes.values() for v in r.values()):
        raise AssertionError(f"a route of the int8 kernels never ran: {routes}")
    emit({"phase": "kernels_vs_plain", "cases": len(cases), "tolerance": TOL,
          "max_abs_err_main_shapes": errs, "routes": routes})
    return errs


def _times(fn, reps: int) -> list[float]:
    """Host seconds of each of ``reps`` runs of fn(), each ended by a
    synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _seconds(fn, reps: int) -> float:
    """Median host seconds of fn(), each run ended by a synchronize."""
    return statistics.median(_times(fn, reps))


def _spread(values: list[float]) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def _loop_timing(eng, prompts, n_new: int, reps: int = 7) -> dict:
    """Prefill ms (``generate(prompts, 1)``), decode ms/token and tok/s of
    ``generate(prompts, n_new)``, each as the median, min and max of
    ``reps`` runs (host clock; prefill and generate in turns, so decode
    pairs them run by run)."""
    pre, full = [], []
    for _ in range(reps):
        pre += _times(lambda: eng.generate(prompts, 1), 1)
        full += _times(lambda: eng.generate(prompts, n_new), 1)
    b = prompts.shape[0]
    return {"prefill_ms": _spread([t * 1e3 for t in pre]),
            "decode_ms_per_token": _spread([(f - p) * 1e3 / (n_new - 1)
                                            for p, f in zip(pre, full)]),
            "tok_s": _spread([b * n_new / f for f in full]),
            "generate_ms": _spread([f * 1e3 for f in full])}


def _counts(counts) -> dict:
    """A ``kernels.counters`` difference as {kernel: launches} (those > 0)."""
    return {name: n for name, (n, _) in counts.items() if n}


def _captures(eng) -> dict:
    """The engine's captures, by program, those > 0."""
    return {k: v for k, v in eng.trace_counts.items() if v}


def phase_main_path(card: str):
    """The served model through ``launch.serve`` on the default loop,
    "scan": the prefill and each decode step replayed from CUDA graphs,
    with the kernels' counters true per replay; then the eager "python"
    loop on the same weights beside it."""
    args = serve.parse_args(MAIN_ARGS)
    if args.loop != "scan":
        raise AssertionError(f"the launcher's default loop is {args.loop}, want scan")
    for kn in KERNELS.values():
        kn["wrapper"].launches = 0
        kn["wrapper"].routes = dict.fromkeys(build.ROUTES, 0)
    eng = serve.build_engine(args)
    tokens = serve.run_batch(eng, args)
    launches = {name: kn["wrapper"].launches for name, kn in KERNELS.items()}
    routes = {name: dict(kn["wrapper"].routes) for name, kn in KERNELS.items()}
    n_proj = eng.cfg.n_layers * len(PROJECTIONS) + 1
    want = {INT8_MATMUL: n_proj, "sonic_matvec_int8": n_proj * (args.new_tokens - 1)}
    for name, least in want.items():
        if launches[name] < least:
            raise AssertionError(f"{name}: {launches[name]} launches < {least}")
    # the served model runs bf16 x: every prefill and decode launch on the
    # tensor cores
    if any(routes[name] != {build.TENSOR_CORES: launches[name], build.CUDA_CORES: 0}
           for name in KERNELS):
        raise AssertionError(f"main path: routes {routes}, want all on the tensor cores")
    if _captures(eng) != {"prefill": 1, "decode": 1}:
        raise AssertionError(f"main path: captures {eng.trace_counts}, want one of each")
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < eng.cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tokens.shape}")
    if not torch.equal(serve.run_batch(eng, args), tokens):
        raise AssertionError("a second run gave other tokens")
    if _captures(eng) != {"prefill": 1, "decode": 1}:
        raise AssertionError(f"a second run captured again: {eng.trace_counts}")
    prompts = serve.make_prompts(args, eng.cfg.vocab_size)
    eager = ServeEngine(eng.arch, eng.params, dataclasses.replace(eng.sc, loop="python"),
                        device=eng.device)
    if not torch.equal(eager.generate(prompts, args.new_tokens).cpu(), tokens):
        raise AssertionError("the python loop gave other tokens than the graphs")
    scan, python = _loop_timing(eng, prompts, args.new_tokens), _loop_timing(
        eager, prompts, args.new_tokens)
    emit({"phase": "main_path", "card": card, "loop": "scan", "launches": launches,
          "routes": routes, "captures": _captures(eng),
          "capture_seconds": eng.capture_seconds,
          "graphed_launches": {
              "prefill": _counts(eng.graph_launches()["prefill"][(args.batch, args.prompt_len)]),
              "decode_step": _counts(eng.graph_launches()["decode"][args.batch])},
          "prefill_ms": scan["prefill_ms"]["median"],
          "decode_ms_per_token": scan["decode_ms_per_token"]["median"],
          "tok_s": scan["tok_s"]["median"], "generate_ms": scan["generate_ms"]["median"],
          "spread_of_7": {"scan": scan, "python": python}})
    return eng, eager, args, launches


def _device_kernels(fn) -> list:
    """The device kernels of one call of fn() under torch.profiler, by name."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def phase_profile(engines: dict, args, card: str, n_new: int = 9) -> None:
    """Where generation spends the card's time, for each loop: one
    ``generate`` of ``n_new`` tokens, and one prefill (``generate`` of 1
    token), under torch.profiler (device busy time, by kernel), each
    against the median wall time of the same call without the profiler."""
    prompts = serve.make_prompts(args, engines["scan"].cfg.vocab_size)
    for loop, eng in engines.items():
        out = {}
        for n in (n_new, 1):
            wall = _seconds(lambda: eng.generate(prompts, n), 5)
            kernels = _device_kernels(lambda: eng.generate(prompts, n))
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            out[n] = {"wall_ms": wall * 1e3,
                      "device_busy_ms": busy_ms or None,  # None: no device time seen
                      "device_idle_share": 1 - busy_ms / (wall * 1e3) if busy_ms else None,
                      "kernel_launches": sum(e.count for e in kernels)}
            if n == n_new:
                top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
                out[n]["top_kernels"] = [{"name": e.key[:70],
                                          "ms": e.self_device_time_total / 1e3,
                                          "launches": e.count} for e in top]
        emit({"phase": "profile", "card": card, "loop": loop, "new_tokens": n_new,
              **out[n_new], "prefill": out[1]})


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _two_layer_run(params, cfg, tokens, dev, dtype, greedy: bool):
    """Prefill of ``tokens`` (2 × 8) then 2 decode steps on ``dev``: the
    last logits of each (fp32, on the CPU) and each one's greedy token.  The
    decode steps are fed the greedy tokens when ``greedy``, else the
    prompt's first two columns (the same on every side)."""
    cache = transformer.init_cache(cfg, 2, 16, dev, dtype=dtype)
    lg, cache = transformer.forward(params, cfg, tokens=tokens.to(dev), cache=cache)
    logits = [lg[:, -1]]
    for step in range(2):
        nxt = (logits[-1].argmax(-1, keepdim=True) if greedy
               else tokens[:, step:step + 1].to(dev))
        pos = torch.full((2,), 8 + step, device=dev)
        lg, cache = transformer.forward(params, cfg, tokens=nxt, cache=cache, cache_pos=pos)
        logits.append(lg[:, 0])
    logits = torch.stack(logits).float().cpu()
    return logits, logits.argmax(-1)


def phase_reference(eng, depth: int = 2) -> None:
    """The served model cut to ``depth`` layers: kernels on the card against
    plain versions on the CPU.  In fp32 compute (x fp32, so the int8 matmul
    takes the CUDA cores) the logits within TOL; in the served bf16 compute
    (every prefill projection on the tensor cores) the same greedy tokens
    and logits within BF16_LOGIT_TOL."""
    card = {**eng.params, "layers": _tree(lambda a: a[:depth], eng.params["layers"])}
    cpu = _tree(lambda a: a.cpu(), card)
    tokens = torch.randint(0, eng.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(3))
    wrappers = {name: kn["wrapper"] for name, kn in KERNELS.items()}
    prefill = depth * len(PROJECTIONS) + 1  # int8 matmul launches of one prefill
    # bf16: the prefill on the matmul, the 2 decode steps on the matvec;
    # fp32 x: all three on the tiled matmul (a row's bits do not depend on M)
    want = {torch.bfloat16: {INT8_MATMUL: prefill, INT8_MATVEC: 2 * prefill},
            torch.float32: {INT8_MATMUL: 3 * prefill, INT8_MATVEC: 0}}
    out = {"phase": "reference", "layers": depth}
    for dtype, tol, route in ((torch.float32, TOL, build.CUDA_CORES),
                              (torch.bfloat16, BF16_LOGIT_TOL, build.TENSOR_CORES)):
        want_n = want[dtype]
        cfg = eng.cfg.replace(n_layers=depth, compute_dtype=str(dtype).removeprefix("torch."))
        for fn in wrappers.values():
            fn.routes = dict.fromkeys(build.ROUTES, 0)
        greedy = dtype == torch.bfloat16
        (lc, tc), (lp, tp) = (_two_layer_run(params, cfg, tokens, dev, dtype, greedy)
                              for params, dev in ((card, eng.device), (cpu, torch.device("cpu"))))
        routes = {name: dict(fn.routes) for name, fn in wrappers.items()}
        if any(routes[name] != {**dict.fromkeys(build.ROUTES, 0), route: n}
               for name, n in want_n.items()):
            raise AssertionError(f"reference ({dtype}): routes {routes}, want {want_n} on {route}")
        if greedy and not torch.equal(tc, tp):
            raise AssertionError(f"reference ({dtype}): greedy tokens {tc.tolist()} on the card, "
                                 f"{tp.tolist()} on the CPU")
        torch.testing.assert_close(lc, lp, rtol=0 if greedy else tol, atol=tol)
        row = {"max_abs_logit_err": (lc - lp).abs().max().item(), "tolerance": tol,
               "routes": routes}
        if greedy:
            out["bf16"] = {**row, "max_abs_logit": lp.abs().max().item(),
                           "greedy_tokens_equal": True}
        else:
            out.update(row)
    emit(out)


def _step_ms(fn, reps: int = 10) -> float:
    """Device ms of one call of fn(): captured in a CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    with no_gc(), torch.cuda.graph(graph):
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

        def run(fn, subset=weights):
            return lambda: [fn(xs[k], v, s, ix) for k, v, s, ix in subset]

        kn["wrapper"].routes = dict.fromkeys(build.ROUTES, 0)
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
        shapes = {}
        for w in weights:
            shapes.setdefault(f"{w[0]}x{w[1].shape[0] * w[1].shape[3]}", []).append(w)
        timing = _route_timing(name, m, kn["wrapper"], n_ops, n_bytes, entry["ms"], shapes,
                               lambda sub: _step_ms(run(kn["wrapper"], sub)))
        if name in DECODE_ENTRY:
            timing.update(_split1_timing(
                shapes, lambda sub: _step_ms(lambda: [build.launch_int8(
                    DECODE_ENTRY[name], xs[k], v, s, ix, split=1) for k, v, s, ix in sub])))
        # the same launches issued one by one from Python (host clock, ended
        # by a synchronize): above kernel_ms, the wrappers are host-bound
        eager_ms = _seconds(run(kn["wrapper"]), 5) * 1e3
        emit({"phase": "kernel_time", "rows": m, "launches_per_step": len(weights),
              "kept_weight_bytes": sum(v.numel() for _, v, _, _ in weights),
              "kernel_ms": entry["ms"], **{k: v for k, v in entry.items() if k != "ms"},
              "eager_ms": eager_ms, **timing})
        out.append(entry)
    return out


def phase_fp32_decode_cost(eng, card: str) -> None:
    """What sending fp32 x at M = 4 to the CUDA-core tiled matmul (every M
    one order of sums) costs against the CUDA-core matvec it replaced on
    that dispatch: one step's 155 served projections, replayed from a CUDA
    graph, device ms."""
    cfg, params, dev = eng.cfg, eng.params, eng.device
    weights = [(cfg.d_ff if (blk, proj) == ("ffn", "wo") else cfg.d_model,
                tuple(params["layers"][blk][proj][f][i] for f in ("qvalues", "qscales",
                                                                   "qindices")))
               for i in range(cfg.n_layers) for blk, proj in PROJECTIONS]
    head = params["lm_head"]
    weights.append((cfg.d_model, (head["qvalues"], head["qscales"], head["qindices"])))
    xs = {k: torch.randn((4, k), device=dev) for k in (cfg.d_model, cfg.d_ff)}

    def run(fn):
        return lambda: [fn(xs[k], *w) for k, w in weights]

    emit({"phase": "fp32_x_decode_cost", "card": card, "rows": 4, "launches": len(weights),
          "cuda_core_matvec_ms": _step_ms(run(sm_kernel.sonic_matvec_int8_kernel)),
          "tiled_matmul_ms": _step_ms(run(bs_kernel.block_sparse_matmul_int8_kernel))})


def _route_timing(name: str, m: int, wrapper, n_ops: float, n_bytes: float, ms: float,
                  shapes: dict, time_subset) -> dict:
    """What a routed kernel's timing line adds: the route its timed launches
    took (its route counters, zeroed before the timing), the achieved
    TFLOP/s (2·M·weights) and GB/s (the bound's bytes), its time before the
    tensor-core route and µs per launch of each projection shape, (K, N),
    timed on its own."""
    routes = wrapper.routes
    return {"route": max(routes, key=routes.get), "tflops": n_ops / (ms * 1e-3) / 1e12,
            "gb_s": n_bytes / (ms * 1e-3) / 1e9, "previous_ms": PREVIOUS_MS.get((name, m)),
            "us_per_launch_by_shape": {shape: time_subset(sub) * 1e3 / len(sub)
                                       for shape, sub in shapes.items()}}


def _split1_timing(shapes: dict, time_subset) -> dict:
    """The decode kernel with one block per 64-column tile (no split of its
    chunks), µs per launch of each projection shape: what
    ``build.decode_split`` is measured against."""
    return {"us_per_launch_by_shape_split1": {shape: time_subset(sub) * 1e3 / len(sub)
                                              for shape, sub in shapes.items()}}


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
    route_errs = {name: dict.fromkeys(build.ROUTES, 0.0) for name in ROUTED}
    _reset_routes()
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
                        before = dict(getattr(kn["wrapper"], "routes", {}))
                        got = kn["wrapper"](x, *w)
                        want = kn["plain"](x, *w)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
                        n_checks += 1
                        err = (got - want).abs().max().item()
                        if main:
                            errs[name] = max(errs[name], err)
                        if name in ROUTED:
                            route = next(r for r, v in kn["wrapper"].routes.items()
                                         if v > before[r])
                            route_errs[name][route] = max(route_errs[name][route], err)
    zero = {form: tuple(torch.zeros_like(a) if a.is_floating_point() else a for a in w)
            for form, w in _layer_weights(2048, 2048, (128, 128), gen, dev)}
    for kn in LAYER_KERNELS.values():
        x = torch.randn((kn["rows"][1], 2048), device=dev, dtype=torch.bfloat16)
        if not (kn["wrapper"](x, *zero[kn["weight"]]) == 0).all():
            raise AssertionError("an all-zero weight gave nonzero outputs")
    routes = {name: dict(LAYER_KERNELS[name]["wrapper"].routes) for name in ROUTED}
    if not all(v > 0 for r in routes.values() for v in r.values()):
        raise AssertionError(f"a route of the routed matmuls never ran: {routes}")
    emit({"phase": "layer_kernels_vs_plain", "cases": len(cases), "checks": n_checks,
          "tolerance": TOL, "max_abs_err_main_shapes": errs, "routes": routes,
          "max_abs_err_by_route": route_errs, "fp64_witness": _fp64_witness(dev)})
    return errs


def _fp64_witness(dev: torch.device) -> list[dict]:
    """The two routes and the plain version of clustered_matmul (unit-scale
    centroids, int8 and int32 ids), block_sparse_matmul (unit-scale fp32
    values) and block_sparse_matmul_int8 (unit-scale weights), (128, 128)
    blocks at sparsity 0.5, against the exact (fp64) product, K = 5632,
    M = 257, 2048 columns, bf16 x: max and rms |Δ| of each.  Each
    tensor-core route must lie within TOL of the exact product; the three
    bf16 parts of an fp32 weight must be no less accurate (rms) than the
    plain version's fp32 GEMM."""
    gen = torch.Generator(device=dev).manual_seed(4)
    k, n = 5632, 2048
    x = torch.randn((257, k), generator=gen, device=dev).to(torch.bfloat16)
    cases = []  # (row label, exact, {route or "plain": y}, whether rms is held)
    for ids_dtype, c in ((torch.int8, 128), (torch.int32, 1000)):
        ids = torch.randint(0, c, (k, n), generator=gen, device=dev).to(ids_dtype)
        cb = torch.randn((c,), generator=gen, device=dev)
        ys = {build.TENSOR_CORES: build.launch_clustered(x, ids, cb, "clustered_matmul_mma"),
              build.CUDA_CORES: build.launch_clustered(x, ids, cb),
              "plain": cm_kernel.clustered_matmul_plain(x, ids, cb)}
        cases.append(({"kernel": "clustered_matmul", "ids": str(ids_dtype).removeprefix("torch."),
                       "codebook": c}, x.double() @ cb.double()[ids.long()], ys, True))
    q = make_block_sparse_int8(torch.randn((k, n), generator=gen, device=dev), 0.5, (128, 128))
    fp = q.values.float() * q.scales[:, :, None, None]
    exact = x.double() @ BlockSparseWeightInt8(q.values, q.scales, q.indices,
                                               k // 128).dense(torch.float64)
    cases.append(({"kernel": "block_sparse_matmul", "values": "float32"}, exact,
                  {build.TENSOR_CORES: build.launch_fp(x, fp, q.indices, "block_sparse_matmul_mma"),
                   build.CUDA_CORES: build.launch_fp(x, fp, q.indices),
                   "plain": bs_kernel.block_sparse_matmul_plain(x, fp, q.indices)}, True))
    w8 = (q.values, q.scales, q.indices)
    cases.append(({"kernel": INT8_MATMUL, "values": "int8"}, exact,
                  {build.TENSOR_CORES: build.launch_int8(f"{INT8_MATMUL}_mma", x, *w8),
                   build.CUDA_CORES: build.launch_int8(INT8_MATMUL, x, *w8),
                   "plain": bs_kernel.block_sparse_matmul_int8_plain(x, *w8)}, False))
    out = []
    for row, exact, ys, hold_rms in cases:
        for name, y in ys.items():
            d = y.double() - exact
            row[name] = {"max_abs_err": d.abs().max().item(),
                         "rms_err": d.pow(2).mean().sqrt().item()}
        torch.testing.assert_close(ys[build.TENSOR_CORES].double(), exact, rtol=TOL, atol=TOL)
        if hold_rms and row[build.TENSOR_CORES]["rms_err"] > row["plain"]["rms_err"]:
            raise AssertionError(f"tensor-core route less accurate than the plain version: {row}")
        out.append(row)
    return out


def _rows_across(fn, x: torch.Tensor, windows=WINDOWS) -> dict:
    """fn's rows at M = 1, 4, 7 against the same rows inside each of
    ``windows``: how many of those row pairs differ, and the largest |Δ|."""
    windows = {m: fn(x[:m]) for m in windows}
    pairs = differ = 0
    worst = 0.0
    for m in (1, 4, 7):
        row = fn(x[:m])
        for y in windows.values():
            d = (row.float() - y[:m].float()).abs()
            pairs += m
            differ += int((d > 0).any(-1).sum())
            worst = max(worst, d.max().item())
    return {"rows_differing": differ, "of": pairs, "max_abs_diff": worst}


ROW_BITS_HELD = ("int8_bf16", "int8_op_bf16", "codebook_bf16", "int8_fp32_x",
                 "codebook_fp32_x", "dense_bf16")


def phase_row_bits(dev: torch.device) -> None:
    """A decode row (M = 1, 4, 7) against the same row inside windows of
    M = 8, 12, 20 (speculative verify, B·(k+1) at B = 4, k = 1, 2, 4) and
    256 (a prefill), at the five projection shapes, (128, 128) blocks,
    sparsity 0.5, each pair as the served model dispatches it.  Held bit
    for bit: bf16 x, the int8 pair (the fp32 kernel outputs as
    ``ops.sonic_matmul_int8`` dispatches them, and the op's bf16 output)
    and the codebook pair (``ops.sonic_matmul``'s dispatch); fp32 x, which
    takes the CUDA-core tiled matmul at every M; and the dense bf16 path
    (``layers.dense_apply``: cuBLAS ``x @ W`` with the rows of a call below
    64 padded to 64) against the verify windows, its 256-row prefill
    reported.  Reported too: cuBLAS ``x @ W`` without the padding."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for k, n in MAIN_SHAPES:
        q = make_block_sparse_int8(torch.randn((k, n), generator=gen, device=dev) * k**-0.5,
                                   0.5, (128, 128))
        ids = torch.randint(0, 64, q.values.shape, generator=gen, device=dev, dtype=torch.int8)
        cb = torch.randn((64,), generator=gen, device=dev) * k**-0.5
        dense = BlockSparseWeightInt8(q.values, q.scales, q.indices, k // 128).dense(torch.bfloat16)
        x = torch.randn((max(WINDOWS), k), generator=gen, device=dev)
        w8, wc = (q.values, q.scales, q.indices), (ids, cb, q.indices)

        def int8(xx):
            fn = (sm_kernel.sonic_matvec_int8_kernel if sm_ops.decode_rows(xx, q.values)
                  else bs_kernel.block_sparse_matmul_int8_kernel)
            return fn(xx, *w8)

        def codebook(xx):
            fn = (sm_kernel.sonic_matvec_kernel if sm_ops.decode_rows(xx, ids)
                  else sm_kernel.sonic_matmul_kernel)
            return fn(xx, *wc)

        def dense_apply(xx):
            return layers.dense_apply({"kernel": dense}, xx)

        verify = tuple(m for m in WINDOWS if m < 64)
        row = {}
        for label, fn, xx, windows in (
                ("int8_bf16", int8, x.bfloat16(), WINDOWS),
                ("int8_op_bf16", lambda xx: sm_ops.sonic_matmul_int8(xx, *w8), x.bfloat16(),
                 WINDOWS),
                ("codebook_bf16", codebook, x.bfloat16(), WINDOWS),
                ("int8_fp32_x", int8, x, WINDOWS), ("codebook_fp32_x", codebook, x, WINDOWS),
                ("dense_bf16", dense_apply, x.bfloat16(), verify),
                ("dense_bf16_vs_prefill_256", dense_apply, x.bfloat16(), (256,)),
                ("cublas_bf16", lambda xx: xx @ dense, x.bfloat16(), WINDOWS)):
            row[label] = _rows_across(fn, xx, windows)
            if label in ROW_BITS_HELD and row[label]["rows_differing"]:
                raise AssertionError(f"{k}x{n} {label}: a decode row differs from its window "
                                     f"row: {row[label]}")
        out[f"{k}x{n}"] = row
    emit({"phase": "row_bits", "decode_rows": [1, 4, 7], "windows": list(WINDOWS),
          "dense_windows": [m for m in WINDOWS if m < 64], "held": list(ROW_BITS_HELD),
          "by_shape": out})


def _bf16_kernels(tree):
    """A param tree with every projection kernel in bf16 (the dense path's
    ``x @ W`` then casts nothing)."""
    return {k: _bf16_kernels(v) if isinstance(v, dict)
            else (v.bfloat16() if k == "kernel" else v) for k, v in tree.items()}


def _row_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Rows (last axis) of got that differ from want's, and the largest |Δ|."""
    d = (got.float() - want.float()).abs()
    return {"rows_differing": int((d > 0).any(-1).sum()), "of": d[..., 0].numel(),
            "max_abs_diff": d.max().item()}


def _held(what: str, diff: dict) -> dict:
    if diff["rows_differing"]:
        raise AssertionError(f"serving modes: {what}: {diff}")
    return diff


def phase_serving_modes(eng, eager, card: str) -> None:
    """The transformer's serving modes at full width (tinyllama-1.1b, batch
    4, prompt 64), each mode against the path it must equal, on the served
    int8 weights (sparsity 0.5) and on the dense bf16 weights of the same
    seed (``weight_quant="none"``):

    * a verify window at k = 4 (``decode_chunk``, 20 rows) ≡ 5 sequential
      decode steps, logits bit for bit, both weight formats, bf16 and int8
      KV (held);
    * chunk-resume in chunks of 16 ≡ whole-prompt prefill, last logits of
      each chunk and the cache (held for int8 weights, reported for dense);
    * paged (block_len 16, a scrambled block table) ≡ dense: a chunk-resume
      prefill and 8 greedy decode steps (held);
    * int8 KV against bf16 KV, teacher-forced on the bf16 run's greedy
      tokens: max |Δ logit| and greedy-token agreement (reported);
    * greedy tokens of the "scan", "while" and "python" loops (held equal).
    """
    cfg, dev = eng.cfg, eng.device
    b, s, k1, chunk, bl, steps = 4, 64, 5, 16, 16, 8
    max_len = 112  # 7 blocks of 16: room for the prompt and the steps
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s + k1), generator=gen, device=dev)
    raw = eng.arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)  # served seed
    weights = {"int8": eng.params, "dense": _bf16_kernels(raw)}
    del raw

    def fwd(params, t, cache, pos=None, **kw):
        cp = None if pos is None else torch.full((b,), pos, device=dev)
        return transformer.forward(params, cfg, tokens=t, cache=cache, cache_pos=cp, **kw)

    def cache_of(quant=False):
        return transformer.init_cache(cfg, b, max_len, dev, cache_quant_int8=quant)

    out = {"phase": "serving_modes", "card": card, "batch": b, "prompt_len": s,
           "verify_rows": b * k1, "verify": {}, "chunk_resume": {}}
    for wname, params in weights.items():
        for quant in (False, True):
            _, cache = fwd(params, toks[:, :s], cache_of(quant))
            seq = {k: v.clone() for k, v in cache.items()}
            window, cache = fwd(params, toks[:, s:], cache, s, decode_chunk=True)
            rows = []
            for i in range(k1):
                lg, seq = fwd(params, toks[:, s + i:s + i + 1], seq, s + i)
                rows.append(lg[:, 0])
            key = f"{wname}_{'int8' if quant else 'bf16'}_kv"
            out["verify"][key] = _held(f"verify {key}", _row_diff(window, torch.stack(rows, 1)))
            if not all(torch.equal(cache[n], seq[n]) for n in cache):
                raise AssertionError(f"serving modes: verify {key}: the caches differ")
        whole_lg, whole = fwd(params, toks[:, :s], cache_of())
        cache, lgs = cache_of(), []
        for c0 in range(0, s, chunk):
            lg, cache = fwd(params, toks[:, c0:c0 + chunk], cache, c0)
            lgs.append(lg)
        diff = _row_diff(torch.cat(lgs, 1), whole_lg)
        diff["cache_equal"] = all(torch.equal(whole[n][:, :, :s], cache[n][:, :, :s])
                                  for n in cache)
        if wname == "int8":
            _held("chunk-resume (int8 weights)", diff)
            if not diff["cache_equal"]:
                raise AssertionError("serving modes: chunk-resume wrote another cache")
        out["chunk_resume"][wname] = {**diff, "held": wname == "int8"}
    del weights["dense"]

    params = eng.params
    mb = max_len // bl
    table = (torch.randperm(b * mb, generator=torch.Generator().manual_seed(6)) + b).reshape(
        b, mb).int().to(dev)
    pool = transformer.init_paged_cache(cfg, b + b * mb, bl, dev)
    dense_lg, dense = fwd(params, toks[:, :s], cache_of(), 0)
    paged_lg, pool = fwd(params, toks[:, :s], pool, 0, block_table=table)
    pairs = [(paged_lg, dense_lg)]
    tok = dense_lg[:, -1].argmax(-1)
    for i in range(steps):
        dense_lg, dense = fwd(params, tok[:, None], dense, s + i)
        paged_lg, pool = fwd(params, tok[:, None], pool, s + i, block_table=table)
        pairs.append((paged_lg, dense_lg))
        tok = dense_lg[:, 0].argmax(-1)
    out["paged_vs_dense"] = _held("paged vs dense", _row_diff(
        torch.cat([p for p, _ in pairs], 1), torch.cat([d for _, d in pairs], 1)))
    out["paged_vs_dense"].update(block_len=bl, blocks=b + b * mb)

    runs = {}
    for quant in (False, True):
        lg, cache = fwd(params, toks[:, :s], cache_of(quant))
        lgs, tok = [lg[:, -1]], (runs[False][1][0] if quant else lg[:, -1].argmax(-1))
        feed = [tok]
        for i in range(steps):
            lg, cache = fwd(params, tok[:, None], cache, s + i)
            lgs.append(lg[:, 0])
            tok = runs[False][1][i + 1] if quant else lg[:, 0].argmax(-1)
            feed.append(tok)
        runs[quant] = (torch.stack(lgs, 1).float(), feed)
    (l16, _), (l8, _) = runs[False], runs[True]
    out["int8_kv_vs_bf16_kv"] = {
        "max_abs_logit_diff": (l8 - l16).abs().max().item(),
        "max_abs_logit": l16.abs().max().item(),
        "greedy_token_agreement": (l8.argmax(-1) == l16.argmax(-1)).float().mean().item(),
        "steps": steps + 1}

    loops = {"scan": eng, "python": eager,
             "while": ServeEngine(eng.arch, params, dataclasses.replace(eng.sc, loop="while"),
                                  device=dev)}
    prompts = toks[:, :s]
    got = {loop: e.generate(prompts, 32) for loop, e in loops.items()}
    if not all(torch.equal(got[loop], got["python"]) for loop in got):
        raise AssertionError("serving modes: the loops gave other greedy tokens")
    out["loops_equal"] = {"loops": list(got), "tokens": int(got["scan"].numel())}
    emit(out)


CONT_MAX_LEN, CONT_BLOCK_LEN = 128, 16
CONT_SMALL_POOL = 10  # blocks of 16 for 4 slots: below the workload's demand


def _int8_routes() -> dict:
    return {name: dict(kn["wrapper"].routes) for name, kn in KERNELS.items()}


def _cont_engine(eng, layout="dense", quant=False, loop="scan", trace=False):
    sc = dataclasses.replace(eng.sc, max_len=CONT_MAX_LEN, kv_layout=layout,
                             block_len=CONT_BLOCK_LEN, loop=loop, trace=trace)
    return ServeEngine(eng.arch, eng.params, sc, device=eng.device, cache_quant_int8=quant)


def _cont_args(n_requests: int, rate: float, segment_len: int):
    return serve.parse_args(MAIN_ARGS + [
        "--workload", "poisson", "--n-requests", str(n_requests), "--rate", str(rate),
        "--segment-len", str(segment_len), "--seed", "0"])


def _slot_captures_once(eng) -> dict:
    """Every slot program captured once per shape: the engine's captures
    by program equal its captured (state, shape) pairs, and nothing ran
    eagerly on the card."""
    graphs: dict[str, int] = {}
    for (_, _, name, *_), _l in eng.slot_graph_launches().items():
        graphs[name] = graphs.get(name, 0) + 1
    caps = {k: eng.trace_counts[k] for k in SLOT_PROGRAMS if eng.trace_counts[k]}
    if caps != graphs or eng.slot_eager_runs:
        raise AssertionError(f"continuous: captures {caps} against graphs {graphs}, "
                             f"{eng.slot_eager_runs} eager runs")
    return caps


def _device_busy(prof) -> tuple[float, int]:
    """The card's busy ms and kernel count in a profiled window, summed
    over the raw device events (``key_averages`` takes minutes over the ~1
    M events of a timed run)."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in evs) / 1e6, len(evs)


def phase_continuous(eng, card: str) -> None:
    """Continuous serving (``serve.scheduler.ContinuousScheduler``) at full
    width, the slot programs replayed from CUDA graphs.

    Bit for bit: 8 requests from ``launch.serve._poisson_draws`` (seed 0,
    prompts 4–64, 4–32 new tokens), all submitted before the first segment,
    n_slots 4, max_len 128, block_len 16; each request's tokens must equal
    its own ``generate`` at B = 1, in every run: segment_len 8 scan and
    while, dense and paged; chunked admission (chunk 32, 4 buckets) dense
    and paged; n_slots 8 (the segment's rows on block_sparse_matmul_int8);
    int8 KV against its own engine's ``generate``; paged with overcommit
    2.0 and a pool of ``CONT_SMALL_POOL`` blocks, recompute and swap, where
    preemption must happen.  Every launch of the int8 pair (bf16 x) on the
    tensor cores; every slot program captured once per shape, none run
    eagerly.

    Timed: 32 requests at 100 requests/s (prompts 4–64, 4–32 new tokens),
    segment_len 16, through ``launch.serve.run_poisson`` (arrivals in real
    time), scan and while × dense and paged: a first run captures, then 3
    timed runs (median, min, max of tok/s, p50/p95 latency and TTFT,
    segments, admit ms per round; no capture allowed), then one run under
    torch.profiler for the card's busy time against its wall time."""
    t_phase = time.perf_counter()
    draws_args = _cont_args(8, 100.0, 8)
    arrivals, p_lens, n_news, prompts = serve._poisson_draws(draws_args, eng.cfg.vocab_size)
    engines = {"dense": _cont_engine(eng), "paged": _cont_engine(eng, "paged"),
               "int8_kv": _cont_engine(eng, quant=True)}

    def oracle(e):
        return [e.generate(torch.from_numpy(p)[None].to(e.device), int(n))[0].tolist()
                for p, n in zip(prompts, n_news)]

    want = {"bf16": oracle(engines["dense"]), "int8_kv": oracle(engines["int8_kv"])}
    runs = [("dense_scan", "dense", dict(segment_mode="scan")),
            ("dense_while", "dense", dict(segment_mode="while")),
            ("paged_scan", "paged", dict(segment_mode="scan")),
            ("paged_while", "paged", dict(segment_mode="while")),
            ("dense_chunked", "dense", dict(prefill_chunk=32, prefill_buckets=4)),
            ("paged_chunked", "paged", dict(prefill_chunk=32, prefill_buckets=4)),
            ("dense_slots8", "dense", dict(n_slots=8)),
            ("int8_kv", "int8_kv", {}),
            ("paged_recompute", "paged", dict(n_blocks=CONT_SMALL_POOL, overcommit=2.0,
                                              preempt_mode="recompute")),
            ("paged_swap", "paged", dict(n_blocks=CONT_SMALL_POOL, overcommit=2.0,
                                         preempt_mode="swap"))]
    out = {"phase": "continuous", "card": card, "requests": len(prompts),
           "prompt_lens": [int(x) for x in p_lens], "new_tokens": [int(x) for x in n_news],
           "max_len": CONT_MAX_LEN, "block_len": CONT_BLOCK_LEN, "bit_for_bit": {}}
    out["oracle_seconds"] = time.perf_counter() - t_phase
    for name, key, kw in runs:
        t_run = time.perf_counter()
        e = engines[key]
        kw = {"n_slots": 4, "segment_len": 8, **kw}
        captures0, seconds0 = dict(e.trace_counts), sum(e.capture_seconds.values())
        routes0 = _int8_routes()
        sched = ContinuousScheduler(e, **kw)
        handles = [sched.submit(p, int(n)) for p, n in zip(prompts, n_news)]
        sched.run()
        torch.cuda.synchronize()
        routes = {k: {r: v - routes0[k].get(r, 0) for r, v in rv.items()}
                  for k, rv in _int8_routes().items()}
        ref = want["int8_kv" if key == "int8_kv" else "bf16"]
        differing = sum(h.tokens != w for h, w in zip(handles, ref))
        line = {"differing_requests": differing, "segments": sched.stats["segments"],
                "captures": {k: v - captures0[k] for k, v in e.trace_counts.items()
                             if v != captures0[k]},
                "capture_seconds": sum(e.capture_seconds.values()) - seconds0,
                "routes": routes, "preemptions": sched.stats["preemptions"],
                "swap_ins": sched.stats["swap_ins"],
                "replayed_tokens": sched.stats["replayed_tokens"],
                "seconds": time.perf_counter() - t_run}
        out["bit_for_bit"][name] = line
        if differing or not all(h.done for h in handles):
            raise AssertionError(f"continuous {name}: {differing} requests differ from "
                                 f"generate at B = 1: {line}")
        if any(rv.get(build.CUDA_CORES, 0) for rv in routes.values()) or not any(
                rv.get(build.TENSOR_CORES, 0) for rv in routes.values()):
            raise AssertionError(f"continuous {name}: routes {routes}, want all bf16 "
                                 f"launches on the tensor cores")
        if "overcommit" in kw and not sched.stats["preemptions"]:
            raise AssertionError(f"continuous {name}: no preemption")
        if kw.get("preempt_mode") == "swap" and not sched.stats["swap_ins"]:
            raise AssertionError(f"continuous {name}: no swap-in")
    out["graphs"] = {key: {"captures": _slot_captures_once(e),
                           "capture_seconds": {k: e.capture_seconds[k] for k in SLOT_PROGRAMS
                                               if e.capture_seconds[k]},
                           "pool_reserved_bytes": e.slot_graph_bytes}
                     for key, e in engines.items()}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    del engines, want

    args = _cont_args(32, 100.0, 16)
    draws = serve._poisson_draws(args, eng.cfg.vocab_size)
    for layout in ("dense", "paged"):
        e = _cont_engine(eng, layout)
        for mode in ("scan", "while"):
            t_config = time.perf_counter()
            args.segment_mode, args.kv_layout = mode, layout
            useful, total, sched, _ = serve.run_poisson(e, args, draws, verbose=False)
            first_tok_s = useful / total
            captured = dict(e.trace_counts)
            timed = []
            for _ in range(3):
                useful, total, sched, handles = serve.run_poisson(e, args, draws, verbose=False)
                timed.append(serve.report_poisson(e, useful, total, sched, handles))
                if sched.stats["admitted"] != sched.stats["retired"] or sched.has_work():
                    raise AssertionError(f"continuous timed {layout} {mode}: not drained")
            if e.trace_counts != captured:
                raise AssertionError(f"continuous timed {layout} {mode}: a repeat captured")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_run = serve.run_poisson(e, args, draws, verbose=False)
            busy_ms, launches = _device_busy(prof)
            wall_ms = statistics.median(1e3 * t["seconds"] for t in timed)
            st = sched.stats
            emit({"phase": "continuous_timed", "card": card, "layout": layout,
                  "segment_mode": mode, "requests": args.n_requests, "rate": args.rate,
                  "segment_len": args.segment_len, "max_len": CONT_MAX_LEN,
                  "tokens": timed[-1]["tokens"],
                  "admitted_retired": [st["admitted"], st["retired"]],
                  "segments": st["segments"], "steps_total": st["steps_total"],
                  "admit_ms_per_round": 1e3 * st["admit_time_s"] / max(st["admit_rounds"], 1),
                  "admit_rounds": st["admit_rounds"],
                  "first_run_tok_s": first_tok_s,
                  "captures_first_run": _slot_captures_once(e),
                  "capture_seconds": sum(e.capture_seconds[k] for k in SLOT_PROGRAMS),
                  "captures_timed_runs": 0,
                  "spread_of_3": {k: _spread([t[k] for t in timed])
                                  for k in timed[0] if k.endswith(("_s", "_ms"))},
                  "wall_ms_median": wall_ms, "profiled_wall_ms": 1e3 * prof_run[1],
                  "device_busy_ms": busy_ms or None,
                  "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
                  "device_kernel_launches": launches,
                  "seconds": time.perf_counter() - t_config})


SPEC_K = 4


def _zero_counts() -> None:
    """Every kernel wrapper's launch and route counters set to 0."""
    for fn in counters.WRAPPERS.values():
        fn.launches = 0
        fn.routes = dict.fromkeys(fn.routes, 0)


def _full_acceptance_hist(news, k: int) -> dict[int, int]:
    """The accepted-length histogram when every draft is accepted: a
    request of n new tokens decodes n − 1 after its prefill's first, in
    (n − 1) // (k + 1) rounds of k + 1 and, where a remainder is left, one
    round of it at its budget's edge (segment and admission boundaries fall
    between rounds, so they split none)."""
    hist: dict[int, int] = {}
    for n in news:
        for size, count in ((k + 1, (int(n) - 1) // (k + 1)), ((int(n) - 1) % (k + 1), 1)):
            if size and count:
                hist[size] = hist.get(size, 0) + count
    return dict(sorted(hist.items()))


def _spec_engine(eng, k: int, draft: str, layout="dense", quant=False, raw=None):
    """A continuous-serving engine (as ``_cont_engine``) that speculates:
    ``raw`` (the served seed's unquantized params) for the self-drafter,
    which prunes them; the truncated drafters slice the served tree."""
    spec = SpecConfig(k=k, draft=draft, draft_sparsity=0.75)
    sc = dataclasses.replace(eng.sc, max_len=CONT_MAX_LEN, kv_layout=layout,
                             block_len=CONT_BLOCK_LEN, loop="scan", spec=spec)
    return ServeEngine(eng.arch, raw if raw is not None else eng.params, sc,
                       device=eng.device, cache_quant_int8=quant)


def _spec_round_launches(e) -> dict:
    """What one replay of each captured spec program (one round) launches."""
    return {name: _counts(launches) for (_, _, name, *_), launches
            in e.slot_graph_launches().items() if name.startswith("slot_spec")}


def _draft_step_timing(e) -> dict:
    """One draft step's block-sparse projections of the self-drafter (22
    layers × 7; its LM head is the dense raw one, as the reference's) at
    M = n_slots = 4, bf16 x (N(0, 1), the scale of an RMS-normed
    activation) and values: each projection's kernel output held to its
    plain version within ``TOL``; then the times of the kernel, the plain
    version, x @ the densified bf16 weight, and the bound (bytes: kept bf16
    values + int32 indices + x (bf16) + y (fp32); operations: 2·M·kept
    weights)."""
    cfg, m = e.cfg, 4
    weights = []
    for i in range(cfg.n_layers):
        for blk, proj in PROJECTIONS:
            leaf = e.draft_params["layers"][blk][proj]
            k = cfg.d_ff if (blk, proj) == ("ffn", "wo") else cfg.d_model
            weights.append((k, leaf["bsvalues"][i], leaf["bsindices"][i]))
    dense = [BlockSparseWeight(v, ix, k // v.shape[2]).dense(torch.bfloat16)
             for k, v, ix in weights]
    xs = {k: torch.randn((m, k), device=e.device, dtype=torch.bfloat16)
          for k in (cfg.d_model, cfg.d_ff)}
    n_bytes = n_ops = bound_s = 0.0
    for k, v, ix in weights:
        b = 2 * v.numel() + 4 * ix.numel() + 2 * m * k + 4 * m * v.shape[0] * v.shape[3]
        ops = 2.0 * m * v.numel()
        n_bytes, n_ops = n_bytes + b, n_ops + ops
        bound_s += max(b / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS)

    def run(fn):
        return lambda: [fn(xs[k], v, ix) for k, v, ix in weights]

    wrapper = bs_kernel.block_sparse_matmul_kernel
    before = wrapper.routes.get(build.TENSOR_CORES, 0)
    err = 0.0
    for k, v, ix in weights:
        got, want = wrapper(xs[k], v, ix), bs_kernel.block_sparse_matmul_plain(xs[k], v, ix)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        err = max(err, (got - want).abs().max().item())
    out = {"rows": m, "launches_per_step": len(weights), "values": "bfloat16",
           "sparsity": 0.75, "kept_value_bytes": sum(2 * v.numel() for _, v, _ in weights),
           "checked_against_plain": len(weights), "tolerance": TOL, "max_abs_err": err,
           "ms": _step_ms(run(wrapper)),
           "plain_ms": _step_ms(run(bs_kernel.block_sparse_matmul_plain)),
           "bound_ms": bound_s * 1e3,
           "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / BF16_TENSOR_FLOPS
           else "operations",
           "library_ms": _step_ms(lambda: [xs[k] @ d for (k, *_), d in zip(weights, dense)])}
    if wrapper.routes.get(build.TENSOR_CORES, 0) == before:
        raise AssertionError("speculative: the draft step's timed launches took no tensor core")
    return out


def phase_speculative(eng, card: str) -> dict:
    """Speculative decoding through ``ContinuousScheduler`` at full width,
    each spec program one CUDA graph of one round per geometry, replayed.

    Bit for bit: ``phase_continuous``'s 8 seed-0 requests at n_slots 4,
    segment_len 8, max_len 128, block_len 16, each equal to its own
    ``generate`` at B = 1, under k = 4 drafters ``truncate:1`` (scan and
    while × dense and paged), ``self`` at sparsity 0.75 (block_sparse_matmul
    on bf16 values) and ``truncate:22`` (the whole model: every round but a
    budget's last emits k + 1; also at k = 16, the decode queries padded to
    32 rows), and k = 2 ``truncate:1`` with int8 KV,
    paged with overcommit 2.0 on ``CONT_SMALL_POOL`` blocks (recompute,
    preemption must happen) and chunked admission.  The counters zeroed
    just before each run and read just after: the int8 pair launched in
    every run, block_sparse_matmul in the self-drafter's, every bf16
    launch on the tensor cores; each spec program captured once per
    geometry, none run eagerly.

    Then block_sparse_matmul's time for one draft step of the self-drafter,
    and, timed: 32 requests at 100 requests/s through
    ``launch.serve.run_poisson``, dense while, plain and the three k = 4
    drafters on the same draws: a first run captures, 3 timed runs (median,
    min, max), one under torch.profiler for the card's busy time.
    Returns what the kernels line adds to the three kernels' entries."""
    t_phase = time.perf_counter()
    dev = eng.device
    arrivals, p_lens, n_news, prompts = serve._poisson_draws(_cont_args(8, 100.0, 8),
                                                              eng.cfg.vocab_size)
    raw = eng.arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)  # served seed
    full = f"truncate:{eng.cfg.n_layers}"  # a drafter of the whole model
    engines = {"truncate1_dense": _spec_engine(eng, SPEC_K, "truncate:1"),
               "truncate1_paged": _spec_engine(eng, SPEC_K, "truncate:1", "paged"),
               "self075_dense": _spec_engine(eng, SPEC_K, "self", raw=raw),
               "truncate22_dense": _spec_engine(eng, SPEC_K, full),
               "k16_truncate22_dense": _spec_engine(eng, 16, full),
               "k2_int8_kv": _spec_engine(eng, 2, "truncate:1", quant=True),
               "k2_paged": _spec_engine(eng, 2, "truncate:1", "paged"),
               "k2_dense": _spec_engine(eng, 2, "truncate:1")}
    del raw
    oracles = {"bf16": _cont_engine(eng), "int8_kv": _cont_engine(eng, quant=True)}
    want = {key: [o.generate(torch.from_numpy(p)[None].to(dev), int(n))[0].tolist()
                  for p, n in zip(prompts, n_news)] for key, o in oracles.items()}
    del oracles
    runs = [("truncate1_dense_scan", "truncate1_dense", dict(segment_mode="scan")),
            ("truncate1_dense_while", "truncate1_dense", dict(segment_mode="while")),
            ("truncate1_paged_scan", "truncate1_paged", dict(segment_mode="scan")),
            ("truncate1_paged_while", "truncate1_paged", dict(segment_mode="while")),
            ("self075_dense_while", "self075_dense", dict(segment_mode="while")),
            ("truncate22_dense_while", "truncate22_dense", dict(segment_mode="while")),
            ("k16_truncate22_dense_while", "k16_truncate22_dense",
             dict(segment_mode="while")),
            ("k2_int8_kv", "k2_int8_kv", {}),
            ("k2_paged_recompute", "k2_paged", dict(n_blocks=CONT_SMALL_POOL, overcommit=2.0,
                                                     preempt_mode="recompute")),
            ("k2_dense_chunked", "k2_dense", dict(prefill_chunk=32, prefill_buckets=4))]
    out = {"phase": "speculative", "card": card, "requests": len(prompts),
           "max_len": CONT_MAX_LEN, "block_len": CONT_BLOCK_LEN, "bit_for_bit": {}}
    for name, key, kw in runs:
        t_run = time.perf_counter()
        e = engines[key]
        kw = {"n_slots": 4, "segment_len": 8, **kw}
        captures0, seconds0 = dict(e.trace_counts), sum(e.capture_seconds.values())
        sched = ContinuousScheduler(e, **kw)
        handles = [sched.submit(p, int(n)) for p, n in zip(prompts, n_news)]
        _zero_counts()
        sched.run()
        torch.cuda.synchronize()
        counts = counters.snapshot()
        st = sched.stats
        ref = want["int8_kv" if key == "k2_int8_kv" else "bf16"]
        differing = sum(h.tokens != w for h, w in zip(handles, ref))
        hist = {int(n): c for n, c in sorted(st["accepted_hist"].items())}
        line = {"k": e.spec.k, "draft": e.spec.draft, "differing_requests": differing,
                "segments": st["segments"], "spec_steps": st["spec_steps"],
                "accepted_hist": hist,
                "accepted_per_round": st["spec_emitted"] / max(st["spec_steps"], 1),
                "steps_predicated": st["steps_predicated"],
                "launches": {n: c for n, (c, _) in counts.items() if c},
                "routes": {n: r for n, (c, r) in counts.items() if c},
                "captures": {k: v - captures0[k] for k, v in e.trace_counts.items()
                             if v != captures0[k]},
                "capture_seconds": sum(e.capture_seconds.values()) - seconds0,
                "preemptions": st["preemptions"], "seconds": time.perf_counter() - t_run}
        out["bit_for_bit"][name] = line
        if differing or not all(h.done for h in handles):
            raise AssertionError(f"speculative {name}: {differing} requests differ from "
                                 f"generate at B = 1: {line}")
        need = [INT8_MATVEC, INT8_MATMUL] + (["block_sparse_matmul"] if "self" in key else [])
        if any(counts[n][0] == 0 for n in need):
            raise AssertionError(f"speculative {name}: launches {line['launches']}, want "
                                 f"{need} each launched")
        if any(r.get(build.CUDA_CORES, 0) for n, r in line["routes"].items()
               if n in need) or not st["spec_steps"]:
            raise AssertionError(f"speculative {name}: routes {line['routes']}, want every "
                                 f"bf16 launch on the tensor cores")
        if "overcommit" in kw and not st["preemptions"]:
            raise AssertionError(f"speculative {name}: no preemption")
        if e.spec.draft == full and hist != _full_acceptance_hist(n_news, e.spec.k):
            raise AssertionError(f"speculative {name}: the full-depth drafter had drafts "
                                 f"rejected: {hist}, want "
                                 f"{_full_acceptance_hist(n_news, e.spec.k)}")
    out["graphs"] = {key: {"captures": _slot_captures_once(e),
                           "capture_seconds": {k: e.capture_seconds[k] for k in SLOT_PROGRAMS
                                               if e.capture_seconds[k]},
                           "pool_reserved_bytes": e.slot_graph_bytes,
                           "pool_reserved_bytes_by_program": {
                               k: v for k, v in e.slot_graph_bytes_by_program.items() if v},
                           "launches_per_round": _spec_round_launches(e)}
                     for key, e in engines.items()}
    for key, g in out["graphs"].items():
        spec_caps = {k: v for k, v in g["captures"].items() if k.startswith("slot_spec")}
        if any(v != 1 for v in spec_caps.values()) or not spec_caps:
            raise AssertionError(f"speculative {key}: spec captures {spec_caps}, want one "
                                 f"per program")
    draft_step = _draft_step_timing(engines["self075_dense"])
    out["draft_step_block_sparse_matmul"] = draft_step
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    # launches of one k = 4 round (a replay of the while program), by drafter
    per_round = {engines[key].spec.draft: out["graphs"][key]["launches_per_round"][
        "slot_spec_segment_while"] for key in ("truncate1_dense", "self075_dense",
                                               "truncate22_dense")}
    extras = {name: {"spec_launches_per_round": {d: r.get(name, 0)
                                                 for d, r in per_round.items()}}
              for name in ("block_sparse_matmul", INT8_MATVEC, INT8_MATMUL)}
    extras["block_sparse_matmul"]["spec_draft_step"] = draft_step
    for key in ("k2_int8_kv", "k2_paged", "k2_dense", "truncate1_paged", "truncate22_dense",
                "k16_truncate22_dense"):
        del engines[key]

    args = _cont_args(32, 100.0, 16)
    args.segment_mode, args.kv_layout = "while", "dense"
    draws = serve._poisson_draws(args, eng.cfg.vocab_size)
    timed_engines = {"plain": _cont_engine(eng), "truncate1": engines["truncate1_dense"],
                     "self075": engines["self075_dense"],
                     "truncate22": _spec_engine(eng, SPEC_K, full)}
    del engines
    for name, e in timed_engines.items():
        t_config = time.perf_counter()
        useful, total, sched, _ = serve.run_poisson(e, args, draws, verbose=False)
        first_tok_s = useful / total
        captured = dict(e.trace_counts)
        timed = []
        for _ in range(3):
            useful, total, sched, handles = serve.run_poisson(e, args, draws, verbose=False)
            timed.append(serve.report_poisson(e, useful, total, sched, handles))
            if sched.stats["admitted"] != sched.stats["retired"] or sched.has_work():
                raise AssertionError(f"speculative timed {name}: not drained")
        if e.trace_counts != captured:
            raise AssertionError(f"speculative timed {name}: a repeat captured")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_run = serve.run_poisson(e, args, draws, verbose=False)
        busy_ms, launches = _device_busy(prof)
        wall_ms = statistics.median(1e3 * t["seconds"] for t in timed)
        st = sched.stats
        if name == "truncate22" and st["accepted_hist"] != _full_acceptance_hist(draws[2],
                                                                                 SPEC_K):
            raise AssertionError(f"speculative timed {name}: drafts rejected: "
                                 f"{st['accepted_hist']}")
        emit({"phase": "speculative_timed", "card": card, "drafter": name,
              "draft": e.spec.draft if e.spec is not None else None,
              "k": e.spec.k if e.spec is not None else 0, "layout": "dense",
              "segment_mode": "while", "requests": args.n_requests, "rate": args.rate,
              "segment_len": args.segment_len, "max_len": CONT_MAX_LEN,
              "tokens": timed[-1]["tokens"],
              "admitted_retired": [st["admitted"], st["retired"]],
              "segments": st["segments"], "steps_total": st["steps_total"],
              "accepted_per_round": timed[-1].get("accepted_per_round"),
              "accepted_hist": {int(n): c for n, c in sorted(st["accepted_hist"].items())},
              "steps_predicated": st["steps_predicated"],
              "first_run_tok_s": first_tok_s,
              "captures": _slot_captures_once(e),
              "capture_seconds": {k: e.capture_seconds[k] for k in SLOT_PROGRAMS
                                  if e.capture_seconds[k]},
              "pool_reserved_bytes": e.slot_graph_bytes,
              "pool_reserved_bytes_by_program": {
                  k: v for k, v in e.slot_graph_bytes_by_program.items() if v},
              "spread_of_3": {k: _spread([t[k] for t in timed])
                              for k in timed[0] if k.endswith(("_s", "_ms"))},
              "wall_ms_median": wall_ms, "profiled_wall_ms": 1e3 * prof_run[1],
              "device_busy_ms": busy_ms or None,
              "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
              "device_kernel_launches": launches,
              "seconds": time.perf_counter() - t_config})
    return extras


HTTP_REQUESTS = 16
HTTP_TENANTS = {"acme": 3.0, "hobby": 1.0}
HTTP_TTFT_DEADLINE_S = 5.0  # the interactive class's, which the SLO controller steers by
HTTP_WAIT_S = 180.0  # the longest any step of the phase may wait: a hang fails the run


def _http_sched(e) -> ContinuousScheduler:
    """The front door's scheduler: tenants acme:3 and hobby:1, the default
    priority classes (interactive given a TTFT deadline, which the SLO
    controller needs) and the default ``SloConfig``; n_slots 4, while
    segments of 8."""
    classes = (dataclasses.replace(DEFAULT_CLASSES[0], ttft_deadline_s=HTTP_TTFT_DEADLINE_S),
               *DEFAULT_CLASSES[1:])
    policy = TenantPolicy(tenants={t: TenantSpec(weight=w) for t, w in HTTP_TENANTS.items()},
                          classes=classes, slo=SloConfig())
    return ContinuousScheduler(e, n_slots=4, segment_len=8, segment_mode="while",
                               policy=policy)


def _http_payloads(prompts, news) -> list[dict]:
    """One payload per request: tenants round-robin, every fourth request
    interactive (the others the tenants' default, standard)."""
    tenants = list(HTTP_TENANTS)
    return [{"prompt": [int(t) for t in p], "max_new_tokens": int(n),
             "tenant": tenants[i % len(tenants)],
             **({"priority": "interactive"} if i % 4 == 0 else {})}
            for i, (p, n) in enumerate(zip(prompts, news))]


async def _http_stream(port: int, payload: dict) -> dict:
    """One SSE client (the port's helpers): status, streamed tokens, the
    terminal event's body, heartbeats seen, TTFT and latency (client wall
    clock), and the Retry-After a 429 carried."""
    t0 = time.perf_counter()
    reader, writer, status, headers = await http.open_generate("127.0.0.1", port, payload)
    out = {"status": status, "tokens": [], "heartbeats": 0, "body": None, "ttft_s": None,
           "retry_after": headers.get("retry-after")}
    try:
        if status != 200:
            n = int(headers.get("content-length", "0") or 0)
            out["body"] = json.loads(await reader.readexactly(n)) if n else None
            return out
        while True:
            ev = await http.read_sse_event(reader)
            if ev is None:
                break
            kind = ev.get("event")
            if kind == "token":
                out["tokens"].append(ev["data"]["token"])
                if out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
            elif kind == "heartbeat":
                out["heartbeats"] += 1
            elif kind in ("done", "error"):
                out["body"] = ev["data"] if kind == "done" else {"error": ev["data"]}
                break
    finally:
        out["t_end"] = time.perf_counter()
        out["latency_s"] = out["t_end"] - t0
        writer.close()
    return out


def _clean(outs: list[dict], payloads: list[dict], want: list[list[int]], what: str) -> None:
    """Every stream ended in ``done`` with finish "length", its streamed
    tokens its final list, and that list ``generate``'s."""
    for i, (o, p, w) in enumerate(zip(outs, payloads, want)):
        body = o["body"] or {}
        if not (o["status"] == 200 and body.get("finish_reason") == "length"
                and o["tokens"] == body.get("tokens") == w):
            raise AssertionError(f"http {what}: request {i} ({p['tenant']}) status "
                                 f"{o['status']} finish {body.get('finish_reason')}, "
                                 f"{sum(a != b for a, b in zip(o['tokens'], w))} tokens of "
                                 f"{len(w)} differ from generate")


def _pcts(values: list[float]) -> dict:
    xs = sorted(values)
    return {"p50": statistics.median(xs), "p95": xs[min(len(xs) - 1, int(0.95 * len(xs)))]}


def _trace_by_phase(events) -> dict:
    out: dict[str, dict] = {}
    for e in events:
        row = out.setdefault(e.phase, {"launches": 0, "tokens": 0, "flops": 0.0,
                                       "hbm_bytes": 0.0})
        row["launches"] += 1
        row["tokens"] += e.tokens
        row["flops"] += e.flops
        row["hbm_bytes"] += e.hbm_bytes
    return out


async def _http_session(sched, payloads, want, seg_s: float, probe: bool) -> dict:
    """A front door on 127.0.0.1, port 0, over ``sched``: the 16 concurrent
    clients, and with ``probe`` the disconnect, the burst over max_pending
    and the graceful drain; returns what was measured.  ``seg_s``: one
    segment's wall on this card, half of which is the heartbeat."""
    fd = http.FrontDoor(sched, http.HttpConfig(heartbeat_s=seg_s / 2, drain_timeout_s=120.0))
    await fd.start()
    out: dict = {"heartbeat_s": seg_s / 2}
    stopped = False
    try:
        async def clients(what: str) -> tuple[list[dict], float]:
            """The 16 clients at once → their outcomes (held clean) and their
            wall (from their own clocks, so without a profiler's start and
            stop)."""
            t0 = time.perf_counter()
            got = await asyncio.wait_for(asyncio.gather(
                *[_http_stream(fd.port, p) for p in payloads]), HTTP_WAIT_S)
            _clean(got, payloads, want, what)
            return got, max(o["t_end"] for o in got) - t0

        _zero_counts()
        out["outs"], out["wall_s"] = await clients("concurrent clients")
        out["counts"] = counters.snapshot()
        if not probe:
            return out
        # the same again under torch.profiler (which slows the host): the
        # card's busy time against that run's wall and the trace's pricing
        n_events = len(sched.trace.events)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, out["profiled_wall_s"] = await clients("profiled clients")
        out["device_busy_ms"], out["device_kernel_launches"] = _device_busy(prof)
        out["trace_by_phase"] = _trace_by_phase(sched.trace.events[n_events:])
        # a client that vanishes mid-stream: its slot and blocks come back
        # at the next segment boundary
        short = min(range(len(payloads)), key=lambda i: len(payloads[i]["prompt"]))
        long = {**payloads[short], "max_new_tokens": CONT_MAX_LEN - len(payloads[short]["prompt"])}
        cancelled0 = sched.stats["cancelled"]
        reader, writer, status, _ = await http.open_generate("127.0.0.1", fd.port, long)
        got = 0
        while got < 2:
            ev = await asyncio.wait_for(http.read_sse_event(reader), HTTP_WAIT_S)
            if ev is None:
                raise AssertionError("http disconnect: the stream ended early")
            got += ev.get("event") == "token"
        seg0 = sched.stats["segments"]
        writer.close()
        deadline = time.perf_counter() + HTTP_WAIT_S
        while sched.stats["cancelled"] == cancelled0 or any(sched.slots):
            if time.perf_counter() > deadline:
                raise AssertionError(f"http disconnect: not reclaimed: {sched.stats}")
            await asyncio.sleep(0.001)
        out["disconnect"] = {"status": status, "segments_to_reclaim":
                             sched.stats["segments"] - seg0,
                             "blocks_reclaimed": sched.stats["blocks_reclaimed_cancel"],
                             "free_blocks": [sched.allocator.n_free, sched.allocator.capacity]}
        if (out["disconnect"]["segments_to_reclaim"] > 2 or not sched.stats[
                "blocks_reclaimed_cancel"] or sched.allocator.n_free != sched.allocator.capacity):
            raise AssertionError(f"http disconnect: {out['disconnect']}")
        # a burst over max_pending: 429 + Retry-After before admission; the
        # worker's drain prediction (what a Retry-After then carries, above
        # its 1 s floor), first made after the burst's first segment,
        # against the time the accepted streams then take to finish
        fd.cfg.max_pending = 2
        rid0 = sched._next_rid
        predicted: dict = {}
        clients = asyncio.ensure_future(asyncio.gather(
            *[_http_stream(fd.port, p) for p in payloads[:12]]))
        deadline = time.perf_counter() + HTTP_WAIT_S
        while not clients.done():
            if time.perf_counter() > deadline:
                raise AssertionError("http burst: the clients did not finish")
            if not predicted and fd.worker._drain_s is not None:
                predicted.update(drain_s=fd.worker._drain_s, t=time.perf_counter())
            await asyncio.sleep(0.0005)
        burst = clients.result()
        fd.cfg.max_pending = http.HttpConfig().max_pending
        ok = [i for i, o in enumerate(burst) if o["status"] == 200]
        rejected = [o for o in burst if o["status"] == 429]
        _clean([burst[i] for i in ok], [payloads[i] for i in ok], [want[i] for i in ok],
               "burst")
        if not rejected or sched._next_rid - rid0 != len(ok) or any(
                int(o["retry_after"]) < 1 or o["body"]["retry_after_s"] <= 0 for o in rejected):
            raise AssertionError(f"http burst: {len(rejected)} rejected of 12, "
                                 f"{sched._next_rid - rid0} admitted, "
                                 f"{[o['body'] for o in rejected]}")
        out["burst"] = {"clients": 12, "max_pending": 2, "accepted": len(ok),
                        "rejected_429": len(rejected),
                        "retry_after_header_s": sorted({int(o["retry_after"])
                                                        for o in rejected}),
                        "retry_after_s": [o["body"]["retry_after_s"] for o in rejected],
                        "predicted_drain_s": predicted.get("drain_s"),
                        "measured_drain_s": (max(burst[i]["t_end"] for i in ok)
                                             - predicted["t"]) if predicted else None}
        # graceful drain: stop with streams in flight; every one completes
        admitted0 = sched.stats["admitted"]
        tasks = [asyncio.ensure_future(_http_stream(fd.port, p)) for p in payloads[12:]]
        deadline = time.perf_counter() + HTTP_WAIT_S
        while sched.stats["admitted"] == admitted0:
            if time.perf_counter() > deadline:
                raise AssertionError("http drain: nothing admitted")
            await asyncio.sleep(0.001)
        await fd.stop()
        stopped = True
        drained = await asyncio.wait_for(asyncio.gather(*tasks), HTTP_WAIT_S)
        _clean(drained, payloads[12:], want[12:], "drain")
        if fd.worker.is_alive() or fd.worker.error is not None:
            raise AssertionError(f"http drain: worker alive or failed: {fd.worker.error}")
        out["drain"] = {"in_flight": len(tasks), "completed": len(drained)}
        out["stats"] = fd.stats
        return out
    finally:
        if not stopped:
            await fd.stop()
        if fd.worker is not None and fd.worker.error is not None:
            raise AssertionError(f"http: the scheduler worker failed: {fd.worker.error!r}")


def phase_http(eng, card: str) -> dict:
    """The serving front door (``serve.http.FrontDoor``) at full width: the
    served int8 weights, paged KV (block_len 16), n_slots 4, the trace on,
    tenants acme:3 and hobby:1 under the default priority classes and an
    ``SloConfig``, on 127.0.0.1 port 0 in this process; the scheduler runs
    on the front door's worker thread, its slot programs CUDA graphs.

    16 requests from ``launch.serve._poisson_draws`` (seed 0, prompts 4–64,
    4–32 new tokens), every fourth interactive, each request's tokens
    ``generate``'s at B = 1 on the same engine.  First the offline
    scheduler on the main thread (its graphs captured there, then a second
    run timed), then the same requests as 16 concurrent SSE clients
    through the front door, the worker replaying those graphs: every
    stream ends in ``done`` with its streamed tokens its final list,
    heartbeats sent while segments run (``heartbeat_s`` half a segment's
    wall), the counters zeroed just before and read just after
    (the int8 pair launched, on the tensor cores); then the 16 again under
    torch.profiler for the card's busy time against their wall and the
    trace's priced work.  Then a client that
    disconnects mid-stream (its slot and blocks back within a segment), a
    burst of 12 over ``max_pending`` 2 (429 + Retry-After before admission;
    the drain predictor's prediction against the measured drain), and a
    graceful stop with 4 streams in flight (all complete).  Last, a fresh
    engine whose graphs the worker captures: the 16 clients again, then
    the offline scheduler on the main thread replaying them.  No slot
    program runs eagerly."""
    t_phase = time.perf_counter()
    args = _cont_args(HTTP_REQUESTS, 100.0, 8)
    _, p_lens, n_news, prompts = serve._poisson_draws(args, eng.cfg.vocab_size)
    payloads = _http_payloads(prompts, n_news)
    e = _cont_engine(eng, "paged", trace=True)
    want = [e.generate(torch.from_numpy(p)[None].to(e.device), int(n))[0].tolist()
            for p, n in zip(prompts, n_news)]

    def offline(engine):
        sched = _http_sched(engine)
        t0 = time.perf_counter()
        handles = [sched.submit(p["prompt"], p["max_new_tokens"], tenant=p["tenant"],
                                priority=p.get("priority")) for p in payloads]
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [h.tokens for h in handles]
        if got != want or not all(h.done for h in handles):
            raise AssertionError(f"http offline: {sum(g != w for g, w in zip(got, want))} "
                                 f"requests differ from generate")
        return sched, handles, wall

    offline(e)  # captures the graphs on the main thread
    off_sched, off_handles, off_wall = offline(e)  # timed, replaying them
    seg_s = off_wall / off_sched.stats["segments"]
    captured = dict(e.trace_counts)
    sched = _http_sched(e)
    a = asyncio.run(_http_session(sched, payloads, want, seg_s, probe=True))
    counts = a.pop("counts")
    launched = {n: c for n, (c, _) in counts.items() if c}
    routes = {n: r for n, (c, r) in counts.items() if c}
    if any(launched.get(n, 0) == 0 for n in KERNELS) or any(
            r.get(build.CUDA_CORES, 0) for r in routes.values()):
        raise AssertionError(f"http: launches {launched}, routes {routes}, want the int8 pair "
                             f"launched, every launch on the tensor cores")
    if sum(o["heartbeats"] for o in a["outs"]) == 0:
        raise AssertionError("http: no heartbeat while segments ran")
    tokens = sum(len(o["tokens"]) for o in a["outs"])
    tr = sched.trace
    energy = trace_energy(tr, e.cfg, weight_sparsity=serve.TRACE_WEIGHT_SPARSITY,
                          act_sparsity=serve.TRACE_ACT_SPARSITY, platforms=("SONIC",))
    by_phase = a["trace_by_phase"]
    busy_ms = a.get("device_busy_ms") or None
    brownout = [(ev.segment, ev.steps) for ev in tr.events if ev.phase == "brownout"]
    out = {"phase": "http", "card": card, "requests": HTTP_REQUESTS,
           "prompt_lens": [int(x) for x in p_lens], "new_tokens": [int(x) for x in n_news],
           "tenants": HTTP_TENANTS, "n_slots": 4, "kv_layout": "paged",
           "block_len": CONT_BLOCK_LEN, "max_len": CONT_MAX_LEN, "segment_len": 8,
           "heartbeat_s": a["heartbeat_s"],
           "http": {"tok_s": tokens / a["wall_s"], "wall_s": a["wall_s"], "tokens": tokens,
                    "ttft_s": _pcts([o["ttft_s"] for o in a["outs"]]),
                    "latency_s": _pcts([o["latency_s"] for o in a["outs"]]),
                    "heartbeats": sum(o["heartbeats"] for o in a["outs"])},
           "offline": {"tok_s": sum(len(h.tokens) for h in off_handles) / off_wall,
                       "wall_s": off_wall,
                       "ttft_s": _pcts([h.ttft for h in off_handles]),
                       "latency_s": _pcts([h.latency for h in off_handles]),
                       "segment_ms": 1e3 * seg_s},
           "launches": launched, "routes": routes,
           "admitted_by_tenant": {t: r["admitted"] for t, r in
                                  sched.policy.snapshot().items()},
           "served_tokens_by_tenant": {t: r["served_tokens"] for t, r in
                                       sched.policy.snapshot().items()},
           "brownout_trajectory": brownout, "brownout_level": sched.policy.brownout_level,
           "slo": sched.policy.slo_snapshot(),
           "trace_concurrent_clients": {
               "by_phase": by_phase,
               "flops": sum(r["flops"] for r in by_phase.values()),
               "hbm_bytes": sum(r["hbm_bytes"] for r in by_phase.values()),
               "analytic_s_at_peak": max(
                   sum(r["flops"] for r in by_phase.values()) / BF16_TENSOR_FLOPS,
                   sum(r["hbm_bytes"] for r in by_phase.values()) / HBM_BYTES_PER_S),
               "device_busy_ms": busy_ms, "profiled_wall_s": a["profiled_wall_s"],
               "device_idle_share": (1 - busy_ms / (1e3 * a["profiled_wall_s"])
                                     if busy_ms else None),
               "device_kernel_launches": a.get("device_kernel_launches"),
               "note": "the trace's priced FLOPs and bytes (analytic model) beside the "
                       "card's measured busy time: a model-versus-card comparison"},
           "trace_totals_session": tr.summary(),
           "photonic_j_per_token": {
               "SONIC": energy["platforms"]["SONIC"]["j_per_token"],
               "source": PHOTONIC},
           "disconnect": a["disconnect"], "burst": a["burst"], "drain": a["drain"],
           "front_door": a["stats"]}
    if e.trace_counts != captured:
        raise AssertionError(f"http: the front door captured what the offline run had: "
                             f"{captured} -> {e.trace_counts}")
    # the other order: a fresh engine whose graphs the worker captures, the
    # main thread replaying them after
    e2 = _cont_engine(eng, "paged", trace=True)
    b = asyncio.run(_http_session(_http_sched(e2), payloads, want, seg_s, probe=False))
    captured2 = dict(e2.trace_counts)
    offline(e2)
    if e2.trace_counts != captured2:
        raise AssertionError("http: the offline run after the worker's captures captured")
    out["worker_captures"] = {"captures": _slot_captures_once(e2),
                              "capture_seconds": sum(e2.capture_seconds[k]
                                                     for k in SLOT_PROGRAMS),
                              "tok_s_first_run": sum(len(o["tokens"]) for o in b["outs"])
                              / b["wall_s"]}
    out["graphs"] = {"captures": _slot_captures_once(e), "eager_runs": e.slot_eager_runs
                     + e2.slot_eager_runs}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _reset_routes() -> None:
    for name in ROUTED:
        LAYER_KERNELS[name]["wrapper"].routes = dict.fromkeys(build.ROUTES, 0)


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
    _reset_routes()
    good = 0
    for mode, sc in configs.items():
        for s in (1, 64):
            for p in converted[mode]:
                y = sonic_linear_apply(p, xs[(s, _weight(p, mode)[1])], sc)
                good += y.shape[:2] == (4, s) and y.dtype == torch.bfloat16
    torch.cuda.synchronize()
    launches = {name: kn["wrapper"].launches for name, kn in LAYER_KERNELS.items()}
    routes = {name: dict(LAYER_KERNELS[name]["wrapper"].routes) for name in ROUTED}
    want = {"sonic_matvec": n, "sonic_matmul": n, "block_sparse_matmul": 2 * n,
            "clustered_matmul": 2 * n}
    if launches != want or good != 2 * n * len(configs):
        raise AssertionError(f"layer path: launches {launches}, want {want}; "
                             f"{good} well-shaped outputs")
    # bf16 x: every launch of the three routed matmuls on the tensor cores
    if any(routes[name] != {build.TENSOR_CORES: want[name], build.CUDA_CORES: 0}
           for name in ROUTED):
        raise AssertionError(f"layer path: routes {routes}, want all on the tensor cores")
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
          "convert_seconds_first_second": seconds, "launches": launches, "routes": routes,
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

            def run(fn, subset=weights):
                return lambda: [fn(xs[k], *args) for k, args in subset]

            if name in ROUTED:
                kn["wrapper"].routes = dict.fromkeys(build.ROUTES, 0)
            row = {"rows": m, "ms": _step_ms(run(kn["wrapper"])),
                   "plain_ms": _step_ms(run(kn["plain"])), "bound_ms": bound_s * 1e3,
                   "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / BF16_TENSOR_FLOPS
                   else "operations",
                   "library_ms": _step_ms(
                       lambda: [xs[k] @ d for (k, _), d in zip(weights, dense[mode])])}
            timing = {}
            if name in ROUTED:
                # three bf16 products per fp32 weight set the tensor-core
                # route's floor (one per bf16 value)
                shapes = {}
                for (k, args), d in zip(weights, dense[mode]):
                    shapes.setdefault(f"{k}x{d.shape[1]}", []).append((k, args))
                timing = {**_route_timing(name, m, kn["wrapper"], n_ops, n_bytes, row["ms"],
                                          shapes, lambda sub: _step_ms(run(kn["wrapper"], sub))),
                          "three_product_floor_ms": 3 * n_ops / BF16_TENSOR_FLOPS * 1e3}
                if name in DECODE_ENTRY:
                    timing.update(_split1_timing(shapes, lambda sub: _step_ms(lambda: [
                        build.launch_codebook(DECODE_ENTRY[name], xs[k], *args, split=1)
                        for k, args in sub])))
            # the same launches issued one by one from Python (host clock)
            eager_ms = _seconds(run(kn["wrapper"]), 5) * 1e3
            emit({"phase": "kernel_time", "name": name, "launches_per_step": len(weights),
                  "weight_bytes": sum(args[0].numel() * args[0].element_size()
                                      for _, args in weights), **row, **timing,
                  "eager_ms": eager_ms})
            if entry is None:
                entry = {"name": name, "route": "cuda", "source": kn["source"],
                         "replaces": kn["replaces"], "launches": launches[name],
                         "max_abs_err": errs[name], **row}
            else:
                entry[f"rows_{m}"] = row
        out.append(entry)
    return out


def _c3_case(b: int, k: int, n: int, knz: int, xdtype, wdtype, gen, dev):
    """x_nz (b, knz), ascending distinct idx (knz,) int32 in [0, k), Wt (k, n)."""
    wt = torch.randn((k, n), generator=gen, device=dev) * k**-0.5
    idx = torch.randperm(k, generator=gen, device=dev)[:knz].sort().values.int()
    x = torch.randn((b, knz), generator=gen, device=dev)
    return x.to(xdtype), idx, wt.to(wdtype)


def phase_c3_kernel(dev: torch.device) -> float:
    """sparse_matvec against its plain version; returns the largest error at
    the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(5)
    types = [(a, b) for a in (torch.float32, torch.bfloat16) for b in (torch.float32, torch.bfloat16)]
    cases = [(b, k, n, round(TOPK_FRAC * k), True) for k, n in MAIN_SHAPES for b in (1, 4, 7)]
    cases += [(b, 50, n, knz, False) for knz in (0, 1, 7) for n in (1, 96, 130)
              for b in (1, 4, 7, 256)]
    err, n_checks = 0.0, 0
    smv_kernel.sparse_matvec_kernel.routes = dict.fromkeys(build.SMV_ROUTES, 0)
    for b, k, n, knz, main in cases:
        for xdtype, wdtype in types:
            x, idx, wt = _c3_case(b, k, n, knz, xdtype, wdtype, gen, dev)
            got = smv_kernel.sparse_matvec_kernel(x, idx, wt)
            want = smv_kernel.sparse_matvec_plain(x, idx, wt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
            if knz == 0 and not (got == 0).all():
                raise AssertionError("no kept rows gave nonzero outputs")
            n_checks += 1
            if main:
                err = max(err, (got - want).abs().max().item())
    x, idx, wt = _c3_case(4, 2048, 2048, 512, torch.bfloat16, torch.bfloat16, gen, dev)
    if not (smv_kernel.sparse_matvec_kernel(x, idx, torch.zeros_like(wt)) == 0).all():
        raise AssertionError("an all-zero weight gave nonzero outputs")
    routes = dict(smv_kernel.sparse_matvec_kernel.routes)
    if not all(v > 0 for v in routes.values()):
        raise AssertionError(f"a route of sparse_matvec never ran: {routes}")
    emit({"phase": "c3_kernel_vs_plain", "cases": len(cases), "checks": n_checks,
          "tolerance": TOL, "max_abs_err_main_shapes": err, "routes": routes})
    return err


def _fc_input(cfg, acts: list[torch.Tensor]) -> torch.Tensor:
    """What ``cnn.forward`` flattens into fc0: the last conv's post-ReLU
    output, pooled if its stage ends in a pool."""
    last = len(cfg.conv_channels) - 1
    x = acts[last]
    if last in cfg.pool_after:
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


def phase_c3_cnn(dev: torch.device) -> None:
    """C3 on STL10's fc0 at its published width: the compressed products
    against the dense one, in the exact regime (k ≥ the nonzero columns)."""
    cfg = cnn.STL10_CNN
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cnn.init_params(cfg, gen)
    sample = torch.rand((4, *cfg.input_hw), generator=gen, device=dev)
    logits, acts = cnn.forward(params, cfg, sample, return_activations=True)
    x, w = _fc_input(cfg, acts), params["fc"][0]["kernel"]
    dense = x @ w
    k = int((x != 0).any(dim=0).sum())
    smv_kernel.sparse_matvec_kernel.launches = 0
    y = smv_ops.topk_sparse_matmul(x, w, k)
    c = compress_fc(w.T, x[0])
    y0 = smv_ops.sparse_matvec(c.x_nz, c.idx, w)
    torch.cuda.synchronize()
    launches = smv_kernel.sparse_matvec_kernel.launches
    if launches != 2 or logits.shape != (4, cfg.n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"STL10 C3: {launches} launches, logits {tuple(logits.shape)}")
    torch.testing.assert_close(y, dense, rtol=TOL, atol=TOL)
    torch.testing.assert_close(y0, dense[0], rtol=TOL, atol=TOL)
    torch.testing.assert_close(compressed_fc_apply(c), dense[0], rtol=TOL, atol=TOL)
    emit({"phase": "c3_cnn", "model": cfg.name, "input": list(cfg.input_hw), "batch": 4,
          "fc0": list(w.shape), "params": cnn.param_count(params),
          "fc0_input_sparsity": sparsity_of(x), "k_batch_union_nonzero": k,
          "row0_nonzero": c.idx.numel(),
          "post_relu_sparsity": [round(sparsity_of(a), 6) for a in acts],
          "max_abs_err_topk_vs_dense": (y - dense).abs().max().item(),
          "max_abs_err_compress_fc_vs_dense": (y0 - dense[0]).abs().max().item(),
          "tolerance": TOL})


def _topk_k(w: torch.Tensor) -> int:
    return max(int(round(TOPK_FRAC * w.shape[0])), 1)


def phase_c3_path(eng, card: str):
    """The full-width tinyllama-1.1b C3 path: every projection through
    ``topk_sparse_matmul``, counted; then fp32 against ``sparse_ffn_matmul``.
    Returns the seeded fp32 params, the timed kernel's operands and its
    launch count."""
    cfg, dev = eng.cfg, eng.device
    raw = eng.arch.init_params(torch.Generator(device=dev).manual_seed(0), dev)  # phase 8's
    ws = _projection_weights(cfg, raw)
    w16 = [w.bfloat16() for w in ws]
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = {k: torch.randn((4, 1, k), generator=gen, device=dev, dtype=torch.bfloat16)
          for k in (cfg.d_model, cfg.d_ff)}

    smv_kernel.sparse_matvec_kernel.launches = 0
    ys = [smv_ops.topk_sparse_matmul(xs[w.shape[0]], w, _topk_k(w)) for w in w16]
    torch.cuda.synchronize()
    launches = smv_kernel.sparse_matvec_kernel.launches
    good = sum(y.shape == (4, 1, w.shape[1]) and y.dtype == torch.bfloat16
               and bool(torch.isfinite(y).all()) for y, w in zip(ys, w16))
    if launches != len(ws) or good != len(ws):
        raise AssertionError(f"C3 path: {launches} launches and {good} good outputs, "
                             f"want {len(ws)}")
    err = 0.0
    for w in ws:
        x = xs[w.shape[0]].float()
        got, ref = smv_ops.topk_sparse_matmul(x, w, _topk_k(w)), sparse_ffn_matmul(x, w, _topk_k(w))
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
        err = max(err, (got - ref).abs().max().item())
    operands = []  # (x_nz, idx, Wt) as topk_sparse_matmul hands them to the kernel
    for w in w16:
        x2 = xs[w.shape[0]].reshape(4, -1)
        idx = top_k(column_scores(x2), _topk_k(w)).sort().values
        operands.append((x2.index_select(1, idx).contiguous(), idx.int(), w))
    emit({"phase": "c3_path", "card": card, "projections": len(ws), "topk_frac": TOPK_FRAC,
          "launches": launches, "gathered_weights": sum(x.shape[1] * w.shape[1]
                                                        for x, _, w in operands),
          "max_abs_err_vs_sparse_ffn_matmul_fp32": err, "tolerance": TOL})
    return raw, operands, launches


def phase_c3_timing(operands: list, launches: int, err: float) -> dict:
    """One step's worth (155 projections) of sparse_matvec: kernel, plain
    version, the library call x_nz @ Wt.index_select(0, idx) (gather and
    product both in the graph) and the bound (bytes: gathered rows + x_nz +
    idx + y (fp32); operations: 2·B·knz·N at the bf16 tensor-core peak)."""
    n_bytes = n_ops = bound_s = 0.0
    for x, idx, w in operands:
        b, knz = x.shape
        n = w.shape[1]
        byt = knz * n * w.element_size() + x.numel() * x.element_size() + 4 * knz + 4 * b * n
        ops = 2.0 * b * knz * n
        n_bytes, n_ops = n_bytes + byt, n_ops + ops
        bound_s += max(byt / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS)
    fn = smv_kernel.sparse_matvec_kernel

    def kernel(sub):
        return lambda: [fn(*o) for o in sub]

    def library(sub):
        return lambda: [x @ w.index_select(0, idx) for x, idx, w in sub]

    fn.routes = dict.fromkeys(build.SMV_ROUTES, 0)
    entry = {
        **C3_KERNEL, "route": "cuda", "launches": launches, "max_abs_err": err,
        "rows": operands[0][0].shape[0],
        "ms": _step_ms(kernel(operands)),
        "plain_ms": _step_ms(lambda: [smv_kernel.sparse_matvec_plain(*o) for o in operands]),
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / BF16_TENSOR_FLOPS
        else "operations",
        "library_ms": _step_ms(library(operands)),
    }
    entry["routes"] = dict(fn.routes)  # of the timed launches
    shapes = {}
    for o in operands:
        shapes.setdefault(f"{o[2].shape[0]}x{o[2].shape[1]}", []).append(o)
    by_shape = {shape: {"kernel": _step_ms(kernel(sub)) * 1e3 / len(sub),
                        "library": _step_ms(library(sub)) * 1e3 / len(sub),
                        "plan": build.sparse_matvec_plan(x.shape[1], w.shape[1], build.sm_count(0))}
                for shape, sub in shapes.items() for x, _, w in sub[:1]}
    device = {e.key[:80]: {"launches_per_projection": e.count / len(operands),
                           "us_per_launch": e.self_device_time_total / e.count}
              for e in _device_kernels(kernel(operands))}
    emit({"phase": "kernel_time", "launches_per_step": len(operands),
          "bytes": n_bytes, "kernel_ms": entry["ms"],
          **{k: v for k, v in entry.items() if k != "ms"},
          "us_per_launch_by_shape": by_shape, "device_kernels_one_pass": device})
    return entry


def _report(r) -> dict:
    return {"fps": r.fps, "power_w": r.power_w, "fps_per_w": r.fps_per_w, "epb_j_per_bit": r.epb}


PHOTONIC = "analytical photonic model (repro_torch.photonic), not a card measurement"
ABLATION = {
    "full SONIC (5,50,50,10)": SonicHWConfig(),
    "no clustering (16b DACs)": SonicHWConfig(weight_bits=16),
    "no sparsity gating": SonicHWConfig(sparsity_gating=False),
    "no compression": SonicHWConfig(compression=False),
    "none (dense photonic)": SonicHWConfig(weight_bits=16, sparsity_gating=False,
                                           compression=False),
}
PAPER_FPS_PER_W = {"CrossLight": 2.94, "HolyLight": 13.8, "LightBulb": 3.08,
                   "NullHop": 5.81, "RSNN": 4.02}


def phase_pipeline(eng, raw: dict, card: str) -> None:
    """The two examples' pipeline through the port at full width: C1, C2,
    dense and clustered generation, then the photonic model's pricing."""
    arch, cfg, dev = eng.arch, eng.cfg, eng.device
    t0 = time.perf_counter()
    masks = build_masks(raw, SparsityConfig(target_sparsity=0.5, block=(8, 8)))
    sparse = apply_masks(raw, masks)
    del masks
    torch.cuda.synchronize()
    t_c1 = time.perf_counter() - t0
    wi_sparsity = sparsity_of(sparse["layers"]["ffn"]["wi"]["kernel"])
    c2 = ClusteringConfig(num_clusters=64)
    t0 = time.perf_counter()
    clustered, packed = cluster_params(sparse, c2)
    torch.cuda.synchronize()
    t_c2 = time.perf_counter() - t0
    del sparse
    name, cw = next(iter(packed.items()))
    bits_ratio = cw.indices.numel() * 16 / storage_bits(tuple(cw.indices.shape), c2)
    n_new = 12
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    sc = ServeConfig(max_len=64 + n_new)
    outs = {kind: ServeEngine(arch, p, sc, device=dev).generate(prompts, n_new)
            for kind, p in (("dense", raw), ("clustered", clustered))}
    for out in outs.values():
        if out.shape != (4, n_new) or not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"bad tokens {tuple(out.shape)}")
    if not 0.45 < wi_sparsity < 0.55:
        raise AssertionError(f"C1 sparsity on ffn/wi {wi_sparsity}, want ≈ 0.5")
    emit({"phase": "pipeline_c1_c2", "card": card, "model": cfg.arch_id,
          "params": tree_param_count(raw), "c1_block": [8, 8], "c1_seconds": t_c1,
          "c1_sparsity_ffn_wi": wi_sparsity, "c2_clusters": 64, "c2_seconds": t_c2,
          "c2_leaves": len(packed), "c2_first_leaf": name, "c2_weight_bits_ratio": bits_ratio,
          "batch": 4, "prompt_len": 64, "new_tokens": n_new,
          "dense_tokens_row0": outs["dense"][0].tolist(),
          "clustered_tokens_row0": outs["clustered"][0].tolist(),
          "token_agreement": (outs["dense"] == outs["clustered"]).float().mean().item()})
    del clustered, packed

    reports = evaluate_all(lm_workload(cfg, weight_sparsity=0.5, act_sparsity=0.5))
    emit({"phase": "photonic_lm", "source": PHOTONIC, "model": cfg.arch_id,
          "weight_sparsity": 0.5, "act_sparsity": 0.5,
          "reports": {n: _report(r) for n, r in reports.items()}})
    for name, ccfg in cnn.PAPER_CNNS.items():
        params = cnn.init_params(ccfg, torch.Generator(device=dev).manual_seed(0))
        ws = {f"conv{i}": 0.5 for i in range(len(ccfg.conv_channels))} | {"fc0": 0.8}
        work = cnn_workload(ccfg, params, ws)
        reports = evaluate_all(work)
        s = reports["SONIC"]
        ratios = {n: s.fps_per_w / r.fps_per_w for n, r in reports.items() if n != "SONIC"}
        if not all(math.isfinite(v) and v > 0 for v in ratios.values()):
            raise AssertionError(f"{name}: bad FPS/W ratios {ratios}")
        if name == "cifar10":  # the band the repo's own test holds the model to
            for n, want in PAPER_FPS_PER_W.items():
                if not 0.4 * want <= ratios[n] <= 2.0 * want:
                    raise AssertionError(f"cifar10 vs {n}: FPS/W ratio {ratios[n]}")
        emit({"phase": "photonic_cnn", "source": PHOTONIC, "model": name,
              "params": cnn.param_count(params), "weight_sparsity": ws,
              "work": [{"name": w.name, "kind": w.kind, "vec_len": w.vec_len,
                        "n_products": w.n_products, "reuse": w.reuse,
                        "act_sparsity": w.act_sparsity} for w in work],
              "ablation": {v: _report(SonicAccelerator(hw).evaluate(work))
                           for v, hw in ABLATION.items()},
              "reports": {n: _report(r) for n, r in reports.items()},
              "sonic_fps_per_w_ratio": ratios})


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
    eng, eager, args, launches = phase_main_path(card)
    phase_profile({"scan": eng, "python": eager}, args, card)
    phase_reference(eng)
    kernels = phase_timing(eng, launches, errs)
    phase_fp32_decode_cost(eng, card)
    layer_errs = phase_layer_kernels(dev)
    phase_row_bits(dev)
    phase_serving_modes(eng, eager, card)
    phase_continuous(eng, card)
    spec_extras = phase_speculative(eng, card)
    phase_http(eng, card)
    converted, layer_launches = phase_layer_path(eng, card)
    kernels += phase_layer_timing(converted, layer_launches, layer_errs)
    for entry in kernels:
        entry.update(spec_extras.get(entry["name"], {}))
    del converted
    c3_err = phase_c3_kernel(dev)
    phase_c3_cnn(dev)
    raw, operands, c3_launches = phase_c3_path(eng, card)
    kernels.append(phase_c3_timing(operands, c3_launches, c3_err))
    del operands
    phase_pipeline(eng, raw, card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

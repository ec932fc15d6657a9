#!/usr/bin/env python3
"""Device times of the C3 kernel (``sparse_matvec``) on one CUDA card.

    python3 tools/sparse_matvec_times.py [--root DIR] [--label NAME] [--plans]

One step of tinyllama-1.1b's C3 path: its 155 projections (22 layers × q,
k, v, o, wi, wg, wo, and the LM head) at their full widths, random bf16
weights from a seeded generator on the card (each launch finds its rows
cold in L2), x (4, K) bf16, idx the k = K / 4 columns of largest |x|
summed over the rows, ascending, as ``topk_sparse_matmul`` hands them to
the kernel.  Prints one JSON line:

* ``step_ms``: the 155 launches replayed from a CUDA graph between CUDA
  events, for the kernel (``sparse_matvec_kernel``) and the library call
  ``x_nz @ Wt.index_select(0, idx)`` (gather and product in the graph);
* ``us_per_launch_by_shape``: the same for the launches of each (K, N);
* ``profiler``: one eager step under torch.profiler, the device µs per
  launch of each CUDA kernel by name and its launches per projection;
* ``bound_ms``: the gathered rows + x_nz + idx + y over 3.35 TB/s;
* the card's name and power limit (nvidia-smi).

``--root`` names the checkout whose ``src/repro_torch`` is timed (this one
by default), so that two trees can be timed in turns in one run.
``--plans`` adds one JSON line per shape: µs per launch at every (tile,
split) the kernel takes (``build.launch_sparse_matvec(..., plan=...)``),
at B = 1 and 4, beside ``build.sparse_matvec_plan``'s choice.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
D_MODEL, D_FF, VOCAB, LAYERS, KV = 2048, 5632, 32000, 22, 256
LAYER = ((D_MODEL, D_MODEL), (D_MODEL, KV), (D_MODEL, KV), (D_MODEL, D_MODEL),
         (D_MODEL, D_FF), (D_MODEL, D_FF), (D_FF, D_MODEL))


def _graph_ms(fn, reps: int = 10) -> float:
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


def operands(dev: torch.device) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(x_nz, idx, Wt) of the step's 155 launches."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for _ in range(LAYERS) for s in LAYER] + [(D_MODEL, VOCAB)]
    xs = {k: torch.randn((4, k), generator=gen, device=dev, dtype=torch.bfloat16)
          for k in (D_MODEL, D_FF)}
    out = []
    for k, n in shapes:
        w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).bfloat16()
        idx = xs[k].float().abs().sum(0).topk(k // 4).indices.sort().values
        out.append((xs[k].index_select(1, idx).contiguous(), idx.int(), w))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sparse_matvec_times: no CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels.sparse_matvec import kernel as smv

    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    ops = operands(dev)
    fn = smv.sparse_matvec_kernel

    def kernel(sub):
        return lambda: [fn(*o) for o in sub]

    def library(sub):
        return lambda: [x @ w.index_select(0, idx) for x, idx, w in sub]

    for x, idx, w in ops[:8]:  # build, and check before timing
        torch.testing.assert_close(fn(x, idx, w), smv.sparse_matvec_plain(x, idx, w),
                                   rtol=1e-4, atol=1e-4)
    by_shape = defaultdict(list)
    for o in ops:
        by_shape[f"{o[2].shape[0]}x{o[2].shape[1]}"].append(o)
    n_bytes = sum(x.shape[1] * w.shape[1] * 2 + x.numel() * 2 + 4 * x.shape[1]
                  + 16 * w.shape[1] for x, _, w in ops)
    routes = getattr(fn, "routes", None)
    if routes is not None:
        fn.routes = dict.fromkeys(routes, 0)
    out = {"tool": "sparse_matvec_times", "label": args.label, "root": args.root,
           "card": card, "launches_per_step": len(ops), "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
           "step_ms": {"kernel": _graph_ms(kernel(ops)), "library": _graph_ms(library(ops))},
           "us_per_launch_by_shape": {
               shape: {"kernel": _graph_ms(kernel(sub)) * 1e3 / len(sub),
                       "library": _graph_ms(library(sub)) * 1e3 / len(sub)}
               for shape, sub in by_shape.items()}}
    if routes is not None:
        out["routes_while_timed"] = dict(fn.routes)
    kernel(ops)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel(ops)()
        torch.cuda.synchronize()
    out["profiler"] = {e.key[:90]: {"device_us_per_launch": e.self_device_time_total / e.count,
                                    "launches_per_projection": e.count / len(ops)}
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    print(json.dumps(out), flush=True)
    if args.plans:
        from repro_torch.kernels import build

        for shape, sub in by_shape.items():
            knz, n = sub[0][0].shape[1], sub[0][2].shape[1]
            us = {}
            for b in (1, 4):
                rows = [(x[:b].contiguous(), idx, w) for x, idx, w in sub]
                for tile in build.SMV_TILES:
                    for split in (1, 2, 4, 8):
                        if split <= -(-knz // build.SMV_CHUNK):
                            us[f"b{b}_tile{tile}_split{split}"] = _graph_ms(
                                lambda: [build.launch_sparse_matvec(*o, plan=(tile, split))
                                         for o in rows]) * 1e3 / len(sub)
            print(json.dumps({"shape": shape, "plan": build.sparse_matvec_plan(
                knz, n, build.sm_count(0)), "us_per_launch": us}), flush=True)


if __name__ == "__main__":
    with torch.inference_mode():
        main()

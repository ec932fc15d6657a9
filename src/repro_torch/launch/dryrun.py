"""Multi-pod dry run: every (architecture × input shape × mesh) cell traced
on the production meshes without a device.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each step for 256 or 512 forced host devices and reads XLA's
memory and cost analyses, the port runs the step once under PyTorch's fake
process group of the production size (rank 0 of 256 or 512) and
``FakeTensorMode``: every tensor is a shape without data, each rank's
DTensor shards carry the local shapes, and the collectives DTensor issues
complete at once.  ``roofline.analysis`` counts what the device does: its
collectives (kind, wire bytes), its FLOPs and its peak of live bytes
(``MemTracker``).  Then the analytic cost model prices the cell, and the
roofline terms take ``roofline/hw.py``'s ``H100`` datasheet target: these
are estimates of an H100 cluster the program has never run on.

One JSON record per cell is appended to ``--out`` (default
``results/dryrun_torch.jsonl``), with the reference's keys, ``trace_s`` (the
seconds the trace took) in place of ``lower_s`` / ``compile_s``, and
``fits``: peak bytes per device ≤ the H100's 80 GB.  The attention and WKV
operators' transient blocks are not in the peak (``layers.flash_attention_op``).
Cells the arch does not support are skipped with the reference's reasons;
any error makes the exit code 1.

``--device`` is the device type of the mesh and of the fake tensors
(default ``cpu``: nothing runs on any device; ``cuda`` puts the fake tensors
on the card's type, so the serving paths take the card's row floors).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import ALL_ARCH_IDS, SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step_bundle
from repro_torch.models.registry import get_arch
from repro_torch.roofline.analysis import (DeviceCounter, collect_stats, device_mem_tracker,
                                           local_bytes, roofline_terms)
from repro_torch.roofline.analytic import analytic_cost
from repro_torch.roofline.hw import H100
from repro_torch.sharding.mesh import make_plan
from repro_torch.utils.logging import get_logger

log = get_logger("dryrun")


def init_fake_group(world_size: int) -> None:
    """PyTorch's fake process group of ``world_size`` ranks, this process
    rank 0 (collectives complete at once and move nothing), replacing any
    group this process has."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


@contextlib.contextmanager
def _own_propagation_mode():
    """DTensor's sharding propagation runs each new op once on fake tensors
    of the global shapes, in the active ``FakeTensorMode`` if there is one.
    Its tensors are no device's; give it a mode of its own, so that
    ``MemTracker`` and ``DeviceCounter`` (which count only the trace's own
    mode) leave them out."""
    from torch.distributed.tensor import _sharding_prop

    saved = _sharding_prop.detect_fake_mode
    _sharding_prop.detect_fake_mode = lambda *args, **kwargs: None
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = saved


def trace_cell(bundle) -> tuple:
    """Run ``bundle``'s step once on fake inputs → (CompiledStats, seconds).
    The caller holds the fake group and ``FakeTensorMode``."""
    args = bundle.make_args()
    arg_bytes = local_bytes(args)
    counter = DeviceCounter()
    mt = device_mem_tracker()
    t0 = time.time()
    with _own_propagation_mode(), mt:
        mt.track_external(*_leaves(args))
        with counter:
            out = bundle.fn(*args)
        peak = max(stats.get("Total", 0) for stats in
                   mt.get_tracker_snapshot("peak").values())
    return collect_stats(counter, arg_bytes, local_bytes(out), peak), time.time() - t0


def _leaves(tree) -> list[torch.Tensor]:
    from repro_torch.utils.tree import named_leaves

    return [leaf for _, leaf in named_leaves(tree) if isinstance(leaf, torch.Tensor)]


def run_cell(
    arch_id: str,
    shape_name: str,
    multi_pod: bool,
    plan_overrides: dict | None = None,
    verbose: bool = True,
    device_type: str = "cpu",
    arch=None,
    debug_mesh: tuple[int, int] | None = None,
) -> dict:
    """One cell's record.  ``arch`` (e.g. a reduced one) replaces
    ``get_arch(arch_id)`` and ``debug_mesh`` = (n_data, n_model) the
    production mesh, for tests."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_debug_mesh

    shape = SHAPES[shape_name]
    arch = arch or get_arch(arch_id)
    mesh_name = "multi(2,16,16)" if multi_pod else "single(16,16)"
    if debug_mesh is not None:
        mesh_name = "debug(%d,%d)" % debug_mesh
    rec: dict = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
    }
    ok, reason = arch.supports(shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    try:
        n_chips = math.prod(debug_mesh) if debug_mesh else (512 if multi_pod else 256)
        init_fake_group(n_chips)
        mesh = (make_debug_mesh(*debug_mesh, device_type=device_type) if debug_mesh else
                make_production_mesh(multi_pod=multi_pod, device_type=device_type))
        plan = make_plan(arch.cfg, mesh, shape.global_batch, **(plan_overrides or {}))
        bundle = build_step_bundle(arch, shape, plan)
        with (torch.inference_mode(False), FakeTensorMode(allow_non_fake_inputs=True),
              torch.device(device_type)):
            stats, trace_s = trace_cell(bundle)
        if verbose:
            print(f"[{arch_id} × {shape_name} × {mesh_name}] {bundle.name}")
            print("  peak bytes/dev: %.3e  flops/dev: %.3e" % (
                stats.peak_bytes_est, stats.hlo_flops_per_dev))
        cache_bpe = 1.03 if plan.cache_quant_int8 else 2.0
        cost = analytic_cost(arch.cfg, shape, cache_bytes_per_elem=cache_bpe)
        terms = roofline_terms(
            model_flops=cost.model_flops,
            exec_flops=cost.hlo_flops_est,
            hbm_bytes=cost.hbm_bytes,
            collective_bytes_per_dev=stats.collective_bytes_per_dev,
            n_chips=n_chips,
            hw=H100,
        )
        rec.update(
            status="ok",
            step_fn=bundle.name,
            n_chips=n_chips,
            trace_s=round(trace_s, 2),
            fits=stats.peak_bytes_est <= H100.hbm_bytes,
            memory={
                "argument_bytes_per_dev": stats.argument_bytes,
                "output_bytes_per_dev": stats.output_bytes,
                "temp_bytes_per_dev": stats.temp_bytes,
                "alias_bytes_per_dev": stats.alias_bytes,
                "peak_bytes_per_dev_est": stats.peak_bytes_est,
            },
            hlo_cost={
                "flops_per_dev_raw": stats.hlo_flops_per_dev,
                "bytes_per_dev_raw": stats.hlo_bytes_per_dev,
            },
            collectives={
                "counts": stats.collective_counts,
                "wire_bytes_per_dev": stats.collective_bytes_per_dev,
                "by_kind": stats.collective_bytes_by_kind,
            },
            analytic={
                "model_flops": cost.model_flops,
                "exec_flops_est": cost.hlo_flops_est,
                "hbm_bytes": cost.hbm_bytes,
                "n_active_params": cost.n_active,
                "n_total_params": cost.n_total,
            },
            roofline=terms.as_dict(),
        )
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        log.error("FAILED %s × %s × %s: %s", arch_id, shape_name, mesh_name, e)
    return rec


def _cell(cell, overrides, device_type) -> dict:
    rec = run_cell(*cell, overrides, verbose=False, device_type=device_type)
    if dist.is_initialized():
        dist.destroy_process_group()
    return rec


def _records(cells, overrides, device_type: str, jobs: int):
    """Each cell's record, in order; ``jobs`` > 1 traces that many cells at
    once in spawned processes (each with its own fake group)."""
    if jobs <= 1:
        for cell in cells:
            yield run_cell(*cell, overrides, verbose=False, device_type=device_type)
        return
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_cell, cell, overrides, device_type) for cell in cells]
        for fut in futures:
            yield fut.result()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ALL_ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every live cell")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--seq-shard-cache", action="store_true",
                    help="flash-decode KV-seq sharding")
    ap.add_argument("--cache-int8", action="store_true",
                    help="int8 KV cache — SONIC C2 on the cache")
    ap.add_argument("--serve-stationary", action="store_true",
                    help="TP-only (no-FSDP) serving weights")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="device type of the mesh and of the fake tensors")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    archs = ALL_ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = {}
    if args.seq_shard_cache:
        overrides["seq_shard_cache"] = True
    if args.cache_int8:
        overrides["cache_quant_int8"] = True
    if args.serve_stationary:
        overrides["serve_stationary"] = True
    overrides = overrides or None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cells = [(aid, sname, mp) for aid in archs for sname in shapes for mp in meshes]
    n_ok = n_skip = n_err = 0
    t0 = time.time()
    with open(args.out, "a") as f:
        for rec in _records(cells, overrides, args.device, args.jobs):
            f.write(json.dumps(rec) + "\n")
            f.flush()
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            n_err += rec["status"] == "error"
            tag = {"ok": "OK ", "skipped": "SKIP", "error": "ERR "}[rec["status"]]
            dom = rec.get("roofline", {}).get("dominant", "-")
            log.info("%s %s × %s × %s (dominant=%s, trace %ss, fits=%s)", tag, rec["arch"],
                     rec["shape"], rec["mesh"], dom, rec.get("trace_s", "-"),
                     rec.get("fits", "-"))
    log.info("dry-run complete: %d ok, %d skipped, %d errors in %.1f s", n_ok, n_skip, n_err,
             time.time() - t0)
    if dist.is_initialized():
        dist.destroy_process_group()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

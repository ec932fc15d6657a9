"""The port's dry run (``launch/dryrun.py``) on the CPU, under PyTorch's fake
process group: a mini cell at reduced size on the debug mesh, and the skip
matrix of every production cell against the JAX package's.

Exact: the cell ends ``ok``; its per-device argument bytes equal the sum of
the local shard bytes that the reference's partition specs imply for the
state's leaves (params, moments, masks) and the batch (the step a 4-byte
scalar); all-gathers are counted; the record has the reference's keys with
``trace_s`` for ``lower_s`` / ``compile_s`` and ``fits``; every skipped
cell carries the reference's reason.

Fault 13 (``ROADMAP.md`` Queue 3, repaired): grok-1-314b's train step at
full width, cut to 1 layer, on (2, 16, 16) needs at most the peak per
device it needs on (16, 16).  It needed 234.60 GB against 73.71 at full
depth, from two causes, each repaired: the backward of the L2 term laid
a copy of each stacked expert ``wo`` out over "pod" only
(``core.sparsity._SumOfSquares``), and the expert products met the
weights' d_model split over ("pod", "data"), so their gradients were
regathered to be laid out again (``models.moe._gathered_over_dp``).  The
cell is cut to a batch of 32 × 512 tokens with no mask refresh, so that
the weights' transients, not the activations or the refresh's gathered
slices, set the peak: 1.90 against 1.99 GB; with the L2 repair taken
out, 4.16 against 1.99; with the expert gather taken out, 4.03 against
2.35.  Either repair alone fails the test.
"""
from __future__ import annotations

import json
import math

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

import dataclasses

from repro.configs.base import ALL_ARCH_IDS, SHAPES
from repro.models.registry import get_arch as jax_get_arch
from repro.sharding.mesh import make_plan as jax_make_plan
from repro.sharding.partition import spec_for_leaf as jax_spec_for_leaf
from repro_torch.launch import dryrun
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.steps import build_step_bundle, default_train_config
from repro_torch.models.registry import Arch, get_arch
from repro_torch.utils.tree import named_leaves

DEBUG = (2, 4)


@pytest.fixture
def fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_bytes(shape, spec, dtype, sizes) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * torch.empty((), dtype=dtype).element_size()


def test_mini_dry_run_on_the_debug_mesh(fake_group):
    arch = get_arch("tinyllama-1.1b", reduced=True)
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", False, verbose=False, arch=arch,
                          debug_mesh=DEBUG)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == 8 and rec["mesh"] == "debug(2,4)"
    sizes = {"data": DEBUG[0], "model": DEBUG[1]}
    jplan = jax_make_plan(jax_get_arch("tinyllama-1.1b", reduced=True).cfg,
                          JaxAbstractMesh(DEBUG, ("data", "model")), 256)
    tc = default_train_config(arch.cfg)
    moment = getattr(torch, tc.opt.moment_dtype)
    want = 0
    for name, leaf in named_leaves(arch.abstract_params()):
        spec = jax_spec_for_leaf(name, tuple(leaf.shape), jplan)
        for dtype in (leaf.dtype, moment, moment, leaf.dtype):  # param, m, v, mask
            want += _local_bytes(tuple(leaf.shape), spec, dtype, sizes)
    shape = SHAPES["train_4k"]
    want += 2 * _local_bytes((shape.global_batch, shape.seq_len), ("data", None), torch.int32,
                             sizes)  # tokens, labels
    want += 4  # the step
    assert rec["memory"]["argument_bytes_per_dev"] == want
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["memory"]["peak_bytes_per_dev_est"] >= want
    assert rec["hlo_cost"]["flops_per_dev_raw"] > 0
    assert set(rec) == {"arch", "shape", "mesh", "kind", "status", "step_fn", "n_chips",
                        "trace_s", "fits", "memory", "hlo_cost", "collectives", "analytic",
                        "roofline"}
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("arch_id", ALL_ARCH_IDS)
def test_skip_matrix_equals_the_reference(arch_id, fake_group):
    for name, shape in SHAPES.items():
        ok, reason = jax_get_arch(arch_id).supports(shape)
        assert get_arch(arch_id).supports(shape) == (ok, reason)
        if not ok:
            for multi in (False, True):
                rec = dryrun.run_cell(arch_id, name, multi, verbose=False)
                assert (rec["status"], rec["reason"]) == ("skipped", reason)


def test_cli_writes_one_record_per_cell(tmp_path, fake_group):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--mesh", "both",
                 "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["single(16,16)", "multi(2,16,16)"]
    assert all(r["status"] == "skipped" for r in recs)


def _grok_peak(multi: bool) -> float:
    """Peak bytes per device of the cut grok-1-314b train step (see the
    module doc) on the production mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.mesh import make_plan

    full = get_arch("grok-1-314b")
    arch = Arch(full.arch_id, full.cfg.replace(n_layers=1))
    shape = ShapeSpec("train_4k", 512, 32, "train")
    dryrun.init_fake_group(512 if multi else 256)
    plan = make_plan(arch.cfg, make_production_mesh(multi_pod=multi, device_type="cpu"),
                     shape.global_batch)
    tc = dataclasses.replace(default_train_config(arch.cfg), sparsity=None)
    bundle = build_step_bundle(arch, shape, plan, train_cfg=tc)
    with torch.inference_mode(False), FakeTensorMode(allow_non_fake_inputs=True), \
            torch.device("cpu"):
        stats, _ = dryrun.trace_cell(bundle)
    return stats.peak_bytes_est


def test_grok_peak_on_the_3d_mesh_is_at_most_the_2d_one(fake_group):
    single = _grok_peak(False)
    multi = _grok_peak(True)
    assert multi <= single, (multi / 1e9, single / 1e9)
